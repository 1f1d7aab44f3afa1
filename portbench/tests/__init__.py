"""The benchmark's own tests (CPU; the ones marked `gpu` need the card)."""
