"""The yardstick of the per-layer metrics: the card's published peaks and
the operations and bytes of each kernel launch, computed from the
configuration's shapes."""
