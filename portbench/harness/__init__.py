"""The harness: set-up, window, trace, metrics and the comparison with the reference."""
