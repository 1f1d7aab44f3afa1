"""See the matching module of attentiondm_tpu for the reference."""
