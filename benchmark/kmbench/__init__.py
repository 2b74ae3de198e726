"""The harness of the km_tpu_torch benchmark (see ../README.md)."""
