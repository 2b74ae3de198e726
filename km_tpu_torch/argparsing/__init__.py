"""Argument schemas of the port's CLI: km_tpu's, plus ``--device``."""
