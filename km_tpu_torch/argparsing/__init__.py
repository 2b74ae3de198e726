"""Argument schemas of the port's CLI: a copy of km_tpu's, plus
``--device``."""
