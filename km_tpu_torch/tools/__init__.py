"""Workload entry points of the port: count (on the card) and
find_mutation (``--batch`` over the torch table). find_report,
linear_kmin and min_cov are km_tpu's own."""
