"""Workload entry points of the port: count (on the card) and
find_mutation (``--batch`` over the torch table), cohort, and the host
tools find_report, linear_kmin and min_cov (copies of km_tpu's)."""
