"""Scale scripts of the port, each runnable as a module:

    python -m km_tpu_torch.scripts.scale_count [--chunks N] [--capacity LOG2]
    python -m km_tpu_torch.scripts.bigtable_walk [--extra M] [--targets N]

They are the port's forms of km_tpu's ``scripts/scale_count.py`` and
``scripts/bigtable_walk.py`` and print the same JSON keys. Each has a
function that does the work at any size.
"""
