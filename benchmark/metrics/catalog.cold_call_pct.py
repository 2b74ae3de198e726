"""Phase ``batch_pipeline``: the catalog run once against the table the
call loaded (tools/batchmode.py::emit_batched), as a share of the
seconds of the window's calls; None, as the load's shares, where the
program does not time the load (kmbench/table_load.py)."""

from kmbench.table_load import load_pct


def read(obs):
    return load_pct(obs, ("batch_pipeline",))
