"""Span ``table.read``: the ``.jf`` file read and its records decoded
(io/jf.py::read_jf), as a share of the seconds of the window's calls
(kmbench/table_load.py)."""

from kmbench.table_load import load_pct


def read(obs):
    return load_pct(obs, ("table.read",))
