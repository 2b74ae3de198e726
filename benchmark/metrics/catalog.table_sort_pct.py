"""Span ``table.sort``: the host's argsort and two gathers that put the
records in key order (models/table.py::CountTable.from_arrays), as a
share of the seconds of the window's calls (kmbench/table_load.py)."""

from kmbench.table_load import load_pct


def read(obs):
    return load_pct(obs, ("table.sort",))
