"""Span ``table.upload``: the sorted check, the conversions and the two
copies to the card (ops/device_table.py::DeviceCountTable), as a share
of the seconds of the window's calls (kmbench/table_load.py)."""

from kmbench.table_load import load_pct


def read(obs):
    return load_pct(obs, ("table.upload",))
