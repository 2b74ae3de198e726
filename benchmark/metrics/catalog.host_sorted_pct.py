"""100 x the records the program sorted on the host in the window's
calls (``CountTable.host_sorted`` and ``DeviceCountTable.host_sorted``)
over the records it read from .jf files (``read_jf.records``): where the
table's sort ran. None where the program has no such counter or read no
record."""


def read(obs):
    c = obs.get("table_counters") or {}
    if c.get("records") is None or c.get("host_sorted") is None \
            or not c["records"]:
        return None
    return 100 * c["host_sorted"] / c["records"]
