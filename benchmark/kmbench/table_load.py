"""Shares of a command-line call's phases in the catalog from the
command line (``catalog.cold_cli``): the table's load (``table.read``,
``table.sort``, ``table.upload``) and the catalog against it
(``batch_pipeline``), over the seconds of the window's calls. A program
that does not time the load (no ``table.read``) gives None for every
share, so the four are read together or not at all; one that times it
gives 0 for a span that did not run, such as ``table.sort`` for a table
sorted elsewhere."""

from kmbench.phases import phase_pct


def load_pct(obs, names) -> float | None:
    if "table.read" not in (obs.get("phases") or {}):
        return None
    return phase_pct(obs, names)
