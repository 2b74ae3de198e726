"""The walk's waits on the card (span ``walk.sync``: every read of a
device value by the host inside the walk, the node counts' readback
included) as a share of the seconds of the window's calls."""

from kmbench.program_spans import catalog_span_pct


def read(obs):
    return catalog_span_pct(obs, ("walk.sync",))
