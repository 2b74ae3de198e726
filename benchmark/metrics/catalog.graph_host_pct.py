"""The program's host graph (``graph_host``: graphs built, paths
spliced) and row output (``rows``) phases, as a share of the seconds of
the window's calls (utils.profiling)."""

from kmbench.phases import phase_pct


def read(obs):
    return phase_pct(obs, ("graph_host", "rows"))
