"""The CUDA graphs of the walk, the sweeps and NNLS built again in every
call (spans ``graph.warm_up``, the block run eagerly, and
``graph.capture``) as a share of the seconds of the window's calls."""

from kmbench.program_spans import catalog_span_pct


def read(obs):
    return catalog_span_pct(obs, ("graph.warm_up", "graph.capture"))
