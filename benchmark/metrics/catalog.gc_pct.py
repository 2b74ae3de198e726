"""Full (generation 2) collections of the Python garbage collector
(span ``gc``) as a share of the seconds of the window's calls; 0 where
the program times them and none came."""

from kmbench.program_spans import catalog_span_pct


def read(obs):
    return catalog_span_pct(obs, ("gc",))
