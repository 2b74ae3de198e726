"""The waits on the card inside the sweeps and NNLS (spans
``sweeps.sync`` and ``nnls.sync``: the trees read back, the
convergence tests and the coefficients read back) as a share of the
seconds of the window's calls."""

from kmbench.program_spans import catalog_span_pct


def read(obs):
    return catalog_span_pct(obs, ("sweeps.sync", "nnls.sync"))
