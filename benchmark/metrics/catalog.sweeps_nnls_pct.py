"""The program's ``sweeps`` (ops.pathgraph) and ``nnls`` (ops.nnls)
phases as a share of the seconds of the window's calls. Wall time, waits
on the card included."""

from kmbench.phases import phase_pct


def read(obs):
    return phase_pct(obs, ("sweeps", "nnls"))
