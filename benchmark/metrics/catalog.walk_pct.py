"""The program's ``walk`` phase (ops.batch_walk, the node counts read
back included) as a share of the seconds of the window's calls. Wall
time: it includes the host's waits on the card."""

from kmbench.phases import phase_pct


def read(obs):
    return phase_pct(obs, ("walk",))
