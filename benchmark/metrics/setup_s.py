"""Seconds from the start of the run to the start of the window: start,
imports, the load (or first build) of the kernels, the inputs made from
the seed, the table built and uploaded, and the warm-up."""


def read(obs):
    return obs["setup_s"]
