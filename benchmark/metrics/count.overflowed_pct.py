"""The attempts of the count thrown away by a capacity retry (the whole
time of every attempt that overflowed, ``count.overflowed``) as a share
of the seconds of the traced counts."""

from kmbench.program_spans import count_span_pct


def read(obs):
    return count_span_pct(obs, ("count.overflowed",))
