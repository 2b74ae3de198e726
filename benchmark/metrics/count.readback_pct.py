"""The count's readback (span ``count.readback``: the accumulator's
live keys and counts copied to the host after the last overflow check)
as a share of the seconds of the traced counts."""

from kmbench.program_spans import count_span_pct


def read(obs):
    return count_span_pct(obs, ("count.readback",))
