"""The count's cut on the host (span ``count.cut``: the counts
summed, the ``min_count`` mask, the keys made uint64 and the counts
uint32) as a share of the seconds of the traced counts."""

from kmbench.program_spans import count_span_pct


def read(obs):
    return count_span_pct(obs, ("count.cut",))
