"""The count's uploads (span ``count.upload``: a chunk's codes and
flags copied to the card, from pageable memory, so the copy waits for
the card's earlier work on the stream) as a share of the seconds of
the traced counts, every attempt included."""

from kmbench.program_spans import count_span_pct


def read(obs):
    return count_span_pct(obs, ("count.upload",))
