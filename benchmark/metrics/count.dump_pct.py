"""The chunked count's dumps (span ``count.dump``: the wait, the
accumulator read back to the host as one sorted piece, the pair emptied
and the chunk counted again) as a share of the seconds of the traced
counts; 0 where no count dumped, None where a count records no span."""

from kmbench.program_spans import count_span_pct


def read(obs):
    return count_span_pct(obs, ("count.dump",))
