"""The chunked count's host merge (span ``count.host_merge``: the dumped
pieces and the last accumulator k-way merged on the host, the
``min_count`` cut made on the merged counts) as a share of the seconds
of the traced counts; 0 where no count dumped, None where a count
records no span."""

from kmbench.program_spans import count_span_pct


def read(obs):
    return count_span_pct(obs, ("count.host_merge",))
