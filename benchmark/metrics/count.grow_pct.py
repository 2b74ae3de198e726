"""The growths of the stream count's accumulator (``count.grow``: the
copy into the larger pair, the frees and the chunk counted again) as a
share of the seconds of the traced counts; 0 where none grew. None
where a count does not report its growths (a program that re-read its
input instead) or records no span."""

from kmbench.program_spans import count_span_pct


def read(obs):
    if any("grows" not in s for s in obs.get("count_stats") or []):
        return None
    return count_span_pct(obs, ("count.grow",))
