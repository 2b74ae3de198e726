"""The card path's reads (span ``count.read``: one block of FASTQ text
read into pinned memory and the end of its last record found) as a share
of the seconds of the traced counts. None where no count records the
span: a program that parses on the host, or a count of held batches."""

from kmbench.program_spans import count_span_pct


def read(obs):
    stats = obs.get("count_stats") or []
    if not any("count.read" in s.get("span_s", {}) for s in stats):
        return None
    return count_span_pct(obs, ("count.read",))
