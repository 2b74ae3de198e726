"""Capacity retries of the FASTQ count (``stats['retries']``), the mean
over the counts of the window."""


def read(obs):
    stats = obs.get("count_stats") or []
    if not stats or any("retries" not in s for s in stats):
        return None
    return sum(s["retries"] for s in stats) / len(stats)
