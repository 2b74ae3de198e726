"""Dumps of the chunked count's capped accumulator (``stats["dumps"]``:
the merges that overflowed the ceiling, each of which read the
accumulator back as a sorted piece and started an empty one), the mean
over the window's counts. None where a count does not report them (the
stream, or a program without the ceiling)."""


def read(obs):
    stats = obs.get("count_stats") or []
    if not stats or any("dumps" not in s for s in stats):
        return None
    return sum(s["dumps"] for s in stats) / len(stats)
