"""Growths of the stream count's accumulator (``stats["grows"]``: the
chunks whose merge overflowed it, after each of which it doubled on the
card until it held the keys), the mean over the window's counts. None
where a count does not report them (a program that re-read its input
instead)."""


def read(obs):
    stats = obs.get("count_stats") or []
    if not stats or any("grows" not in s for s in stats):
        return None
    return sum(s["grows"] for s in stats) / len(stats)
