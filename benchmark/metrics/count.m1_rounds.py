"""The bucket rounds M1 took beyond one a bucket (``stats["m1_rounds"]``:
a bucket larger than its 8,192-record tile is taken in rounds), summed
over the chunks of the attempt that succeeded, the mean over the
window's counts. None where a count does not report them."""


def read(obs):
    stats = obs.get("count_stats") or []
    if not stats or any("m1_rounds" not in s for s in stats):
        return None
    return sum(s["m1_rounds"] for s in stats) / len(stats)
