"""M1's runs (each chunk's distinct keys, ``stats["runs"]``, summed over
the chunks of the attempt that succeeded) over the valid windows
counted (``stats["total"]``), in percent, over the window's counts: the
in-chunk duplication that the key distribution hands M1 and M2, near
100 where keys are uniform at low coverage and lower under skew. None
where a count does not report its runs."""


def read(obs):
    stats = obs.get("count_stats") or []
    if not stats or any("runs" not in s for s in stats):
        return None
    total = sum(s["total"] for s in stats)
    return 100 * sum(s["runs"] for s in stats) / total if total else None
