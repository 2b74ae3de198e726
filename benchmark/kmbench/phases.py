"""Shares of the program's phases (utils.profiling) in a window."""


def phase_pct(obs, names) -> float | None:
    phases = obs.get("phases")
    calls = obs["calls"]
    if obs["kind"] != "catalog" or phases is None or not calls:
        return None
    busy = sum(e - s for s, e, _ in calls) / 1e9
    return 100 * sum(phases.get(n, 0.0) for n in names) / busy
