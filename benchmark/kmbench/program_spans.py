"""Shares of the program's own spans (km_tpu_torch.utils.profiling) in
a traced window, over the seconds of the window's calls: the count's,
summed from every count's ``stats["span_s"]`` (every attempt of a
count adds its spans there), and the catalog's, from the program's
phase table.

A program that records none of these spans gives None. One that
records them gives 0 for a span that did not run in the window, such
as ``gc`` where no full collection came or ``count.overflowed`` where
no count overflowed."""

from kmbench.phases import phase_pct

# the catalog's spans that every call of a program that has them opens
CATALOG_SPANS = ("walk.sync", "sweeps.sync", "nnls.sync", "graph.warm_up",
                 "graph.capture")


def count_span_pct(obs, names) -> float | None:
    stats = obs.get("count_stats") or []
    calls = obs.get("calls")
    if obs["kind"] != "count" or not stats or not calls \
            or any("span_s" not in s for s in stats):
        return None
    spent = sum(s["span_s"].get(n, 0.0) for s in stats for n in names)
    return 100 * spent / (sum(e - s for s, e, _ in calls) / 1e9)


def catalog_span_pct(obs, names) -> float | None:
    phases = obs.get("phases") or {}
    if not any(n in phases for n in CATALOG_SPANS):
        return None
    return phase_pct(obs, names)
