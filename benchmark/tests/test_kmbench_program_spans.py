"""The readers of the program's own spans on synthetic observations: a
share where the spans are there, None where the program records none of
them (a program older than the spans), and 0 for a span that did not
run in a window of a program that records it."""

import pytest

from test_kmbench_arithmetic import calls, reader

COUNT = {"count.upload_pct": "count.upload",
         "count.readback_pct": "count.readback",
         "count.cut_pct": "count.cut",
         "count.overflowed_pct": "count.overflowed"}


def count_obs(span_s):
    stats = [{"retries": 2, "total": 9}, {"retries": 2, "total": 9}]
    if span_s is not None:
        for s in stats:
            s["span_s"] = dict(span_s)
    return {"kind": "count", "calls": calls([4.0, 4.0]),
            "count_stats": stats}


@pytest.mark.parametrize("metric", sorted(COUNT))
def test_count_span_shares(metric):
    # each count spends 1 s in the span: 2 s of 8 s of counts
    obs = count_obs({COUNT[metric]: 1.0, "count.input": 3.0})
    assert reader(metric)(obs) == pytest.approx(25.0)
    # spans recorded, this one never ran: 0
    assert reader(metric)(count_obs({"count.input": 3.0})) == 0
    # a program that records no span
    assert reader(metric)(count_obs(None)) is None
    other = count_obs({COUNT[metric]: 1.0})
    other["kind"] = "catalog"
    assert reader(metric)(other) is None
    obs["count_stats"][1].pop("span_s")
    assert reader(metric)(obs) is None


CATALOG = {"catalog.walk_sync_pct": ("walk.sync",),
           "catalog.sweeps_nnls_sync_pct": ("sweeps.sync", "nnls.sync"),
           "catalog.graph_build_pct": ("graph.warm_up", "graph.capture"),
           "catalog.gc_pct": ("gc",)}
PHASES = {"walk": 1.2, "graph_host": 0.3, "sweeps": 0.2, "nnls": 0.2,
          "rows": 0.1}


def catalog_obs(phases):
    return {"kind": "catalog", "calls": calls([1.0, 1.0]), "phases": phases}


@pytest.mark.parametrize("metric", sorted(CATALOG))
def test_catalog_span_shares(metric):
    names = CATALOG[metric]
    spans = {"walk.sync": 0.01, "sweeps.sync": 0.01, "nnls.sync": 0.01,
             "graph.warm_up": 0.01, "graph.capture": 0.01}
    spans.update((n, 0.2) for n in names)  # 0.2 s a name of 2 s
    got = reader(metric)(catalog_obs(PHASES | spans))
    assert got == pytest.approx(10.0 * len(names))
    # the parent's phases alone: nothing to read
    assert reader(metric)(catalog_obs(dict(PHASES))) is None
    assert reader(metric)({"kind": "count", "calls": calls([1.0])}) is None


def test_a_window_with_no_full_collection_reads_0():
    phases = PHASES | {"walk.sync": 0.3, "graph.warm_up": 0.2,
                       "graph.capture": 0.1, "sweeps.sync": 0.05,
                       "nnls.sync": 0.05}
    assert reader("catalog.gc_pct")(catalog_obs(phases)) == 0
    assert reader("catalog.graph_build_pct")(catalog_obs(phases)) == \
        pytest.approx(15.0)
