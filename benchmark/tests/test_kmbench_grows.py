"""The readers of the stream count's growths on synthetic observations:
``count.grows`` (the mean of ``stats["grows"]``) and ``count.grow_pct``
(the ``count.grow`` span's share of the counts' seconds). Each gives a
value where the counts report growths, 0 where none grew, and None
where the counter or the spans are missing (a program that re-read its
input on an overflow instead)."""

import pytest

from test_kmbench_arithmetic import calls, reader


def count_obs(grows, span_s=None):
    stats = [{"total": 9} if g is None else {"retries": 0, "grows": g,
                                              "total": 9}
             for g in grows]
    if span_s is not None:
        for s in stats:
            s["span_s"] = dict(span_s)
    return {"kind": "count", "calls": calls([4.0, 4.0]),
            "count_stats": stats}


@pytest.mark.parametrize("grows, want", [((2, 5), 3.5), ((0, 0), 0),
                                         ((2, None), None)])
def test_growths_of_the_accumulator(grows, want):
    assert reader("count.grows")(count_obs(grows)) == want
    assert reader("count.grows")({"kind": "count", "count_stats": []}) \
        is None


@pytest.mark.parametrize("spans, want", [
    # each count spends 1 s growing: 2 s of 8 s of counts
    ({"count.grow": 1.0, "count.input": 3.0}, 25.0),
    # spans recorded, no growth ran: 0
    ({"count.input": 3.0}, 0),
])
def test_grow_share(spans, want):
    assert reader("count.grow_pct")(count_obs((3, 3), spans)) == \
        pytest.approx(want)


def test_a_count_without_spans_or_growths_has_no_grow_share():
    assert reader("count.grow_pct")(count_obs((3, 3))) is None
    obs = count_obs((3, 3), {"count.grow": 1.0, "count.input": 3.0})
    obs["count_stats"][1].pop("span_s")
    assert reader("count.grow_pct")(obs) is None
    # a parent's count: spans, an overflowed attempt, no growths
    obs = count_obs((None, None), {"count.input": 3.0,
                                   "count.overflowed": 1.0})
    assert reader("count.grow_pct")(obs) is None
    assert reader("count.overflowed_pct")(obs) == pytest.approx(25.0)
    other = count_obs((3, 3), {"count.grow": 1.0})
    other["kind"] = "catalog"
    assert reader("count.grow_pct")(other) is None
