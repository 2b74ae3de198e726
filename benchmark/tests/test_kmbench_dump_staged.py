"""The reader of the staged dump readback, ``count.dump_staged_pct``
(the bytes the chunked count's dumps moved through the staging pair over
12 B a dumped record): 100 on the chunked cell's small CPU run, and None
on counts that do not report the staged bytes (a program that reads its
dumps back without the staging pair) or that dumped nothing."""

import pytest

from test_kmbench_arithmetic import calls, reader
from test_kmbench_chunked import run


def count_obs(stats):
    return {"kind": "count", "calls": calls([4.0] * len(stats)),
            "count_stats": [dict(s, total=9) for s in stats]}


def test_the_small_chunked_run_reads_100():
    line, obs = run(traced=True)
    assert line["correct"], line["compared"]
    assert all(s["dumps"] >= 1 for s in obs["count_stats"])
    assert line["metrics"]["count.dump_staged_pct"]["value"] == 100


@pytest.mark.parametrize("stats, want", [
    ([{"dumps": 2, "dumped": 10, "dump_staged_bytes": 120}] * 2, 100.0),
    ([{"dumps": 2, "dumped": 10, "dump_staged_bytes": 120},
      {"dumps": 2, "dumped": 10, "dump_staged_bytes": 0}], 50.0),
    ([{"dumps": 2, "dumped": 10}] * 2, None),
    ([{"dumps": 0, "dumped": 0, "dump_staged_bytes": 0}] * 2, None),
    ([], None),
])
def test_staged_share(stats, want):
    got = reader("count.dump_staged_pct")(count_obs(stats))
    assert got == (None if want is None else pytest.approx(want))
