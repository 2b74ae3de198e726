"""The chunked count cell (``count.chunked``) at a size the CPU runs: a
small run is ``correct`` and its traced run reports the three metrics of
the capped path, and ``correct`` catches the faults a capped count can
have: the ``min_count`` cut made on each piece instead of on the merged
counts, and a dumped piece lost. The count's chunk and the ceiling are
cut so that the small sample dumps."""

import contextlib

import pytest

import small

CELL = "count.chunked"
CHUNK = 1 << 12


class ChunkedSpec(small.SmallSpec):
    """The cell at the CPU's size: 2^18 bases from a 2^14-base
    transcriptome (~2.4e4 keys) under a ceiling of 2^13 slots."""

    def config(self, name):
        c = super().config(name)
        if name == "leucegene_count_chunked":
            c.update(read_bases=1 << 18, chunk=CHUNK, size=1 << 13)
        return c

    def traffic(self, name):
        t = super().traffic(name)
        if name == "chunked":
            t.update(reads=small.READS)
        return t


@contextlib.contextmanager
def patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def run(traced=False):
    from km_tpu_torch.tools import count as tools_count

    with patched(tools_count, "CHUNK", {"cpu": CHUNK}):
        return small.run_small(CELL, traced=traced, spec=ChunkedSpec())


def test_a_small_run_is_correct_and_reports_the_capped_path():
    line, obs = run(traced=True)
    assert line["correct"], line["compared"]
    stats = obs["count_stats"]
    assert stats and all(s["dumps"] >= 1 for s in stats)
    metrics = line["metrics"]
    assert metrics["count.dumps"]["value"] >= 1
    for name in ("count.dump_pct", "count.host_merge_pct"):
        assert 0 < metrics[name]["value"] < 100, name


def test_a_cut_of_each_piece_is_caught():
    """``min_count`` applied to each dump and to the last accumulator, as
    if every piece were a table: keys split between pieces are lost."""
    from km_tpu_torch.ops import count as ops_count

    real = ops_count.cut

    def per_piece(keys, counts, n, min_count, out_keys, out_cnt):
        return real(keys, counts, n, max(min_count, 2), out_keys, out_cnt)

    with patched(ops_count, "cut", per_piece):
        line, obs = run()
    assert all(s["dumps"] >= 1 for s in obs["count_stats"])
    assert not line["correct"]
    assert line["compared"]["table_mismatches"]["value"] > 0


@pytest.mark.parametrize("keep_total", [True, False])
def test_a_dropped_dump_is_caught(keep_total):
    """A dump's piece lost, its count total kept or lost with it."""
    from km_tpu_torch.ops import count as ops_count

    real = ops_count._read_piece

    def dropped(acc, out):
        keys, counts, total = real(acc, out)
        return keys[:0], counts[:0], total if keep_total else 0

    with patched(ops_count, "_read_piece", dropped):
        line, obs = run()
    assert all(s["dumps"] >= 1 for s in obs["count_stats"])
    assert not line["correct"]
    assert line["compared"]["table_mismatches"]["value"] > 0
    assert (line["compared"]["windows_gap"]["value"] > 0) != keep_total
