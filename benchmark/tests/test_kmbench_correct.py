"""``correct`` catches what it is there to catch: the controls (the
reference one step down in the program's place) and the faults a cell
can have, each planted under a run at a small size on the CPU. A count
or catalog cell runs on one card, so it has no exchange between cards
to leave out."""

import contextlib

import numpy as np
import pytest

import small
import control
from kmbench.drivers import catalog, count


@contextlib.contextmanager
def patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


@pytest.mark.parametrize("cell", ["count.fastq", "count.resident",
                                  "catalog.panel9", "catalog.batch400"])
def test_the_control_fails(cell):
    spec = small.SmallSpec()
    w = spec.workload(cell)
    config, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    if traffic["driver"] == "count":
        got = control.count_control(config, traffic, small.SEED, "cpu")
        limits = count.LIMITS
    else:
        got = control.catalog_control(config, traffic, small.SEED, "cpu")
        limits = catalog.LIMITS
    assert any(v > limits[n] for n, v in got.items()), got


def fails(cell: str) -> dict:
    line, _ = small.run_small(cell)
    assert not line["correct"]
    return line["compared"]


# -- the count cells -------------------------------------------------------


@pytest.mark.parametrize("cell", ["count.fastq", "count.resident"])
def test_count_state_left_unchanged(cell):
    from km_tpu_torch.ops import count as ops_count

    def unchanged(acc, keys, lengths, out, sort_chunk=None):
        for a, o in zip(acc, out):
            o.copy_(a)
        return out

    with patched(ops_count, "merge_accum_device", unchanged):
        got = fails(cell)
    assert got["table_mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", ["count.fastq", "count.resident"])
def test_count_half_of_the_chunks_left_out(cell):
    from km_tpu_torch.ops import count as ops_count

    real = ops_count.chunk_stream

    def half(*a, **kw):
        for i, item in enumerate(real(*a, **kw)):
            if i % 2 == 0:
                yield item

    from km_tpu_torch.tools import count as tools_count

    # chunks small enough that the sample has many
    spec = small.SmallSpec()
    spec.config = lambda name: dict(small.SmallSpec.config(spec, name),
                                    chunk=1 << 12)
    with patched(ops_count, "chunk_stream", half), \
            patched(tools_count, "CHUNK", {"cpu": 1 << 12}):
        line, _ = small.run_small(cell, spec=spec)
    assert not line["correct"]
    assert line["compared"]["windows_gap"]["value"] > 0


@pytest.mark.parametrize("cell", ["count.fastq", "count.resident"])
def test_count_answer_altered(cell):
    real = count.Driver.call

    def altered(self):
        (keys, counts), work = real(self)
        counts = counts.copy()
        counts[len(counts) // 2] += 1
        return (keys, counts), work

    with patched(count.Driver, "call", altered):
        got = fails(cell)
    assert got["table_mismatches"]["value"] == 1


# -- the catalog cells -----------------------------------------------------


@pytest.mark.parametrize("cell", ["catalog.panel9", "catalog.batch400"])
def test_catalog_walk_state_left_unchanged(cell):
    from km_tpu_torch.ops import batch_walk

    real = batch_walk.device_discover

    def no_walk(ref_mers, table, **kw):
        kw["max_stack"] = 1  # no walklet leaves its seed k-mer
        return real(ref_mers, table, **kw)

    no_walk.calls, no_walk.stats = real.calls, {}  # it counts itself

    with patched(batch_walk, "device_discover", no_walk):
        got = fails(cell)
    assert got["rows_differing"]["value"] > 0


@pytest.mark.parametrize("cell", ["catalog.panel9", "catalog.batch400"])
def test_catalog_half_of_the_problems_left_out(cell):
    from km_tpu_torch.ops import nnls

    real = nnls.solve_batch

    def half(problems, device, defer=False):
        n = (len(problems) + 1) // 2
        fetch = real(problems[:n], device, defer=True)

        def both():
            sol = fetch()
            # the problems left out take the mean of the solved ones
            mean = [(np.full_like(c, np.mean([s[0].mean() for s in sol])),
                     np.full_like(r, np.mean([s[1].mean() for s in sol])))
                    for c, r in (s for s in sol)]
            return sol + [(np.resize(mean[0][0], len(p[0])),
                           np.resize(mean[0][1], len(p[0])))
                          for p in problems[n:]]

        return both if defer else both()

    with patched(nnls, "solve_batch", half):
        got = fails(cell)
    assert got["value_gap"]["value"] > catalog.VALUE_GAP_LIMIT


@pytest.mark.parametrize("cell", ["catalog.panel9", "catalog.batch400"])
def test_catalog_answer_altered(cell):
    real = catalog.Driver.call

    def altered(self):
        rows, work = real(self)
        for target in rows:
            if target:
                target[0].expression += 1e-6 * max(1, target[0].expression)
                break
        return rows, work

    with patched(catalog.Driver, "call", altered):
        got = fails(cell)
    assert got["value_gap"]["value"] > catalog.VALUE_GAP_LIMIT
