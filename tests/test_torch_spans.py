"""The port's spans (km_tpu_torch.utils.profiling) on the CPU: the phase
timer itself, the collector's span, the count's spans in its ``stats``,
the catalog's waits on the device inside their phases, and no CUDA-graph
span from CPU tensors. A tracer that wraps ``profiling.phase``, as the
benchmark's catalog cells do, sees every span."""

import contextlib
import gc
import json
import logging
import os
import time

import numpy as np
import pytest
import torch

from km_tpu_torch.io.fasta import read_target
from km_tpu_torch.models.batch import run_catalog
from km_tpu_torch.models.sequence import TargetSeq
from km_tpu_torch.models.table import CountTable
from km_tpu_torch.ops import batch_walk, nnls, pathgraph
from km_tpu_torch.ops import count as ops_count
from km_tpu_torch.ops.device_table import DeviceCountTable
from km_tpu_torch.refdata import DATA_DIR, catalog_dir
from km_tpu_torch.tools import count as tools_count
from km_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def fresh_tables():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def spans(monkeypatch):
    """(name, start ns, end ns) of every span the program opens, taken
    around ``profiling.phase`` as a tracer takes them."""
    out = []
    phase = profiling.phase

    @contextlib.contextmanager
    def spanned(name):
        t0 = time.perf_counter_ns()
        try:
            with phase(name):
                yield
        finally:
            out.append((name, t0, time.perf_counter_ns()))

    monkeypatch.setattr(profiling, "phase", spanned)
    return out


def test_phases_nest_and_their_seconds_add():
    for _ in range(2):
        with profiling.phase("outer"):
            with profiling.phase("inner"):
                time.sleep(0.01)
    got = profiling.report()
    assert list(got) == ["inner", "outer"]  # in the order they closed
    assert got["inner"] >= 0.02
    assert got["outer"] >= got["inner"]


def test_a_phase_lies_inside_the_span_that_encloses_it():
    """The phase's clock is the tracer's (perf_counter_ns): its interval
    lies within a span taken around it on that clock."""
    h0 = time.perf_counter_ns()
    with profiling.phase("x") as p:
        time.sleep(0.005)
    h1 = time.perf_counter_ns()
    end = p.t0 + round(profiling.report()["x"] * 1e9)
    assert h0 <= p.t0 < end <= h1
    assert end - p.t0 >= 5 * 10 ** 6


def test_record_function_only_under_device_trace(tmp_path, monkeypatch):
    with profiling.device_trace(str(tmp_path)):
        with profiling.phase("spans.traced"):
            torch.ones(8).sum()
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "spans.traced" in names

    def refused(name):
        raise AssertionError("record_function outside device_trace")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    with profiling.phase("spans.untraced"):
        pass
    assert "spans.untraced" in profiling.report()


def test_no_log_line_on_each_exit(caplog):
    caplog.set_level(logging.INFO)
    for _ in range(3):
        with profiling.phase("quiet"):
            pass
    assert caplog.records == []
    profiling.report()
    assert len(caplog.records) == 1  # report() logs each phase's total


def test_a_full_collection_is_the_span_gc():
    with profiling.phase("outer"):
        gc.collect(2)
    got = profiling.report()
    assert 0 < got["gc"] <= got["outer"]
    profiling.reset()
    gc.collect(1)  # younger generations are not timed
    assert "gc" not in profiling.report()


def _fastq(path, n_reads=400, seed=17):
    rng = np.random.default_rng(seed)
    ref = "".join(rng.choice(list("ACGT"), 2500))
    with open(path, "w") as f:
        for i, o in enumerate(rng.integers(0, len(ref) - 80, n_reads)):
            f.write("@r%d\n%s\n+\n%s\n" % (i, ref[o:o + 80], "I" * 80))
    return str(path)


def test_every_attempt_of_a_count_adds_its_spans(tmp_path, monkeypatch,
                                                 spans):
    """From 2^8 slots the accumulator grows on the device to 2^12 for
    ~2,500 keys: the file is parsed once (one ``count.input`` step a
    chunk, and the step that ends it), each growth is a ``count.grow``
    span, and no attempt is thrown away. A clock that steps 1 us a read
    makes each input step exactly 1 us."""
    fq = _fastq(tmp_path / "reads.fq")
    monkeypatch.setattr(tools_count, "START_CAPACITY", 1 << 8)
    clock = iter(range(0, 10 ** 12, 1000))
    monkeypatch.setattr(profiling, "perf_counter_ns", lambda: next(clock))
    stats = {}
    t0 = time.perf_counter()
    tools_count.count_read_files([fq], 21, min_count=1, device="cpu",
                                 stats=stats)
    seconds = time.perf_counter() - t0
    assert stats["retries"] == 0 and stats["capacity"] == 1 << 12
    assert stats["grows"] >= 1
    span_s = stats["span_s"]
    steps = [s for s in spans if s[0] == "count.input"]
    assert len(steps) == stats["chunks"] + 1  # the last step ends it
    assert span_s["count.input"] == pytest.approx(len(steps) * 1e-6)
    grows = [s for s in spans if s[0] == "count.grow"]
    assert len(grows) == stats["grows"]
    assert 0 < span_s["count.grow"] < seconds
    assert "count.overflowed" not in span_s
    assert "input_s" not in stats


@pytest.mark.parametrize("mode", ["stream", "chunked"])
def test_a_direct_count_has_its_spans(mode):
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, 4, 5000, dtype=np.uint8),
                np.ones(5000, bool)) for _ in range(3)]
    stats = {}
    if mode == "stream":
        ops_count.count_batches_device_stream(
            iter(batches), 21, chunk=1 << 12, capacity=1 << 15,
            device="cpu", stats=stats)
        want = {"count.input", "count.upload", "count.readback", "count.cut"}
    else:
        # under a ceiling of one chunk, the second chunk's merge dumps
        ops_count.count_batches_device_compact(
            iter(batches), 21, chunk=1 << 12, device="cpu", stats=stats,
            ceiling=1 << 12)
        want = {"count.input", "count.upload", "count.readback", "count.cut",
                "count.dump", "count.host_merge"}
        assert stats["dumps"] >= 1
    assert set(stats["span_s"]) == want
    assert all(v > 0 for v in stats["span_s"].values())
    assert stats["chunks"] > 1 and "input_s" not in stats


def test_the_catalog_waits_on_the_device_inside_their_phases(spans):
    host = CountTable.from_jf(os.path.join(DATA_DIR, "jf",
                                           "02H025_NPM1.jf"))
    cat = catalog_dir("GRCh38")
    targets = []
    for fn in sorted(os.listdir(cat))[:3]:
        seqs, _ = read_target(os.path.join(cat, fn))
        targets.append(TargetSeq("".join(seqs), os.path.splitext(fn)[0],
                                 host.k))
    run_catalog(targets, DeviceCountTable.from_host(host, device="cpu"))
    for sync, outer in (("walk.sync", "walk"), ("sweeps.sync", "sweeps"),
                        ("nnls.sync", "nnls")):
        inner = [s for s in spans if s[0] == sync]
        around = [s for s in spans if s[0] == outer]
        assert inner, sync
        for _, s0, s1 in inner:
            assert any(a0 <= s0 and s1 <= a1 for _, a0, a1 in around), sync
    assert set(profiling.report()) >= {"walk.sync", "sweeps.sync",
                                       "nnls.sync"}


def branch_walk(device, insertion: int):
    """One target's k-mers and a table of the target and one branch off
    it, on ``device``: an insertion of ``insertion`` random bases that
    rejoins the target (walked in about that many rounds), or with 0 a
    single k-mer that leads nowhere (a walk that ends in its first
    block of rounds)."""
    k = 17
    rng = np.random.default_rng(23)
    ref = "".join(rng.choice(list("ACGT"), 80))
    p = 40
    other = "ACGT".replace(ref[p], "")[0]
    if insertion:
        branch = ref[:p] + "".join(rng.choice(list("ACGT"), insertion)) \
            + ref[p:]
    else:
        branch = ref[p - k + 1:p] + other
    host = CountTable.from_sequences([ref] * 20 + [branch] * 20, k)
    target = TargetSeq(ref, "branch", k)
    return [target.ref_mer], DeviceCountTable.from_host(host, device=device)


def chain_sweeps(device, B: int, n: int):
    """``sweep_kernel``'s inputs for B copies of the chain 0 -> 1 -> ...
    -> n-1 from node 0: every node's predecessor is the node before."""
    ids = torch.full((B, n, 4), -1, dtype=torch.int64, device=device)
    ids[:, :-1, 0] = torch.arange(1, n, device=device)
    w = torch.ones((B, n, 4), dtype=torch.float32, device=device)
    return ids, w, torch.zeros(B, dtype=torch.int64, device=device)


@pytest.mark.parametrize("loop", ["walk", "sweeps", "nnls"])
def test_cpu_tensors_open_no_graph_span(loop, spans):
    """The device loops on CPU tensors run eagerly, over several blocks,
    and open no ``graph.*`` span."""
    if loop == "walk":
        batch_walk.device_discover(*branch_walk("cpu", 60))
        assert batch_walk.device_discover.stats["rounds"] \
            > 2 * batch_walk.CHECK_EVERY
    elif loop == "sweeps":
        n = 3 * pathgraph.SWEEP_BLOCK + 5  # not a whole number of blocks
        prev = pathgraph.sweep_kernel(*chain_sweeps("cpu", 2, n))
        assert prev[:, 1:].tolist() == [list(range(n - 1))] * 2
    else:
        contrib = torch.rand((2, 6, 2), dtype=torch.float64)
        ref = nnls.Refinement(contrib, contrib.sum(2) * 3,
                              torch.zeros((2, 2), dtype=torch.float64),
                              torch.full((2,), 6.0, dtype=torch.float64))
        ref.queue(4)
        ref.finish()
        assert ref.iters > 2 * nnls.UNROLL
    assert [s for s in spans if s[0].startswith("graph.")] == []
