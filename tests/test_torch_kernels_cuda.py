"""The CUDA kernels against their plain torch versions, and the batched
catalog's device path against the port's host path, on a card.

These tests skip where there is no CUDA device. The machine with the
card has no JAX, and tests/conftest.py imports it, so run them there
from the repo root without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

import torch

import os

from km_tpu_torch.device import SENTINEL
from km_tpu_torch.io.fasta import read_target
from km_tpu_torch.models.batch import run_catalog
from km_tpu_torch.models.pathfinder import OverlapGraph
from km_tpu_torch.models.sequence import TargetSeq
from km_tpu_torch.models.table import CountTable
from km_tpu_torch.ops import (batch_walk, count, merge, pack, pathgraph,
                              sort_runs)
from km_tpu_torch.ops.count import count_batches_host, empty_accumulator
from km_tpu_torch.ops.device_table import DeviceCountTable
from km_tpu_torch.refdata import DATA_DIR, catalog_dir
from km_tpu_torch.scripts.merge_cases import (CARD_CASES, CASES, CUT_CASES,
                                              SORT_CHUNK, SORT_CHUNKS,
                                              accumulator, cut_accumulator,
                                              cut_case, make_case,
                                              piece_size, sample_shape,
                                              scale_shape, sorted_chunk,
                                              zipf_chunk)

from test_torch_spans import branch_walk, chain_sweeps

KS = [2, 15, 16, 17, 21, 31]


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips where there is none (the kernels
    have no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << 15, 5003, 1])
def test_pack_kernel_matches_plain(cuda_device, n):
    rng = np.random.default_rng(7)
    codes = torch.from_numpy(rng.integers(0, 4, n, dtype=np.uint8))
    valid = torch.from_numpy(rng.random(n) > 0.02)
    c, v = codes.to(cuda_device), valid.to(cuda_device)
    launches = pack.pack_canonical_windows.launches
    for k in KS:
        for canonical in (True, False):
            got = pack.pack_canonical_windows(c, v, k, canonical)
            want = pack.pack_canonical_windows_plain(c, v, k, canonical)
            assert torch.equal(got, want), (n, k, canonical)
            assert torch.equal(got.cpu(), pack.pack_canonical_windows(
                codes, valid, k, canonical))
    assert pack.pack_canonical_windows.launches == launches + 2 * len(KS)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [sort_runs.MIN_CHUNK, 4096, sort_runs.CHUNK])
@pytest.mark.parametrize("n", [1, 5000, 3 * sort_runs.CHUNK + 77])
def test_sort_runs_kernel_matches_plain(cuda_device, chunk, n):
    rng = np.random.default_rng(13)
    keys = rng.integers(0, 1 << 6, n).astype(np.int64) << 30  # heavy ties
    keys[rng.random(n) < 0.05] = SENTINEL
    keys = torch.from_numpy(keys).to(cuda_device)
    got_k, got_l = sort_runs.sort_chunks_runs(keys, chunk=chunk)
    want_k, want_l = sort_runs.sort_chunks_runs_plain(keys, chunk=chunk)
    assert torch.equal(got_k, want_k)
    assert torch.equal(got_l, want_l)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [sort_runs.MIN_CHUNK, 4096, sort_runs.CHUNK])
@pytest.mark.parametrize("n", [1, 5000, 3 * sort_runs.CHUNK + 77])
def test_sort_chunks_kernel_matches_plain(cuda_device, chunk, n):
    rng = np.random.default_rng(14)
    keys = rng.integers(0, 1 << 6, n).astype(np.int64) << 30  # heavy ties
    keys[rng.random(n) < 0.05] = SENTINEL
    keys = torch.from_numpy(keys).to(cuda_device)
    launches = sort_runs.sort_chunks.launches
    got = sort_runs.sort_chunks(keys, chunk=chunk)
    assert torch.equal(got, sort_runs.sort_chunks_plain(keys, chunk=chunk))
    assert torch.equal(got, sort_runs.sort_chunks_runs(keys, chunk=chunk)[0])
    assert sort_runs.sort_chunks.launches == launches + 1


def _catalog(k):
    cat = catalog_dir("GRCh38")
    targets = []
    for fn in sorted(os.listdir(cat)):
        seqs, _ = read_target(os.path.join(cat, fn))
        targets.append(TargetSeq("".join(seqs), os.path.splitext(fn)[0], k))
    return targets


@pytest.mark.cuda
@pytest.mark.parametrize("sample", ["02H025_NPM1", "02H033_DNMT3A_sub",
                                    "03H112_IandI", "03H116_ITD",
                                    "05H094_FLT3-TKD_del"])
def test_device_catalog_matches_host_path(cuda_device, sample):
    host = CountTable.from_jf(os.path.join(DATA_DIR, "jf", sample + ".jf"))
    targets = _catalog(host.k)
    want = [[str(r) for r in rows] for rows in run_catalog(targets, host)]
    table = DeviceCountTable.from_host(host, device=cuda_device)
    got = run_catalog(targets, table)
    assert [[str(r) for r in rows] for rows in got] == want


@pytest.mark.cuda
def test_graph_replay_changes_nothing(cuda_device):
    """The walk (with overflow and depth retries), the sweeps and NNLS
    replayed as CUDA graphs give what CPU tensors give."""
    host = CountTable.from_jf(os.path.join(DATA_DIR, "jf", "03H116_ITD.jf"))
    targets = _catalog(host.k) * 5
    mers = [t.ref_mer for t in targets]
    kw = dict(walklet_cap=8, copy_cap=1, commit_cap=1, log_cap=2,
              stack_cap=8)
    cpu = DeviceCountTable.from_host(host, device="cpu")
    card = DeviceCountTable.from_host(host, device=cuda_device)
    want = batch_walk.device_discover(mers, cpu, **kw)
    rows_want = [[str(r) for r in rs] for rs in run_catalog(targets, cpu)]
    got = batch_walk.device_discover(mers, card, **kw)
    assert [list(r) for r in got] == [list(r) for r in want]
    assert got == want
    assert batch_walk.device_discover.stats["retries"] > 0
    rows = run_catalog(targets, card)
    assert [[str(r) for r in rs] for rs in rows] == rows_want


@pytest.mark.cuda
def test_sweep_ties_on_card(cuda_device):
    """argmin on the card takes the lowest index among equal distances:
    a diamond of equal paths and random graphs with weights 1 and 0.01
    give the host spec's trees."""
    rng = np.random.default_rng(5)
    graphs = []
    for n_real in [4] + [int(x) for x in rng.integers(3, 300, 10)]:
        g = OverlapGraph.__new__(OverlapGraph)
        g.n_real, g.n, g.k = n_real, n_real + 2, 31
        g.first_node, g.last_node = n_real, n_real + 1
        g._src, g._dst, g._w = [], [], []
        if n_real == 4:
            for j in (3, 1, 2, 0):
                g.set_edge(g.first_node, j, 1.0)
                g.set_edge(j, g.last_node, 1.0)
        else:
            for _ in range(4 * g.n):
                i, j = (int(x) for x in rng.integers(0, g.n, 2))
                if i != j:
                    g.set_edge(i, j, 0.01 if rng.random() < 0.3 else 1.0)
        g.freeze()
        graphs.append(g)
    got = pathgraph.batched_sweeps(graphs, cuda_device)
    for g, (before, after) in zip(graphs, got):
        assert np.array_equal(before, g._sweep(g.first_node, g.succ_ptr,
                                               g.succ_ids, g.succ_w))
        assert np.array_equal(after, g._sweep(g.last_node, g.pred_ptr,
                                              g.pred_ids, g.pred_w))
    assert got[0][0][graphs[0].last_node] == 0


@pytest.mark.cuda
def test_each_capture_is_one_warm_up_and_one_capture_span(cuda_device,
                                                          monkeypatch):
    """A CUDA graph of the walk, the sweeps and NNLS is built as one span
    ``graph.warm_up`` and one ``graph.capture``; replays open none. A
    loop that ends within its first block captures nothing: a walk whose
    rounds fit one block, a refinement that converges in one."""
    from km_tpu_torch.ops import nnls
    from km_tpu_torch.utils import profiling

    names = []
    phase = profiling.phase

    def recorded(name):
        names.append(name)
        return phase(name)

    def builds():
        return [x for x in names if x.startswith("graph.")]

    monkeypatch.setattr(profiling, "phase", recorded)
    for insertion, want in ((0, ["graph.warm_up"]),
                            (30, ["graph.warm_up", "graph.capture"])):
        rows = batch_walk.device_discover(*branch_walk("cpu", insertion))
        rounds = batch_walk.device_discover.stats["rounds"]
        assert (rounds > batch_walk.CHECK_EVERY) == bool(insertion)
        names.clear()
        got = batch_walk.device_discover(*branch_walk(cuda_device, insertion))
        assert got == rows
        assert batch_walk.device_discover.stats["rounds"] == rounds
        assert builds() == want
        assert "walk.sync" in names

    names.clear()
    B, n = 2, 4 * pathgraph.SWEEP_BLOCK
    prev = pathgraph.sweep_kernel(*chain_sweeps(cuda_device, B, n))
    assert prev[0, 1:].tolist() == list(range(n - 1))
    assert builds() == ["graph.warm_up", "graph.capture"]

    def refinement(contrib, coef0):
        return nnls.Refinement(contrib, contrib.sum(2) * 3, coef0,
                               torch.full((B,), 6.0, dtype=torch.float64,
                                          device=cuda_device))

    names.clear()
    contrib = torch.rand((B, 6, 2), dtype=torch.float64, device=cuda_device)
    ref = refinement(contrib, torch.zeros((B, 2), dtype=torch.float64,
                                          device=cuda_device))
    ref.queue(4)
    ref.finish()
    assert builds() == ["graph.warm_up", "graph.capture"]
    assert "nnls.sync" in names

    names.clear()
    # started at the solution (counts = contrib @ [3, 3]), the gradient
    # test passes at once: one block converges and nothing is captured
    ref = refinement(contrib, torch.full((B, 2), 3.0, dtype=torch.float64,
                                         device=cuda_device))
    ref.queue(1)
    coef, _ = ref.finish()
    assert ref.iters == nnls.UNROLL
    assert torch.allclose(coef, torch.full_like(coef, 3.0))
    assert builds() == ["graph.warm_up"]


@pytest.mark.cuda
def test_stream_on_card_matches_host(cuda_device):
    rng = np.random.default_rng(11)
    ref = rng.integers(0, 4, 40000, dtype=np.uint8)
    batches = [(ref[o:o + 100], rng.random(100) > 0.01)
               for o in rng.integers(0, len(ref) - 100, 3000)]
    hk, hc = count_batches_host(iter(batches), 21)
    dk, dc = count.count_batches_device_stream(
        iter(batches), 21, chunk=1 << 16, capacity=1 << 16,
        device=cuda_device)
    np.testing.assert_array_equal(dk, hk)
    np.testing.assert_array_equal(dc, hc)


def _merge_kernels_match_plain(acc, runs, C, sort_chunk, dev):
    """M1 and M2 against their plain versions on the same inputs: equal
    runs and run count, and equal output buffers and n_unique bit for
    bit; one launch of each."""
    launches = (merge.chunk_runs.launches, merge.merge_accum.launches)
    got_k, got_c, got_m = merge.chunk_runs(*runs, sort_chunk)
    want_k, want_c, want_m = merge.chunk_runs_plain(*runs, sort_chunk)
    m = int(want_m)
    assert int(got_m) == m
    assert torch.equal(got_k[:m], want_k[:m])
    assert torch.equal(got_c[:m], want_c[:m])
    outs = []
    for fn in (merge.merge_accum, merge.merge_accum_plain):
        out = empty_accumulator(C, dev)
        fn(*acc, got_k, got_c, got_m, *out)
        outs.append(out)
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    assert (merge.chunk_runs.launches, merge.merge_accum.launches) == (
        launches[0] + 1, launches[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + CARD_CASES)
def test_merge_kernels_match_plain(cuda_device, case):
    acc, counts, chunk, C = make_case(case)
    sc = piece_size(case)
    _merge_kernels_match_plain(
        accumulator(acc, counts, C, cuda_device),
        sorted_chunk(chunk, sc, cuda_device), C, sc, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("sort_chunk", SORT_CHUNKS)
def test_merge_kernels_every_sort_chunk(cuda_device, sort_chunk):
    acc, counts, chunk, C = make_case("ragged", sort_chunk=sort_chunk)
    _merge_kernels_match_plain(
        accumulator(acc, counts, C, cuda_device),
        sorted_chunk(chunk, sort_chunk, cuda_device), C, sort_chunk,
        cuda_device)


@pytest.mark.cuda
def test_merge_accum_restores_padding_on_card(cuda_device):
    """A merge into a buffer that held more keys than the result pads
    again exactly the slots that were live, as the plain version does."""
    acc, counts, chunk, C = make_case("all_new")
    runs = merge.chunk_runs(*sorted_chunk(chunk, SORT_CHUNK, cuda_device),
                            SORT_CHUNK)
    big = empty_accumulator(C, cuda_device)
    merge.merge_accum(*accumulator(acc, counts, C, cuda_device), *runs, *big)
    small = accumulator(acc[:10], counts[:10], C, cuda_device)
    few = torch.tensor(5, dtype=torch.int64, device=cuda_device)
    assert int(big[2]) > 15
    outs = []
    for fn in (merge.merge_accum, merge.merge_accum_plain):
        out = tuple(t.clone() for t in big)
        fn(*small, *runs[:2], few, *out)
        outs.append(out)
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    n = int(outs[0][2])
    assert n == 15
    assert (outs[0][0][n:] == SENTINEL).all()
    assert (outs[0][1][n:] == 0).all()


@pytest.mark.cuda
def test_merge_kernels_at_the_sample_shape(cuda_device):
    acc, runs = sample_shape(cuda_device)
    _merge_kernels_match_plain(acc, runs, acc[0].numel(), sort_runs.CHUNK,
                               cuda_device)


@pytest.mark.cuda
def test_merge_kernels_at_the_scale_count_shape(cuda_device):
    acc, runs = scale_shape(cuda_device)
    _merge_kernels_match_plain(acc, runs, acc[0].numel(), sort_runs.CHUNK,
                               cuda_device)


@pytest.mark.cuda
def test_chunk_runs_on_zipf_skewed_keys(cuda_device):
    """M1 on a 2^24-window chunk of reads expressed by Zipf's law
    (exponent 1.2: the top transcript's keys in most of the 1,024
    pieces) gives torch.unique's keys and counts, and the tally it adds
    to holds its run count."""
    keys = zipf_chunk(cuda_device, s=1.2)
    want_k, want_c = torch.unique(keys[keys != SENTINEL],
                                  return_counts=True)
    counters = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    with merge.tally(counters):
        got_k, got_c, m = merge.chunk_runs(
            *sort_runs.sort_chunks_runs(keys), sort_runs.CHUNK)
    m = int(m)
    assert m == want_k.numel() and int(counters[0]) == m
    assert int(counters[1]) >= 0
    assert torch.equal(got_k[:m], want_k)
    assert torch.equal(got_c[:m], want_c)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_new", "bucket_over_tile",
                                  "key_in_more_pieces_than_tile"])
def test_chunk_runs_counts_its_extra_bucket_rounds(cuda_device, case):
    """The tally's second counter, M1's bucket rounds beyond one a
    bucket: 0 on uniform keys; more than 0 where a bucket exceeds the
    8,192-record tile. Its first is M1's run count."""
    _, _, chunk, _ = make_case(case)
    counters = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    with merge.tally(counters):
        _, _, m = merge.chunk_runs(
            *sorted_chunk(chunk, piece_size(case), cuda_device),
            piece_size(case))
    assert int(counters[0]) == int(m) > 0
    if case == "all_new":
        assert int(counters[1]) == 0
    else:
        assert int(counters[1]) > 0


def _cut_matches_plain(acc, min_count, dev):
    """C1 against its plain version on the same accumulator, each into
    out buffers of the same dead contents: equal result and equal
    buffers, bit for bit (so nothing past the kept records is written);
    one launch."""
    slots = acc[0].numel()
    g = torch.Generator(device=dev).manual_seed(5)
    dead = (torch.randint(-1 << 62, 1 << 62, (slots,), generator=g,
                          device=dev),
            torch.randint(-1 << 31, 1 << 31, (slots,), generator=g,
                          device=dev, dtype=torch.int32))
    launches = merge.cut.launches
    outs = []
    for fn in (merge.cut, merge.cut_plain):
        out = tuple(t.clone() for t in dead)
        outs.append((fn(*acc, min_count, *out), *out))
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    assert merge.cut.launches == launches + 1
    return outs[0][0].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("live", [1, 4095, 4096, 4097, 3 * 4096 + 5,
                                  (1 << 24) + 3])
def test_cut_kernel_matches_plain(cuda_device, live):
    acc = cut_accumulator(live, live + 777, cuda_device, seed=live)
    kept, total, n = _cut_matches_plain(acc, 2, cuda_device)
    assert n == live and 0 < kept <= live and total > kept


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUT_CASES))
def test_cut_kernel_edge_cases(cuda_device, case):
    _cut_matches_plain(*cut_case(case, cuda_device), cuda_device)


@pytest.mark.cuda
def test_stream_finish_raises_no_peak(cuda_device, monkeypatch):
    """The finish of a stream count (the cut into the spare accumulator,
    the kept records read back) allocates nothing the size of its output:
    the device's peak, set by the merges, does not rise over it, though a
    buffer of the kept records would have raised it."""
    rng = np.random.default_rng(17)
    ref = rng.integers(0, 4, 1 << 20, dtype=np.uint8)
    # 40 batches of 1,000 reads, 20 invalid bases after each read
    reads = ref[rng.integers(0, len(ref) - 100, 40000)[:, None]
                + np.arange(100)]
    gap = np.zeros((len(reads), 20), np.uint8)
    codes = np.concatenate([reads, gap], axis=1).reshape(40, -1)
    valid = np.concatenate([np.ones(reads.shape, bool), gap > 0],
                           axis=1).reshape(40, -1)
    batches = list(zip(codes, valid))
    at_cut = {}

    def cut(*args):
        torch.cuda.synchronize(cuda_device)
        at_cut.update(allocated=torch.cuda.memory_allocated(cuda_device),
                      peak=torch.cuda.max_memory_allocated(cuda_device))
        return merge.cut(*args)

    monkeypatch.setattr(count, "cut", cut)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    stats = {}
    keys, counts = count.count_batches_device_stream(
        iter(batches), 21, min_count=2, chunk=1 << 16, capacity=1 << 21,
        device=cuda_device, stats=stats)
    assert torch.cuda.max_memory_allocated(cuda_device) == at_cut["peak"]
    assert at_cut["peak"] - at_cut["allocated"] < 12 * stats["kept"]
    assert stats["kept"] == len(keys) > 0
    hk, hc = count_batches_host(iter(batches), 21, min_count=2)
    np.testing.assert_array_equal(keys, hk)
    np.testing.assert_array_equal(counts, hc)


@pytest.mark.cuda
def test_a_grown_stream_peaks_no_higher_than_its_final_capacity(
        cuda_device):
    """A stream count that grows from 2^12 slots reaches the device peak
    of the same count started at its final capacity, within 1 MiB (the
    old pair is freed before the new spare is allocated), and gives the
    same table and numbers: a chunk counted again by a growth is in M1's
    runs once."""
    rng = np.random.default_rng(19)
    ref = rng.integers(0, 4, 1 << 21, dtype=np.uint8)
    reads = ref[rng.integers(0, len(ref) - 100, 40000)[:, None]
                + np.arange(100)]
    gap = np.zeros((len(reads), 20), np.uint8)
    codes = np.concatenate([reads, gap], axis=1).reshape(40, -1)
    valid = np.concatenate([np.ones(reads.shape, bool), gap > 0],
                           axis=1).reshape(40, -1)
    batches = list(zip(codes, valid))

    def run(capacity):
        torch.cuda.synchronize(cuda_device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(cuda_device)
        before = torch.cuda.memory_allocated(cuda_device)
        stats = {}
        out = count.count_batches_device_stream(
            iter(batches), 21, min_count=2, chunk=1 << 16,
            capacity=capacity, device=cuda_device, stats=stats)
        torch.cuda.synchronize(cuda_device)
        return (out, stats,
                torch.cuda.max_memory_allocated(cuda_device) - before)

    (gk, gc), grown, grown_peak = run(1 << 12)
    assert grown["grows"] >= 2 and grown["capacity"] > 1 << 12
    (fk, fc), fixed, fixed_peak = run(grown["capacity"])
    assert fixed["grows"] == 0
    assert grown_peak <= fixed_peak + (1 << 20)
    np.testing.assert_array_equal(gk, fk)
    np.testing.assert_array_equal(gc, fc)
    for name in ("unique", "total", "kept", "runs", "capacity"):
        assert grown[name] == fixed[name], name
    hk, hc = count_batches_host(iter(batches), 21, min_count=2)
    np.testing.assert_array_equal(gk, hk)
    np.testing.assert_array_equal(gc, hc)
