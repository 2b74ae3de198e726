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
from km_tpu_torch.scripts.merge_cases import (CASES, SORT_CHUNK, SORT_CHUNKS,
                                              accumulator, make_case,
                                              sample_shape, sorted_chunk)

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
@pytest.mark.parametrize("case", CASES)
def test_merge_kernels_match_plain(cuda_device, case):
    acc, counts, chunk, C = make_case(case)
    _merge_kernels_match_plain(
        accumulator(acc, counts, C, cuda_device),
        sorted_chunk(chunk, SORT_CHUNK, cuda_device), C, SORT_CHUNK,
        cuda_device)


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
