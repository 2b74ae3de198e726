"""The merge kernels' plain versions (km_tpu_torch/ops/merge.py, reached on
CPU tensors through ops/count.py) against km_tpu's XLA merge on the CPU
and against numpy. Inputs come from km_tpu_torch/scripts/merge_cases.py;
keys, counts and the number of distinct keys are compared exactly."""

import numpy as np
import pytest

import jax
import torch

from km_tpu.ops import count as jcount

from km_tpu_torch.device import SENTINEL, i64_to_split, split_to_i64
from km_tpu_torch.ops import count as tcount
from km_tpu_torch.ops import merge
from km_tpu_torch.scripts.merge_cases import (CARD_CASES, CASES, LONG_RUN_KEY,
                                              SORT_CHUNK, SORT_CHUNKS,
                                              accumulator, make_case,
                                              piece_size, sorted_chunk)

# (acc_hi, acc_lo, acc_cnt, rhi, rlo, rcnt, C, max_run)
_jit_merge = jax.jit(jcount.merge_accum_device, static_argnums=(6, 7))


def _km_tpu_merge(acc, counts, keys, lengths, C, max_run=None):
    """km_tpu's merge_accum_device on the same accumulator and chunk:
    (keys int64 of the live prefix, their counts, n_unique)."""
    live = min(len(acc), C)
    pad = np.full(C, SENTINEL, np.int64)
    pad[:live] = acc[:live]
    cnt = np.zeros(C, np.int32)
    cnt[:live] = counts[:live]
    rhi, rlo = i64_to_split(keys.numpy())
    hi, lo, jcnt, nu = _jit_merge(*i64_to_split(pad), cnt, rhi, rlo,
                                  lengths.numpy(), C, max_run)
    nu = int(nu)
    n = min(nu, C)
    return (split_to_i64(np.asarray(hi[:n]), np.asarray(lo[:n])),
            np.asarray(jcnt[:n]).astype(np.int64), nu)


def _check_merge(acc, counts, chunk, C, sort_chunk):
    keys, lengths = sorted_chunk(chunk, sort_chunk)
    got_k, got_c, got_n = tcount.merge_accum_device(
        accumulator(acc, counts, C), keys, lengths,
        tcount.empty_accumulator(C, "cpu"), sort_chunk=sort_chunk)
    want_k, want_c, want_n = _km_tpu_merge(acc, counts, keys, lengths, C)
    nu = int(got_n)
    assert nu == want_n
    live = min(nu, C)
    np.testing.assert_array_equal(got_k[:live].numpy(), want_k)
    np.testing.assert_array_equal(got_c[:live].numpy(), want_c)
    # where km_tpu leaves keys with count 0, the port leaves SENTINEL
    assert (got_k[live:] == SENTINEL).all() and (got_c[live:] == 0).all()
    return got_k, got_c, nu


@pytest.mark.parametrize("case", CASES)
def test_merge_accum_matches_km_tpu(case):
    acc, counts, chunk, C = make_case(case)
    _, got_c, nu = _check_merge(acc, counts, chunk, C, SORT_CHUNK)
    if case == "n_unique_C":
        assert nu == C
    elif case.startswith("n_unique"):
        assert nu > C and int(got_c.sum()) < counts.sum() + (
            chunk != SENTINEL).sum()  # truncated, but counted in full
    elif case == "chunk_all_sentinel":
        assert nu == len(acc)


@pytest.mark.parametrize("sort_chunk", SORT_CHUNKS)
def test_merge_accum_every_sort_chunk_ragged(sort_chunk):
    _check_merge(*make_case("ragged", sort_chunk=sort_chunk), sort_chunk)


def _numpy_runs(keys, lengths, sort_chunk):
    """Each piece's live run starts merged with numpy (km_tpu's
    merge_runs)."""
    keys, lengths = keys.numpy(), lengths.numpy()
    out = (np.empty(0, np.int64), np.empty(0, np.int64))
    for off in range(0, len(keys), sort_chunk):
        live = lengths[off:off + sort_chunk] > 0
        out = jcount.merge_runs(*out, keys[off:off + sort_chunk][live],
                                lengths[off:off + sort_chunk][live])
    return out


@pytest.mark.parametrize("case", CASES)
def test_chunk_runs_matches_numpy(case):
    _acc, _counts, chunk, _C = make_case(case)
    keys, lengths = sorted_chunk(chunk, SORT_CHUNK)
    got_k, got_c, m = merge.chunk_runs(keys, lengths, SORT_CHUNK)
    want_k, want_c = _numpy_runs(keys, lengths, SORT_CHUNK)
    m = int(m)
    assert m == len(want_k) and got_k.numel() == len(chunk)
    np.testing.assert_array_equal(got_k[:m].numpy(), want_k)
    np.testing.assert_array_equal(got_c[:m].numpy(), want_c)
    assert int(got_c[:m].sum()) == int((chunk != SENTINEL).sum())


@pytest.mark.parametrize("sort_chunk", SORT_CHUNKS)
def test_chunk_runs_every_sort_chunk_ragged(sort_chunk):
    _acc, _counts, chunk, _C = make_case("ragged", sort_chunk=sort_chunk)
    keys, lengths = sorted_chunk(chunk, sort_chunk)
    assert len(chunk) % sort_chunk
    got_k, got_c, m = merge.chunk_runs_plain(keys, lengths, sort_chunk)
    want_k, want_c = _numpy_runs(keys, lengths, sort_chunk)
    np.testing.assert_array_equal(got_k[:int(m)].numpy(), want_k)
    np.testing.assert_array_equal(got_c[:int(m)].numpy(), want_c)


@pytest.mark.parametrize("case", CARD_CASES)
def test_chunk_runs_plain_on_the_card_cases(case):
    """The cases too large for the chain of numpy merges: the plain
    version against numpy's unique with the window counts."""
    _acc, _counts, chunk, _C = make_case(case)
    sc = piece_size(case)
    keys, lengths = sorted_chunk(chunk, sc)
    got_k, got_c, m = merge.chunk_runs(keys, lengths, sc)
    want_k, want_c = np.unique(chunk[chunk != SENTINEL], return_counts=True)
    m = int(m)
    np.testing.assert_array_equal(got_k[:m].numpy(), want_k)
    np.testing.assert_array_equal(got_c[:m].numpy(), want_c)
    assert int(got_c[0]) >= len(chunk) // sc  # the least key, every piece


def test_long_run_exact_where_km_tpu_bound_undercounts():
    """A key in every piece and in the accumulator: five records of one
    key, where km_tpu's fused step bounds a run by ceil(n / 2^17) + 2 =
    3 records and undercounts (ops/count.py:422); the port sums exactly,
    as km_tpu's unbounded path does."""
    acc, counts, chunk, C = make_case("long_run")
    keys, lengths = sorted_chunk(chunk, SORT_CHUNK)
    got_k, got_c, _ = _check_merge(acc, counts, chunk, C, SORT_CHUNK)
    want = int(counts[np.searchsorted(acc, LONG_RUN_KEY)]) + int(
        (chunk == LONG_RUN_KEY).sum())
    at = int(torch.searchsorted(got_k, LONG_RUN_KEY))
    assert int(got_c[at]) == want
    bk, bc, _ = _km_tpu_merge(acc, counts, keys, lengths, C, max_run=3)
    assert bc[np.searchsorted(bk, LONG_RUN_KEY)] < want


def test_merge_accum_pads_only_what_was_live():
    """The out buffer keeps SENTINEL past its live prefix: a merge into a
    buffer that held more keys than the result restores the padding over
    exactly those slots, and a merge from the result into the next buffer
    continues the stream."""
    acc, counts, chunk, C = make_case("all_new")
    keys, lengths = sorted_chunk(chunk, SORT_CHUNK)
    big = tcount.merge_accum_device(accumulator(acc, counts, C), keys,
                                    lengths,
                                    tcount.empty_accumulator(C, "cpu"))
    small = accumulator(acc[:10], counts[:10], C)
    tcount.merge_accum_device(small, keys[:0], lengths[:0], big)
    assert int(big[2]) == 10
    assert torch.equal(big[0][:10], small[0][:10])
    assert (big[0][10:] == SENTINEL).all() and (big[1][10:] == 0).all()


@pytest.mark.parametrize("case", ["C", "C_plus_1", "3C"])
def test_stream_capacity_bounds(case):
    """A stream whose distinct keys fill the capacity exactly counts them
    all at that capacity; from one slot fewer, or a third as many, the
    accumulator grows to the smallest doubling that holds them, and the
    table is the same."""
    rng = np.random.default_rng(4)
    batches = [(rng.integers(0, 4, 300, dtype=np.uint8),
                rng.random(300) > 0.02) for _ in range(12)]
    hk, hc = tcount.count_batches_host(iter(batches), 21)
    distinct = len(hk)
    capacity = {"C": distinct, "C_plus_1": distinct - 1,
                "3C": distinct // 3}[case]
    stats = {}
    dk, dc = tcount.count_batches_device_stream(
        iter(batches), 21, capacity=capacity, chunk=1 << 11, device="cpu",
        sort_chunk=1024, stats=stats)
    np.testing.assert_array_equal(dk, hk)
    np.testing.assert_array_equal(dc, hc)
    grown = capacity
    while grown < distinct:
        grown *= 2
    assert stats["capacity"] == grown
    assert (stats["grows"] >= 1) == (case != "C")


def test_wrappers_refuse_what_the_kernels_do_not_take():
    keys = torch.zeros(2048, dtype=torch.int64)
    lengths = torch.ones(2048, dtype=torch.int32)
    with pytest.raises(TypeError):
        merge.chunk_runs(keys, lengths.to(torch.int64))
    with pytest.raises(ValueError):
        merge.chunk_runs(keys, lengths, sort_chunk=1000)
    with pytest.raises(ValueError):
        merge.chunk_runs(keys[::2], lengths[::2])
    acc = tcount.empty_accumulator(64, "cpu")
    runs = (keys[:8], keys[:8].clone(), torch.tensor(0))
    with pytest.raises(ValueError, match="overlaps"):
        merge.merge_accum(*acc, *runs, *acc)
    with pytest.raises(ValueError, match="capacity"):
        merge.merge_accum(*acc, *runs, *tcount.empty_accumulator(32, "cpu"))
    with pytest.raises(TypeError):
        merge.merge_accum(*acc, keys[:8], lengths[:8], torch.tensor(0),
                          *tcount.empty_accumulator(64, "cpu"))
