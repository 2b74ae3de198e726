"""km_tpu_torch's counting pipeline on CPU tensors (the kernels' plain
versions) against km_tpu's device path on the CPU and its numpy host
counter. Keys and counts are compared exactly."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from km_tpu.ops import count as jcount
from km_tpu.ops import encode
from km_tpu.ops.pallas_pack import BLOCK_ROWS, LANES

from km_tpu_torch.convert import accumulator_from_jax
from km_tpu_torch.device import SENTINEL, split_to_i64
from km_tpu_torch.ops import count as tcount

BASES = "ACGT"


def _seq(rng, n):
    return "".join(BASES[b] for b in rng.integers(0, 4, n))


def _batches(reads, skip_every=None):
    for s in reads:
        codes = encode.seq_to_codes(s)
        valid = np.ones(len(codes), bool)
        if skip_every:
            valid[::skip_every] = False  # low-quality bases
        yield codes, valid


def _as_map(keys, counts):
    """Per-run records -> {key: summed count} (keys as ints)."""
    keys = np.asarray(keys)
    counts = np.asarray(counts).astype(np.int64)
    alive = counts > 0
    uk, inv = np.unique(keys[alive], return_inverse=True)
    tot = np.zeros(len(uk), np.int64)
    np.add.at(tot, inv, counts[alive])
    return dict(zip(uk.tolist(), tot.tolist()))


def _host_map(codes, valid, k, canonical=True):
    hk, hc = jcount.count_batches_host([(codes, valid)], k,
                                       canonical=canonical)
    return dict(zip(hk.astype(np.int64).tolist(), hc.tolist()))


_jit_count_chunk = jax.jit(
    jcount.count_chunk_device,
    static_argnames=("k", "canonical", "use_pallas", "use_pallas_sort",
                     "sort_chunk"))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_count_chunk_matches_km_tpu_and_host(use_pallas):
    rng = np.random.default_rng(4)
    n = BLOCK_ROWS * LANES  # the Pallas pack's block
    k = 31
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    codes[n // 2:n // 2 + 4000] = codes[:4000]  # repeated k-mers
    valid = rng.random(n) > 0.02

    hi, lo, cnt = _jit_count_chunk(jnp.asarray(codes), jnp.asarray(valid),
                                   k=k, canonical=True, use_pallas=use_pallas)
    want = _as_map(split_to_i64(np.asarray(hi), np.asarray(lo)), cnt)

    keys, lengths = tcount.count_chunk_device(
        torch.from_numpy(codes), torch.from_numpy(valid), k)
    got = _as_map(keys.numpy(), lengths.numpy())
    assert got == want == _host_map(codes, valid, k)


def test_count_chunk_bit_equal_to_km_tpu_chunk_sort():
    """At the same sort chunk km_tpu's Pallas chunk sort (interpret mode)
    and the port lay out the same keys and run lengths."""
    rng = np.random.default_rng(8)
    n, k, chunk = 4096, 21, 1024
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    valid = rng.random(n) > 0.02
    hi, lo, cnt = _jit_count_chunk(
        jnp.asarray(codes), jnp.asarray(valid), k=k, canonical=True,
        use_pallas=False, use_pallas_sort=True, sort_chunk=chunk)
    keys, lengths = tcount.count_chunk_device(
        torch.from_numpy(codes), torch.from_numpy(valid), k,
        sort_chunk=chunk)
    np.testing.assert_array_equal(
        keys.numpy(), split_to_i64(np.asarray(hi), np.asarray(lo)))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(cnt))


def test_stream_matches_km_tpu_and_host():
    rng = np.random.default_rng(11)
    ref = _seq(rng, 4000)
    reads = [ref[o:o + 100] for o in rng.integers(0, len(ref) - 100, 300)]
    k = 21
    hk, hc = jcount.count_batches_host(_batches(reads), k)
    jk, jc = jcount.count_batches_device_stream(
        _batches(reads), k, chunk=1 << 12, capacity=1 << 13)
    stats = {}
    tk, tc = tcount.count_batches_device_stream(
        _batches(reads), k, chunk=1 << 12, capacity=1 << 13, device="cpu",
        sort_chunk=1024, stats=stats)
    assert tk.dtype == np.uint64 and tc.dtype == np.uint32
    np.testing.assert_array_equal(tk, hk)
    np.testing.assert_array_equal(tc, hc)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tc, jc)
    assert stats["total"] == int(hc.sum())
    assert stats["unique"] == len(hk)


@pytest.mark.parametrize("min_count", [2, 3])
def test_stream_min_count_and_quality(min_count):
    rng = np.random.default_rng(12)
    ref = _seq(rng, 1000)
    reads = [ref[o:o + 60] for o in rng.integers(0, len(ref) - 60, 80)]
    k = 17
    hk, hc = jcount.count_batches_host(_batches(reads, 23), k,
                                       min_count=min_count)
    tk, tc = tcount.count_batches_device_stream(
        _batches(reads, 23), k, min_count=min_count, chunk=1 << 11,
        capacity=1 << 12, device="cpu", sort_chunk=1024)
    assert len(hk) and (hc >= min_count).all()
    np.testing.assert_array_equal(tk, hk)
    np.testing.assert_array_equal(tc, hc)


def test_accumulator_carried_across_gives_same_merge():
    """km_tpu's accumulator after one chunk, carried into the port by
    convert.accumulator_from_jax, merges the next chunk as km_tpu does."""
    rng = np.random.default_rng(21)
    n, k, C = 4096, 21, 1 << 13
    base = rng.integers(0, 4, n, dtype=np.uint8)
    chunk_a = (base, rng.random(n) > 0.02)
    nxt = base.copy()
    nxt[::7] = rng.integers(0, 4, len(nxt[::7]))  # shared and new keys
    chunk_b = (nxt, rng.random(n) > 0.02)

    sent = np.full(C, 0xFFFFFFFF, np.uint32)
    acc = (jnp.asarray(sent), jnp.asarray(sent), jnp.zeros(C, jnp.int32))
    runs_a = _jit_count_chunk(jnp.asarray(chunk_a[0]),
                              jnp.asarray(chunk_a[1]), k=k, canonical=True)
    acc = jcount.merge_accum_device(*acc, *runs_a, C)[:3]
    rhi, rlo, rcnt = _jit_count_chunk(jnp.asarray(chunk_b[0]),
                                      jnp.asarray(chunk_b[1]), k=k,
                                      canonical=True)
    jhi, jlo, jcnt, jnu = jcount.merge_accum_device(*acc, rhi, rlo, rcnt, C)

    acc_keys, acc_cnt = accumulator_from_jax(*acc)
    assert (acc_keys[int(jnp.sum(acc[2] > 0)):] == SENTINEL).all()
    rkeys = torch.from_numpy(split_to_i64(np.asarray(rhi), np.asarray(rlo)))
    acc_n = (acc_keys != SENTINEL).sum()
    keys, cnt, nu = tcount.merge_accum_device(
        (acc_keys, acc_cnt, acc_n), rkeys, torch.tensor(np.asarray(rcnt)),
        tcount.empty_accumulator(C, "cpu"))
    # the live prefix is equal; past it km_tpu leaves keys with count 0
    # (its compaction sorts the dead entries behind the live ones), the
    # port leaves SENTINEL: both are empty slots to the next merge
    nu = int(nu)
    assert nu == int(jnu)
    np.testing.assert_array_equal(
        keys[:nu].numpy(),
        split_to_i64(np.asarray(jhi[:nu]), np.asarray(jlo[:nu])))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert (keys[nu:] == SENTINEL).all()


def test_sum_runs_exact_where_km_tpu_bound_undercounts():
    """km_tpu's bounded merge scan undercounts a run longer than its
    max_run (ops/count.py:214-215); the port's segment sums are exact."""
    rng = np.random.default_rng(5)
    keys = np.concatenate([np.full(40, 7), rng.integers(0, 100, 200)])
    keys = rng.permutation(keys).astype(np.int64)
    counts = rng.integers(1, 5, len(keys)).astype(np.int32)
    want = _as_map(keys, counts)

    skeys, tot = tcount.sum_runs_device(torch.from_numpy(keys),
                                        torch.from_numpy(counts))
    assert _as_map(skeys.numpy(), tot.numpy()) == want
    assert (np.diff(skeys.numpy()) >= 0).all()

    lo = jnp.asarray(keys.astype(np.uint32))
    hi = jnp.zeros_like(lo)
    _, jlo, jexact = jcount.sum_runs_device(hi, lo, jnp.asarray(counts))
    np.testing.assert_array_equal(tot.numpy(), np.asarray(jexact))
    _, jlo, jbound = jcount.sum_runs_device(hi, lo, jnp.asarray(counts),
                                            max_run=8)
    assert _as_map(np.asarray(jlo), jbound)[7] < want[7]


def test_capacity_overflow_raises():
    rng = np.random.default_rng(13)
    reads = [_seq(rng, 3000)]  # nearly all 21-mers distinct
    with pytest.raises(tcount.CountCapacityOverflow) as e:
        tcount.count_batches_device_stream(
            _batches(reads), 21, chunk=1 << 11, capacity=256, device="cpu",
            sort_chunk=1024)
    assert e.value.capacity == 256


def test_overflow_then_no_new_keys_still_raises():
    """An overflow truncates the accumulator; the chunks after it bring
    no key. km_tpu checks only the latest unique count
    (ops/count.py:480-484) and returns the truncated table; the port
    keeps a running maximum and raises."""
    rng = np.random.default_rng(14)
    k, C = 21, 256
    dense = encode.seq_to_codes(_seq(rng, 3000))

    def batches():
        yield dense, np.ones(len(dense), bool)
        yield np.zeros(20000, np.uint8), np.zeros(20000, bool)

    hk, _ = jcount.count_batches_host(batches(), k)
    jk, _ = jcount.count_batches_device_stream(batches(), k, chunk=1 << 11,
                                               capacity=C)
    assert len(jk) == C < len(hk)  # km_tpu: silently truncated
    with pytest.raises(tcount.CountCapacityOverflow):
        tcount.count_batches_device_stream(
            batches(), k, chunk=1 << 11, capacity=C, device="cpu",
            sort_chunk=1024)
