"""km_tpu_torch's chunk sort, with and without run detection (plain
torch versions), against km_tpu's Pallas kernels in interpret mode at
the same chunk, and against numpy at the port's own chunk. Keys and run
lengths are compared exactly. The CUDA kernel is held against the plain
versions in tests/test_torch_kernels_cuda.py, on a card."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from km_tpu.ops.pallas_sort import sort_chunks, sort_chunks_runs

from km_tpu_torch.device import SENTINEL, split_to_i64
from km_tpu_torch.ops import sort_runs


def _tied_split_keys(n, seed=9):
    """Heavy ties and 5% sentinels, as tests/test_pallas_sort.py."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 4, n).astype(np.uint32)
    lo = rng.integers(0, 1 << 3, n, dtype=np.uint64).astype(np.uint32)
    sent_at = rng.random(n) < 0.05
    hi[sent_at] = 0xFFFFFFFF
    lo[sent_at] = 0xFFFFFFFF
    return hi, lo


def _numpy_sort_runs(keys, chunk):
    """Per-chunk np.sort; run lengths at run starts; sentinel runs 0."""
    n = len(keys)
    out = np.empty_like(keys)
    lengths = np.zeros(n, np.int32)
    for a in range(0, n, chunk):
        s = np.sort(keys[a:a + chunk])
        out[a:a + chunk] = s
        starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
        ends = np.r_[starts[1:], len(s)]
        lengths[a + starts] = np.where(s[starts] == SENTINEL, 0,
                                       ends - starts)
    return out, lengths


@pytest.mark.parametrize("chunk,n_chunks", [(1024, 1), (4096, 3)])
def test_plain_matches_pallas(chunk, n_chunks):
    hi, lo = _tied_split_keys(chunk * n_chunks)
    fhi, flo, flen = sort_chunks_runs(jnp.asarray(hi), jnp.asarray(lo),
                                      chunk=chunk, interpret=True)
    keys, lengths = sort_runs.sort_chunks_runs(
        torch.from_numpy(split_to_i64(hi, lo)), chunk=chunk)
    assert lengths.dtype == torch.int32
    np.testing.assert_array_equal(
        keys.numpy(), split_to_i64(np.asarray(fhi), np.asarray(flo)))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(flen))


@pytest.mark.parametrize("n", [sort_runs.CHUNK * 2, sort_runs.CHUNK * 2 + 517])
def test_plain_default_chunk_matches_numpy(n):
    """The port's own 2^14 chunk, including a ragged last chunk."""
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 1 << 9, n).astype(np.int64) << 50
    keys[rng.random(n) < 0.05] = SENTINEL
    got_k, got_l = sort_runs.sort_chunks_runs(torch.from_numpy(keys))
    want_k, want_l = _numpy_sort_runs(keys, sort_runs.CHUNK)
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_l.numpy(), want_l)


def _port_domain_split_keys(n, seed=10):
    """Keys the port can hold (< 2^62, heavy ties) and 5% sentinels, as
    km_tpu (hi, lo) pairs."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 6, n).astype(np.uint64) << np.uint64(55)
    keys |= rng.integers(0, 4, n).astype(np.uint64)
    keys[rng.random(n) < 0.05] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return ((keys >> np.uint64(32)).astype(np.uint32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))


@pytest.mark.parametrize("chunk,n_chunks", [(1024, 1), (4096, 3)])
def test_sort_chunks_plain_matches_pallas(chunk, n_chunks):
    hi, lo = _port_domain_split_keys(chunk * n_chunks)
    fhi, flo = sort_chunks(jnp.asarray(hi), jnp.asarray(lo), chunk=chunk,
                           interpret=True)
    got = sort_runs.sort_chunks(torch.from_numpy(split_to_i64(hi, lo)),
                                chunk=chunk)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), split_to_i64(np.asarray(fhi), np.asarray(flo)))


@pytest.mark.parametrize("n", [sort_runs.CHUNK * 2, sort_runs.CHUNK * 2 + 517])
def test_sort_chunks_default_chunk_matches_numpy(n):
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 1 << 9, n).astype(np.int64) << 50
    keys[rng.random(n) < 0.05] = SENTINEL
    got = sort_runs.sort_chunks(torch.from_numpy(keys))
    want, _lengths = _numpy_sort_runs(keys, sort_runs.CHUNK)
    np.testing.assert_array_equal(got.numpy(), want)
