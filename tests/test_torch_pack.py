"""km_tpu_torch's window pack (plain torch version) against km_tpu's
Pallas kernel in interpret mode, km_tpu's XLA spec and the numpy host
encoder. Keys are compared exactly, with km_tpu's all-ones (hi, lo)
sentinel mapped to the port's 2**63-1. The CUDA kernel is held against
the plain version in tests/test_torch_kernels_cuda.py, on a card."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from km_tpu.ops import encode
from km_tpu.ops.count import window_valid
from km_tpu.ops.pallas_pack import BLOCK_ROWS, LANES, pack_canonical_windows

from km_tpu_torch.device import SENTINEL, split_to_i64
from km_tpu_torch.ops import pack

from test_pallas_pack import _xla_reference

N = BLOCK_ROWS * LANES  # one grid block of the Pallas kernel
KS = [2, 15, 16, 17, 21, 31]


def _inputs(n, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, n, dtype=np.uint8), rng.random(n) > 0.02)


def _host_reference(codes, valid, k, canonical):
    want = encode.pack_code_windows(codes, k)
    if canonical:
        want = encode.canonical(want, k)
    return np.where(window_valid(valid, k), want.astype(np.int64), SENTINEL)


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", KS)
def test_plain_matches_pallas_and_host(k, canonical):
    codes, valid = _inputs(N)
    got = pack.pack_canonical_windows(torch.from_numpy(codes),
                                      torch.from_numpy(valid), k, canonical)
    assert got.dtype == torch.int64 and got.shape == (N,)
    got = got.numpy()

    hi, lo = pack_canonical_windows(jnp.asarray(codes), jnp.asarray(valid),
                                    k=k, canonical=canonical, interpret=True)
    np.testing.assert_array_equal(got, split_to_i64(np.asarray(hi),
                                                    np.asarray(lo)))
    nw = N - k + 1
    np.testing.assert_array_equal(got[:nw],
                                  _host_reference(codes, valid, k, canonical))
    assert (got[nw:] == SENTINEL).all()


@pytest.mark.parametrize("k", [2, 16, 31])
def test_plain_matches_xla_spec(k):
    """km_tpu's XLA formulation, whose k = 16 split the kernel mirrors."""
    codes, valid = _inputs(N, seed=4)
    got = pack.pack_canonical_windows(torch.from_numpy(codes),
                                      torch.from_numpy(valid), k).numpy()
    xhi, xlo = _xla_reference(codes, valid, k, True)
    np.testing.assert_array_equal(got[:N - k + 1], split_to_i64(xhi, xlo))


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", [16, 31])
def test_ragged_length_matches_host(k, canonical):
    """A length the Pallas kernel refuses (not a multiple of 32768)."""
    n = 5003
    codes, valid = _inputs(n, seed=5)
    got = pack.pack_canonical_windows(torch.from_numpy(codes),
                                      torch.from_numpy(valid), k,
                                      canonical).numpy()
    np.testing.assert_array_equal(got[:n - k + 1],
                                  _host_reference(codes, valid, k, canonical))
    assert (got[n - k + 1:] == SENTINEL).all()
