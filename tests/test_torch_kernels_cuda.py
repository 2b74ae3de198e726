"""The CUDA kernels against their plain torch versions, on a card.

These tests skip where there is no CUDA device. The machine with the
card has no JAX, and tests/conftest.py imports it, so run them there
from the repo root without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

import torch

from km_tpu.ops.count import count_batches_host

from km_tpu_torch.device import SENTINEL
from km_tpu_torch.ops import count, pack, sort_runs

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
