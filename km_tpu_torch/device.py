"""Devices and keys.

Devices are explicit: ``resolve_device('cuda')`` raises when no card is
present; nothing falls back to the CPU on its own.

A k-mer key is one int64 word: the 2-bit packed k-mer (k <= 31, leftmost
base highest, as km_tpu.ops.encode packs it), so every real key lies
below 2**62. The port's sentinel, for invalid windows and empty slots,
is ``2**63 - 1``; km_tpu's is the all-ones (hi, lo) uint32 pair, i.e.
2**64 - 1 as uint64. Both sort after every real key. The helpers here
carry keys between the two representations.
"""

from __future__ import annotations

import numpy as np
import torch

SENTINEL = (1 << 63) - 1
MAX_K = 31
_ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def resolve_device(name: str | torch.device) -> torch.device:
    """'cuda' (or 'cuda:N') or 'cpu' -> torch.device; raises when a CUDA
    device is asked for and none is present."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device %r requested but torch.cuda.is_available() is "
                "False" % str(name))
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError("device %r requested but only %d CUDA "
                               "device(s) present"
                               % (str(name), torch.cuda.device_count()))
    elif dev.type != "cpu":
        raise ValueError("unsupported device %r (use 'cuda' or 'cpu')"
                         % str(name))
    return dev


def check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError("k must be in 1..%d for int64 keys; got %d"
                         % (MAX_K, k))


def u64_to_i64(keys: np.ndarray) -> np.ndarray:
    """uint64 keys -> int64 words; km_tpu's all-ones sentinel becomes
    SENTINEL. Any other key at or above 2**63 is rejected."""
    keys = np.asarray(keys, dtype=np.uint64)
    sent = keys == _ALL_ONES
    if (keys[~sent] >= np.uint64(1 << 63)).any():
        raise ValueError("key at or above 2**63 cannot be an int64 key")
    out = keys.astype(np.int64)
    out[sent] = SENTINEL
    return out


def i64_to_u64(keys: np.ndarray) -> np.ndarray:
    """Inverse of u64_to_i64: SENTINEL becomes the all-ones word."""
    keys = np.asarray(keys, dtype=np.int64)
    out = keys.astype(np.uint64)
    out[keys == SENTINEL] = _ALL_ONES
    return out


def split_to_i64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """km_tpu (hi, lo) uint32 key pairs -> int64 words, with the
    all-ones pair mapped to SENTINEL."""
    joined = ((np.asarray(hi, np.uint64) << np.uint64(32))
              | np.asarray(lo, np.uint64))
    return u64_to_i64(joined)


def i64_to_split(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int64 words -> km_tpu (hi, lo) uint32 pairs (SENTINEL becomes the
    all-ones pair)."""
    u = i64_to_u64(keys)
    return ((u >> np.uint64(32)).astype(np.uint32),
            (u & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def to_device_keys(keys: np.ndarray, device) -> torch.Tensor:
    """uint64 host keys -> int64 tensor on ``device``."""
    return torch.from_numpy(u64_to_i64(keys)).to(device)


def to_host_keys(keys: torch.Tensor) -> np.ndarray:
    """int64 key tensor -> uint64 numpy keys."""
    return i64_to_u64(keys.cpu().numpy())
