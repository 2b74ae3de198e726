"""Device-resident count table with batched lookups (torch).

Replaces km_tpu.ops.device_table. The table is the sorted int64 keys and
int64 counts on one device; a lookup is ``torch.searchsorted`` on the
keys. km_tpu's 2^16-entry prefix index, lockstep search rounds and
power-of-two padding served the TPU's gather cost and compile classes
and are not carried over; the answers are the same.

The child threshold ``max(sum_of_4 * ratio, n_cutoff)`` is computed in
float64, as km and the host spec do (km_tpu.models.table); km_tpu's
device kernel computes it in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import (check_k, resolve_device, to_device_keys,
                      u64_to_i64)


def _mask(bits: int) -> int:
    return (1 << bits) - 1


def revcomp(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of int64 keys (k <= 31): complement, reverse
    the 32 two-bit pairs, shift right by 64 - 2k. ``>>`` on int64 is
    arithmetic, so every right shift is masked."""
    x = ~keys
    for width, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                     (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        x = ((x >> width) & m) | ((x & m) << width)
    x = ((x >> 32) & _mask(32)) | (x << 32)
    return (x >> (64 - 2 * k)) & _mask(2 * k)


def canonical(keys: torch.Tensor, k: int) -> torch.Tensor:
    """min(key, revcomp(key)) for int64 keys."""
    return torch.minimum(keys, revcomp(keys, k))


def child_keys(keys: torch.Tensor, k: int, forward: bool = True
               ) -> torch.Tensor:
    """keys (...) -> the 4 extension candidates (..., 4) in A,C,G,T
    order (km_tpu.ops.encode.child_keys_forward/backward)."""
    ext = torch.arange(4, dtype=torch.int64, device=keys.device)
    if forward:
        return ((keys & _mask(2 * (k - 1))) << 2).unsqueeze(-1) | ext
    return (keys >> 2).unsqueeze(-1) | (ext << (2 * (k - 1)))


class DeviceCountTable:
    """Immutable sorted count table on one device."""

    def __init__(self, keys: np.ndarray, counts: np.ndarray, k: int,
                 canonical: bool, name: str = "", device="cuda"):
        check_k(k)
        self.device = resolve_device(device)
        keys = np.asarray(keys, dtype=np.uint64)
        order = np.argsort(keys, kind="stable")
        self.keys = torch.from_numpy(u64_to_i64(keys[order])).to(self.device)
        self.counts = torch.from_numpy(
            np.asarray(counts)[order].astype(np.int64)).to(self.device)
        self.k = int(k)
        self.canonical = bool(canonical)
        self.name = name
        self.n = len(keys)

    @classmethod
    def from_host(cls, table, device="cuda") -> "DeviceCountTable":
        """From a km_tpu.models.table.CountTable."""
        return cls(np.asarray(table.keys), np.asarray(table.counts),
                   table.k, table.canonical, name=table.name, device=device)

    def lookup(self, q: torch.Tensor) -> torch.Tensor:
        """int64 counts for int64 (possibly non-canonical) query keys."""
        if self.canonical:
            q = canonical(q, self.k)
        if self.n == 0:
            return torch.zeros_like(q)
        flat = q.reshape(-1).contiguous()
        pos = torch.searchsorted(self.keys, flat).clamp_(max=self.n - 1)
        hit = self.keys[pos] == flat
        out = torch.where(hit, self.counts[pos], torch.zeros_like(flat))
        return out.reshape(q.shape)

    def query_packed(self, keys: np.ndarray) -> np.ndarray:
        """Host convenience: uint64 queries -> int64 counts (numpy)."""
        keys = np.asarray(keys, dtype=np.uint64)
        if keys.size == 0:
            return np.zeros(keys.shape, dtype=np.int64)
        out = self.lookup(to_device_keys(keys, self.device))
        return out.cpu().numpy()

    def children(self, q: torch.Tensor, ratio: float, n_cutoff: int,
                 forward: bool = True):
        """Thresholded 4-way extension of int64 keys q (...): returns
        (child keys (..., 4), child counts (..., 4), mask (..., 4)); the
        mask marks children with count >= max(sum * ratio, n_cutoff),
        in float64 (km/utils/Jellyfish.py:55-72)."""
        ck = child_keys(q, self.k, forward=forward)
        cnt = self.lookup(ck)
        sums = cnt.sum(dim=-1, keepdim=True).to(torch.float64)
        thr = torch.clamp(sums * float(ratio), min=float(n_cutoff))
        return ck, cnt, cnt.to(torch.float64) >= thr
