"""Sliding-window k-mer pack + canonicalize + validity sentinel.

``pack_canonical_windows`` launches ``csrc/pack.cu`` for CUDA tensors and
runs ``pack_canonical_windows_plain`` for CPU tensors. It replaces
km_tpu's ``pallas_pack.pack_canonical_windows`` and the XLA spec beside
it (``ops/count.py::pack_windows_device`` + ``device_table.revcomp_split``
+ the window-valid cumsum); keys are one int64 word, so there is no
hi/lo split.
"""

from __future__ import annotations

import torch

from .. import _build
from ..device import SENTINEL, check_k
from .device_table import canonical as canonical_keys


def _check_inputs(codes: torch.Tensor, valid: torch.Tensor, k: int) -> None:
    check_k(k)
    if codes.dtype != torch.uint8:
        raise TypeError("codes must be uint8, got %s" % codes.dtype)
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError("valid must be bool or uint8, got %s" % valid.dtype)
    if codes.dim() != 1 or valid.shape != codes.shape:
        raise ValueError("codes and valid must be 1-D of one length; got "
                         "%s and %s" % (tuple(codes.shape),
                                        tuple(valid.shape)))
    if codes.device != valid.device:
        raise ValueError("codes on %s but valid on %s"
                         % (codes.device, valid.device))
    if not (codes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("codes and valid must be contiguous")


def pack_canonical_windows(codes: torch.Tensor, valid: torch.Tensor, k: int,
                           canonical: bool = True) -> torch.Tensor:
    """codes (uint8, 0..3) + valid (bool) of length n -> int64 keys [n]:
    the k-mer starting at each position (canonical if asked), SENTINEL
    where a base is invalid or the window runs off the end."""
    _check_inputs(codes, valid, k)
    if codes.device.type == "cpu":
        return pack_canonical_windows_plain(codes, valid, k, canonical)
    if codes.device.type != "cuda":
        raise ValueError("unsupported device %s" % codes.device)
    out = torch.empty(codes.shape, dtype=torch.int64, device=codes.device)
    with torch.cuda.device(codes.device):
        code = _build.lib().km_pack_windows(
            codes.data_ptr(), valid.data_ptr(), codes.numel(), k,
            int(canonical), out.data_ptr(), _build.stream_ptr(codes.device))
    _build.check(code, "pack_windows")
    pack_canonical_windows.launches += 1
    return out


pack_canonical_windows.launches = 0


def pack_canonical_windows_plain(codes: torch.Tensor, valid: torch.Tensor,
                                 k: int, canonical: bool = True
                                 ) -> torch.Tensor:
    """The kernel's plain torch version, step for step: shift-or pack of
    the k shifted code views, reverse complement by pair reversal, and
    the k-base validity from prefix-sum differences."""
    n = codes.numel()
    c = torch.cat([codes.to(torch.int64) & 3,
                   torch.zeros(k - 1, dtype=torch.int64,
                               device=codes.device)])
    key = torch.zeros(n, dtype=torch.int64, device=codes.device)
    for j in range(k):
        key = (key << 2) | c[j:j + n]
    if canonical:
        key = canonical_keys(key, k)
    v = torch.cat([valid.to(torch.int64),
                   torch.zeros(k - 1, dtype=torch.int64, device=codes.device)])
    cnt = torch.cat([torch.zeros(1, dtype=torch.int64, device=codes.device),
                     torch.cumsum(v, 0)])
    window_ok = (cnt[k:k + n] - cnt[:n]) == k
    return torch.where(window_ok, key, torch.full_like(key, SENTINEL))
