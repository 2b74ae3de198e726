"""The count's plain reference: every k-mer window of the reads, packed
and canonicalised in plain torch, counted with ``torch.unique``.

It reads the reads the benchmark generated (a [reads, length] tensor of
base codes 0..3, every base valid) and nothing the program made. On the
card it counts a sample of 2^30 bases (7.5e8 windows) in a few seconds.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_READS = 1 << 20


def window_keys(reads: torch.Tensor, k: int, canonical: bool
                ) -> torch.Tensor:
    """int64 key of every window of every read, read by read: the
    leftmost base in the highest bit pair; with ``canonical`` the lesser
    of the key and its reverse complement (A=0, C=1, G=2, T=3, so a
    base's complement is 3 - code)."""
    n, length = reads.shape
    w = length - k + 1
    parts = []
    for lo in range(0, n, BLOCK_READS):
        r = reads[lo:lo + BLOCK_READS].to(torch.int64)
        fw = torch.zeros((r.shape[0], w), dtype=torch.int64,
                         device=r.device)
        rc = torch.zeros_like(fw)
        for j in range(k):
            c = r[:, j:j + w]
            fw = (fw << 2) | c
            rc = rc | ((3 - c) << (2 * j))
        parts.append((torch.minimum(fw, rc) if canonical else fw)
                     .reshape(-1))
    return torch.cat(parts)


def count_reads(reads: torch.Tensor, k: int, canonical: bool,
                min_count: int):
    """(keys uint64, counts int64) ascending, the counts >= min_count,
    on the host; and the number of windows and of distinct keys."""
    keys = window_keys(reads, k, canonical)
    total = keys.numel()
    uk, cnt = torch.unique(keys, sorted=True, return_counts=True)
    del keys
    distinct = uk.numel()
    keep = cnt >= min_count
    uk, cnt = uk[keep].cpu().numpy(), cnt[keep].cpu().numpy()
    return uk.view(np.uint64), cnt.astype(np.int64), total, distinct


def table_mismatches(keys, counts, ref_keys, ref_counts) -> int:
    """Keys in one table only, plus common keys whose counts differ."""
    counts = np.asarray(counts).astype(np.int64)
    if len(keys) == len(ref_keys) and np.array_equal(keys, ref_keys):
        return int((counts != ref_counts).sum())
    _, ip, ir = np.intersect1d(keys, ref_keys, assume_unique=True,
                               return_indices=True)
    return (len(keys) - len(ip) + len(ref_keys) - len(ir)
            + int((counts[ip] != ref_counts[ir]).sum()))


def control_keep(n_reads: int, length: int, k: int, chunk: int,
                 device=None) -> torch.Tensor:
    """The control's break of one guarantee, every valid window counted
    once: the read stream (each read and one separator) cut into pieces
    of ``chunk`` positions with no k-1 overlap, so every window that
    spans a cut is lost. Returns the mask of windows kept, in
    ``window_keys``' order."""
    w = length - k + 1
    start = (torch.arange(n_reads, dtype=torch.int64,
                          device=device)[:, None] * (length + 1)
             + torch.arange(w, dtype=torch.int64, device=device))
    return (start // chunk == (start + k - 1) // chunk).reshape(-1)


def count_reads_control(reads: torch.Tensor, k: int, canonical: bool,
                        min_count: int, chunk: int):
    """``count_reads`` with the control's break (``control_keep``)."""
    keys = window_keys(reads, k, canonical)
    keys = keys[control_keep(*reads.shape, k, chunk, keys.device)]
    uk, cnt = torch.unique(keys, sorted=True, return_counts=True)
    keep = cnt >= min_count
    uk, cnt = uk[keep].cpu().numpy(), cnt[keep].cpu().numpy()
    return uk.view(np.uint64), cnt.astype(np.int64), keys.numel()
