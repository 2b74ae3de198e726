"""Chunk sort, with and without run detection.

``sort_chunks_runs`` launches ``csrc/sort_runs.cu`` for CUDA tensors and
runs ``sort_chunks_runs_plain`` for CPU tensors. It replaces km_tpu's
``pallas_sort.sort_chunks_runs`` (whose TPU chunk is 2^17 keys): keys
are sorted within independent CHUNK-sized chunks, each run's length is
written at its first position (0 elsewhere), and sentinel runs are 0.
A key that spans chunks yields one run per chunk; the merge downstream
sums them.

``sort_chunks`` is the same kernel without the run scan and without the
lengths output (plain version ``sort_chunks_plain``). It replaces
km_tpu's ``pallas_sort.sort_chunks``, which no counting path calls.
"""

from __future__ import annotations

import torch

from .. import _build
from ..device import SENTINEL

# 2^14 int64 keys = 128 KB: one chunk in the shared memory of one block
# (at most 227 KB on Hopper).
CHUNK = 1 << 14
MIN_CHUNK = 1 << 9  # one warp of 16-key segments


def _check_chunk(chunk: int) -> None:
    if not (MIN_CHUNK <= chunk <= CHUNK and chunk & (chunk - 1) == 0):
        raise ValueError("chunk must be a power of two in [%d, %d]; got %d"
                         % (MIN_CHUNK, CHUNK, chunk))


def _check_keys(keys: torch.Tensor, chunk: int) -> None:
    _check_chunk(chunk)
    if keys.dtype != torch.int64:
        raise TypeError("keys must be int64, got %s" % keys.dtype)
    if keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("keys must be 1-D and contiguous")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % keys.device)


def sort_chunks_runs(keys: torch.Tensor, chunk: int = CHUNK
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 keys [n] -> (keys sorted within each chunk, int32 run
    lengths at run starts). n need not be a multiple of chunk."""
    _check_keys(keys, chunk)
    if keys.device.type == "cpu":
        return sort_chunks_runs_plain(keys, chunk)
    out_keys = torch.empty_like(keys)
    out_len = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        code = _build.lib().km_sort_runs(
            keys.data_ptr(), keys.numel(), chunk, out_keys.data_ptr(),
            out_len.data_ptr(), _build.stream_ptr(keys.device))
    _build.check(code, "sort_runs")
    sort_chunks_runs.launches += 1
    return out_keys, out_len


sort_chunks_runs.launches = 0


def sort_chunks(keys: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """int64 keys [n] -> keys sorted within each chunk. n need not be a
    multiple of chunk."""
    _check_keys(keys, chunk)
    if keys.device.type == "cpu":
        return sort_chunks_plain(keys, chunk)
    out = torch.empty_like(keys)
    with torch.cuda.device(keys.device):
        code = _build.lib().km_sort_chunks(
            keys.data_ptr(), keys.numel(), chunk, out.data_ptr(),
            _build.stream_ptr(keys.device))
    _build.check(code, "sort_chunks")
    sort_chunks.launches += 1
    return out


sort_chunks.launches = 0


def runs_from_sorted_chunked(skeys: torch.Tensor, chunk: int) -> torch.Tensor:
    """Row-sorted [rows * chunk] keys -> int32 run lengths at run starts
    (km_tpu ops/count.py::runs_from_sorted_chunked, on int64 keys):
    the next run start after each position is a reverse cummin."""
    rows = skeys.view(-1, chunk)
    dev = skeys.device
    first = torch.ones_like(rows, dtype=torch.bool)
    first[:, 1:] = rows[:, 1:] != rows[:, :-1]
    pos = torch.arange(chunk, dtype=torch.int64, device=dev).expand_as(rows)
    idx = torch.where(first, pos, torch.full_like(pos, chunk))
    shifted = torch.cat([idx[:, 1:],
                         torch.full((rows.shape[0], 1), chunk,
                                    dtype=torch.int64, device=dev)], dim=1)
    nxt = torch.flip(torch.cummin(torch.flip(shifted, [1]), dim=1).values,
                     [1])
    lengths = torch.where(first, nxt - pos, torch.zeros_like(pos))
    return lengths.reshape(-1).to(torch.int32)


def _sorted_rows(keys: torch.Tensor, chunk: int) -> torch.Tensor:
    """Pad with the sentinel to whole chunks and sort each row."""
    pad = -keys.numel() % chunk
    padded = torch.cat([keys, torch.full((pad,), SENTINEL, dtype=torch.int64,
                                         device=keys.device)])
    return torch.sort(padded.view(-1, chunk), dim=1).values.reshape(-1)


def sort_chunks_plain(keys: torch.Tensor, chunk: int = CHUNK
                      ) -> torch.Tensor:
    """``sort_chunks``'s plain torch version: a per-row torch.sort."""
    return _sorted_rows(keys, chunk)[:keys.numel()].contiguous()


def sort_chunks_runs_plain(keys: torch.Tensor, chunk: int = CHUNK
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain torch version: pad with the sentinel to whole
    chunks, sort each row, detect runs, zero sentinel runs, cut back."""
    n = keys.numel()
    skeys = _sorted_rows(keys, chunk)
    lengths = runs_from_sorted_chunked(skeys, chunk)
    lengths = torch.where(skeys == SENTINEL, torch.zeros_like(lengths),
                          lengths)
    return skeys[:n].contiguous(), lengths[:n].contiguous()
