"""K-mer counting on the device: sort + segment sum, as in km_tpu.

Replaces the device half of km_tpu/ops/count.py (count_chunk_device,
sum_runs_device, merge_accum_device, count_batches_device_stream). The
host half (count_batches_host, chunk_stream, merge_runs) is km_tpu's
own and is imported, not copied.

Per fixed-size chunk of read bases, uploaded as codes and flags:
  pack_canonical_windows (CUDA kernel)  -> one int64 key per position
  sort_chunks_runs (CUDA kernel)        -> keys sorted per 2^14-key chunk,
                                           run lengths at run starts
  merge_accum_device (torch)            -> merged into a device-resident
                                           accumulator of C unique keys
The accumulator is read back once, at the end.

Two defects of km_tpu's stream are not reproduced:
- run totals are exact segment sums (sort, run ids by cumsum, int64
  index_add_), so no ``max_run`` bound can undercount;
- the overflow check reads a running maximum of the unique-key count,
  so an overflow that truncated keys raises even when a later chunk
  brings no new key.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from km_tpu.ops.count import _coalesce_batches, chunk_stream

from ..device import SENTINEL, check_k, i64_to_u64, resolve_device
from .pack import pack_canonical_windows
from .sort_runs import CHUNK, sort_chunks_runs

# the running maximum is read every this many chunks, and at the end
OVERFLOW_CHECK_EVERY = 16


class CountCapacityOverflow(RuntimeError):
    """The streaming accumulator's capacity was exceeded; retry with a
    larger ``capacity``."""

    def __init__(self, capacity: int):
        super().__init__(f"count accumulator capacity {capacity} "
                         f"exceeded; retry with a larger capacity")
        self.capacity = capacity


def count_chunk_device(codes: torch.Tensor, valid: torch.Tensor, k: int,
                       canonical: bool = True, sort_chunk: int = CHUNK
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """codes uint8 [n] + valid bool [n] -> (int64 keys sorted within
    sort_chunk-sized chunks, int32 run lengths at run starts). Invalid
    and off-the-end windows carry SENTINEL, whose runs are 0."""
    keys = pack_canonical_windows(codes, valid, k, canonical)
    return sort_chunks_runs(keys, chunk=sort_chunk)


def sum_runs_device(keys: torch.Tensor, counts: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unsorted (key, count) records -> (sorted keys, each key's summed
    int64 count at its run start, 0 elsewhere). Exact for any run
    length: run ids come from a cumsum over run starts and totals from
    an int64 index_add_. (A reverse-cummin formulation with no atomics
    measured 4x slower on the card.)"""
    skeys, order = torch.sort(keys)
    scnt = counts.to(torch.int64)[order]
    n = skeys.numel()
    new_run = torch.ones(n, dtype=torch.bool, device=keys.device)
    new_run[1:] = skeys[1:] != skeys[:-1]
    run_id = torch.cumsum(new_run, 0) - 1
    totals = torch.zeros(n, dtype=torch.int64, device=keys.device)
    totals.index_add_(0, run_id, scnt)
    return skeys, torch.where(new_run, totals[run_id],
                              torch.zeros_like(totals))


def merge_accum_device(acc_keys: torch.Tensor, acc_cnt: torch.Tensor,
                       keys: torch.Tensor, counts: torch.Tensor, C: int):
    """Merge (key, count) runs into the accumulator of capacity C.

    The accumulator holds up to C unique keys in ascending order, then
    SENTINEL padding with count 0. Entries with count 0 are keyed to
    SENTINEL, all records are summed per key, and the survivors are
    compacted to the front in key order. Returns (keys [C], counts [C],
    n_unique); n_unique > C means the result was truncated."""
    dev = acc_keys.device
    k = torch.cat([acc_keys, keys])
    c = torch.cat([acc_cnt, counts.to(torch.int64)])
    k = torch.where(c == 0, torch.full_like(k, SENTINEL), k)
    skeys, tot = sum_runs_device(k, c)
    alive = (tot > 0) & (skeys != SENTINEL)
    dest = torch.cumsum(alive, 0) - 1
    # survivors past C, and the dead, go to a trash slot at index C
    slot = torch.where(alive & (dest < C), dest, torch.full_like(dest, C))
    out_keys = torch.full((C + 1,), SENTINEL, dtype=torch.int64, device=dev)
    out_cnt = torch.zeros(C + 1, dtype=torch.int64, device=dev)
    out_keys.scatter_(0, slot, skeys)
    out_cnt.scatter_(0, slot, tot)
    return out_keys[:C], out_cnt[:C], alive.sum()


def empty_accumulator(C: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.full((C,), SENTINEL, dtype=torch.int64, device=device),
            torch.zeros(C, dtype=torch.int64, device=device))


def _timed(gen, spent: list):
    """Yield from gen, adding the seconds spent inside it to spent[0]."""
    while True:
        t0 = time.perf_counter()
        item = next(gen, None)
        spent[0] += time.perf_counter() - t0
        if item is None:
            return
        yield item


def count_batches_device_stream(batches, k: int, canonical: bool = True,
                                min_count: int = 1, chunk: int = 1 << 24,
                                capacity: int = 1 << 22, device="cuda",
                                sort_chunk: int = CHUNK, stats=None):
    """Stream (codes, valid) host batches through the device counter
    into one device-resident accumulator; read it back once. Returns
    (keys uint64, counts uint32) like km_tpu's count_batches_host.

    Batches are joined into slabs of at least 4 chunks (k-1 invalid
    bases between batches, so no window spans two) before they are cut
    into chunks that overlap by k-1 bases, so chunks are full.

    On overflow the work is discarded and CountCapacityOverflow raised:
    the input is a one-shot generator, so the caller re-reads it with a
    larger capacity (tools/count.py). ``stats``, a dict, receives the
    chunk count, the capacity, the unique keys before the min_count cut,
    their count total, and the host seconds spent reading the input."""
    check_k(k)
    if chunk <= k:
        raise ValueError("chunk must exceed k")
    dev = resolve_device(device)
    C = capacity
    acc_keys, acc_cnt = empty_accumulator(C, dev)
    n_unique = torch.zeros((), dtype=torch.int64, device=dev)
    max_unique = n_unique.clone()
    n_chunks = 0
    input_s = [0.0]
    chunks = chunk_stream(_coalesce_batches(batches, k, 4 * chunk), chunk, k)
    for codes, valid in _timed(chunks, input_s):
        rkeys, rlen = count_chunk_device(
            torch.from_numpy(codes).to(dev), torch.from_numpy(valid).to(dev),
            k, canonical=canonical, sort_chunk=sort_chunk)
        acc_keys, acc_cnt, n_unique = merge_accum_device(
            acc_keys, acc_cnt, rkeys, rlen, C)
        torch.maximum(max_unique, n_unique, out=max_unique)
        n_chunks += 1
        if n_chunks % OVERFLOW_CHECK_EVERY == 0 and int(max_unique) > C:
            raise CountCapacityOverflow(C)
    if int(max_unique) > C:
        raise CountCapacityOverflow(C)

    nu = int(n_unique)
    keys = acc_keys[:nu].cpu().numpy()
    cnt = acc_cnt[:nu].cpu().numpy()
    if stats is not None:
        stats.update(chunks=n_chunks, capacity=C, unique=nu,
                     total=int(cnt.sum()), input_s=input_s[0])
    keep = cnt >= min_count
    return i64_to_u64(keys[keep]), cnt[keep].astype(np.uint32)
