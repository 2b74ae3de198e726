"""K-mer counting on the device: sort + merge of sorted runs, as in km_tpu.

Replaces the device half of km_tpu/ops/count.py (count_chunk_device,
sum_runs_device, merge_accum_device, count_batches_device_stream,
count_batches_device_compact). The host half (window_valid,
count_batches_host, merge_runs, chunk_stream, _coalesce_batches) is the
port's copy of km_tpu's numpy code, held equal to it by the CPU tests.

Per fixed-size chunk of read bases, uploaded as codes and flags:
  pack_canonical_windows (CUDA kernel)  -> one int64 key per position
  sort_chunks_runs (CUDA kernel)        -> keys sorted per 2^14-key chunk,
                                           run lengths at run starts
  chunk_runs (CUDA kernel)              -> the chunk's runs in key order
  merge_accum (CUDA kernel)             -> merged into a device-resident
                                           accumulator of C unique keys
and at the end of the stream:
  cut (CUDA kernel)                     -> the min_count cut, into the
                                           spare accumulator
The stream keeps two accumulators of C slots and merges each chunk from
one into the other, so the accumulator is never sorted again; at the
end only the kept records are read back, once. Each chunk's unique-key
count is read once the next chunk is parsed, before its upload (whose
wait covers the kernels anyway). A merge that overflowed C is thrown
away: the accumulator before it is copied into a pair of the smallest
doubling of C that holds the keys, and the chunk, still on the host,
is counted again into it. The input is read once.

Two defects of km_tpu's stream are not reproduced:
- run totals are exact (differences of an int64 prefix sum, no
  ``max_run`` bound that can undercount);
- every chunk's unique-key count is checked, so an overflow that
  truncated keys grows the accumulator even when a later chunk brings
  no new key (km_tpu checks only the last and returns a truncated
  table).

``count_batches_device_compact`` (``count --mode chunked``) keeps no
accumulator on the device: each chunk's runs are summed there, read back
and merged on the host, so there is no capacity to size and the input is
never read twice.

Not carried over from km_tpu's compact path: ``pack2_host`` /
``unpack2_device`` (2-bit packing of the upload, which served a narrow
host link; codes and flags go up as they are) and ``_drain_compact``'s
power-of-two pad of the readback (it bounded the number of compiled
slice programs; a tensor slice compiles nothing in torch, so exactly the
live runs cross).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import native
from ..device import SENTINEL, check_k, resolve_device
from ..utils import profiling
from . import encode
from .merge import chunk_runs, cut, merge_accum, tally
from .pack import pack_canonical_windows
from .sort_runs import CHUNK, sort_chunks_runs

# ---------------------------------------------------------------------------
# host (numpy) spec


def window_valid(valid: np.ndarray, k: int) -> np.ndarray:
    """valid[i:i+k].all() for every window, via prefix sums."""
    cnt = np.concatenate([[0], np.cumsum(valid.astype(np.int64))])
    return (cnt[k:] - cnt[:-k]) == k


def count_batches_host(batches, k: int, canonical: bool = True,
                       min_count: int = 1):
    """Count k-mers over (codes, valid) batches on the host."""
    acc_keys = np.empty(0, dtype=np.uint64)
    acc_counts = np.empty(0, dtype=np.int64)
    for codes, valid in batches:
        if codes.size < k:
            continue
        keys = encode.pack_code_windows(codes, k)
        keys = keys[window_valid(valid, k)]
        if canonical:
            keys = encode.canonical(keys, k)
        uk, uc = np.unique(keys, return_counts=True)
        acc_keys, acc_counts = merge_runs(acc_keys, acc_counts, uk, uc)
    keep = acc_counts >= min_count
    return acc_keys[keep], acc_counts[keep].astype(np.uint32)


def merge_runs(k1, c1, k2, c2):
    """Merge two sorted (key, count) runs, summing duplicate keys.
    Duplicates *within* either run are collapsed too (the Pallas chunk
    sort emits per-sort-chunk runs, so a key spanning chunks appears as
    adjacent duplicates in one compacted device readback)."""
    keys = np.concatenate([k1, k2])
    counts = np.concatenate([c1.astype(np.int64), c2.astype(np.int64)])
    if not len(keys):
        return keys, counts
    order = np.argsort(keys, kind="stable")
    keys, counts = keys[order], counts[order]
    new_run = np.empty(len(keys), dtype=bool)
    new_run[0] = True
    new_run[1:] = keys[1:] != keys[:-1]
    run_id = np.cumsum(new_run) - 1
    out_keys = keys[new_run]
    out_counts = np.zeros(len(out_keys), dtype=np.int64)
    np.add.at(out_counts, run_id, counts)
    return out_keys, out_counts


def chunk_stream(batches, chunk: int, k: int):
    """Re-chunk (codes, valid) batches into fixed ``chunk``-length pieces
    overlapping by k-1 bases, so the pieces' windows exactly tile the
    stream's windows (no boundary k-mer lost, none double-counted).
    Trailing space is padded with invalid positions."""
    stride = chunk - k + 1
    assert stride > 0, "chunk must exceed k"
    for codes, valid in batches:
        n_windows = codes.size - k + 1
        if n_windows <= 0:
            continue
        for off in range(0, n_windows, stride):
            c = codes[off:off + chunk]
            v = valid[off:off + chunk]
            if c.size < chunk:
                pad = chunk - c.size
                c = np.concatenate([c, np.zeros(pad, np.uint8)])
                v = np.concatenate([v, np.zeros(pad, bool)])
            yield c, v


def _coalesce_batches(batches, k: int, min_len: int):
    """Concatenate input batches into >= min_len slabs, separated by
    k-1 invalid positions so no window spans two batches. Without this,
    chunk_stream pads every (often small) batch to a full chunk and the
    device counts mostly padding."""
    sep_c = np.zeros(k - 1, np.uint8)
    sep_v = np.zeros(k - 1, bool)
    parts: list = []
    total = 0
    for codes, valid in batches:
        if parts:
            parts.append((sep_c, sep_v))
            total += k - 1
        parts.append((codes, valid))
        total += len(codes)
        if total >= min_len:
            yield (np.concatenate([p[0] for p in parts]),
                   np.concatenate([p[1] for p in parts]))
            parts, total = [], 0
    if parts:
        yield (np.concatenate([p[0] for p in parts]),
               np.concatenate([p[1] for p in parts]))


# ---------------------------------------------------------------------------
# device (torch) implementation


class CountCapacityOverflow(RuntimeError):
    """An accumulator of fixed capacity was exceeded (``scale_count``);
    retry with a larger ``capacity``."""

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
    an int64 index_add_. The sharded exchange sums the runs it receives
    with it: they come from every rank at once and keep no order that
    ``chunk_runs`` could use."""
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


def empty_accumulator(C: int, device
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(keys [C] of SENTINEL, counts [C] of 0, live length 0 as a 0-d
    int64 tensor) on device."""
    return (torch.full((C,), SENTINEL, dtype=torch.int64, device=device),
            torch.zeros(C, dtype=torch.int64, device=device),
            torch.zeros((), dtype=torch.int64, device=device))


def merge_accum_device(acc, keys: torch.Tensor, lengths: torch.Tensor, out,
                       sort_chunk: int = CHUNK):
    """Merge one chunk's sort output (keys sorted within sort_chunk
    pieces, int32 run lengths at run starts, 0 elsewhere) into the
    accumulator ``acc``.

    acc and out are accumulator triples of one capacity C (keys [C],
    counts [C], live length as a 0-d int64 tensor), as
    ``empty_accumulator`` makes them and this function leaves them:
    ascending unique keys, then SENTINEL padding with count 0. The
    chunk's runs are put in key order (``chunk_runs``) and merged into
    ``out``, which must not be ``acc``. Returns out, whose live length
    is the number of unique keys; more than C means the result was
    truncated to the first C keys."""
    run_keys, run_cnt, m = chunk_runs(keys, lengths, sort_chunk)
    merge_accum(*acc, run_keys, run_cnt, m, *out)
    return out


def _input(chunks):
    """Yield from the chunk stream, each step the span ``count.input``
    (the files read and parsed, batches joined, a chunk cut)."""
    while True:
        with profiling.phase("count.input"):
            item = next(chunks, None)
        if item is None:
            return
        yield item


def _upload(codes: np.ndarray, valid: np.ndarray, dev: torch.device):
    """A chunk's codes and flags on ``dev``: the span ``count.upload``."""
    with profiling.phase("count.upload"):
        return torch.from_numpy(codes).to(dev), torch.from_numpy(valid).to(dev)


def cut_readback(acc, spare, min_count: int, counters=None):
    """The end of a stream count: the accumulator ``acc`` cut at
    ``min_count`` on its device into ``spare``, whose contents are
    dead by then (span ``count.cut``: the launch and the one wait on
    it, a read of three numbers and of ``counters``, a 1-d int64 tensor
    on the same device, if given), then the kept records read back
    (span ``count.readback``). Returns (keys uint64, counts uint32,
    kept, total, unique, *counters' values): total sums every live
    count, before the cut; unique is the accumulator's live length.
    ``spare`` no longer holds an accumulator afterwards."""
    keys, counts, n = acc
    out_keys, out_cnt = spare[0], spare[1].view(torch.int32)
    with profiling.phase("count.cut"):
        numbers = cut(keys, counts, n, min_count, out_keys, out_cnt)
        if counters is not None:
            numbers = torch.cat((numbers, counters))
        kept, total, unique, *rest = numbers.tolist()
    with profiling.phase("count.readback"):
        host_keys = out_keys[:kept].to("cpu", copy=True).numpy()
        host_cnt = out_cnt[:kept].to("cpu", copy=True).numpy()
    return (host_keys.view(np.uint64), host_cnt.view(np.uint32), kept,
            total, unique, *rest)


def _widened(acc, C: int):
    """Accumulator ``acc`` copied into C slots, at least its own: its
    keys, counts and live length, then SENTINEL and 0."""
    keys, counts, n = acc
    out = empty_accumulator(C, keys.device)
    out[0][:keys.numel()].copy_(keys)
    out[1][:counts.numel()].copy_(counts)
    out[2].copy_(n)
    return out


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

    ``capacity`` is the accumulator's first: a chunk whose merge
    overflows it is merged again, from the accumulator before it, into
    a pair grown to the smallest doubling that holds the keys (the
    growth). The old pair is freed before the new spare is allocated,
    so the device's peak is that of a count started at the final
    capacity. The input is read once.

    The min_count cut runs on the device into the spare accumulator
    (``cut_readback``), so only the kept records are read back.

    ``stats``, a dict, receives the chunk count, the final capacity,
    the growths (``grows``), the unique keys before the min_count cut,
    their count total, the records kept by the cut and read back
    (``kept``), M1's runs summed over the chunks (``runs``: each chunk's
    distinct keys, a chunk counted again by a growth once) and the
    bucket rounds M1 took beyond one a bucket (``m1_rounds``; 0 on CPU
    tensors), these two counted on the device and read in the finish's
    one wait; and under ``span_s`` (name -> seconds) it adds the seconds
    of every span that closed inside the call: ``count.input``,
    ``count.upload``, ``count.grow`` (a growth: the copy, the frees and
    the chunk counted again; absent where none ran), ``count.cut`` (the
    cut on the device and the wait on it) and ``count.readback`` (the
    kept records read back)."""
    check_k(k)
    if chunk <= k:
        raise ValueError("chunk must exceed k")
    if capacity <= 0:
        raise ValueError("capacity must be > 0")
    dev = resolve_device(device)
    C = capacity
    grows = n_chunks = 0
    span_s = {} if stats is None else stats.setdefault("span_s", {})
    with profiling.collect(span_s):
        # the chunk merges from one accumulator into the other, then
        # they swap
        acc, spare = empty_accumulator(C, dev), empty_accumulator(C, dev)
        # M1's runs and extra bucket rounds, summed over the chunks
        counters = torch.zeros(2, dtype=torch.int64, device=dev)

        def merge(codes, valid):
            nonlocal acc, spare
            rkeys, rlen = count_chunk_device(
                *_upload(codes, valid, dev), k, canonical=canonical,
                sort_chunk=sort_chunk)
            acc, spare = merge_accum_device(acc, rkeys, rlen, spare,
                                            sort_chunk=sort_chunk), acc

        def fit(codes, valid):
            """Grow if the merge of (codes, valid), the last chunk
            merged, overflowed C; spare still holds the accumulator that
            merge read."""
            nonlocal acc, spare, C, grows
            n = int(acc[2])
            if n <= C:
                return
            with profiling.phase("count.grow"):
                while C < n:
                    C *= 2
                acc = _widened(spare, C)
                spare = None  # freed before its successor is allocated
                spare = empty_accumulator(C, dev)
                # the tally holds the chunk's runs already
                with tally(torch.zeros(2, dtype=torch.int64, device=dev)):
                    merge(codes, valid)
            grows += 1

        last = None
        chunks = chunk_stream(_coalesce_batches(batches, k, 4 * chunk),
                              chunk, k)
        with tally(counters):
            for codes, valid in _input(chunks):
                # the last chunk's kernels ran while this one was
                # parsed, and the upload below would wait for them too
                if last is not None:
                    fit(*last)
                merge(codes, valid)
                last = codes, valid
                n_chunks += 1
            if last is not None:
                fit(*last)

        keys, cnt, kept, total, nu, runs, rounds = cut_readback(
            acc, spare, min_count, counters)
    if stats is not None:
        stats.update(chunks=n_chunks, capacity=C, grows=grows, unique=nu,
                     total=total, kept=kept, runs=runs, m1_rounds=rounds)
    return keys, cnt


def chunk_runs_device(codes: torch.Tensor, valid: torch.Tensor, k: int,
                      canonical: bool = True, sort_chunk: int = CHUNK
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk's (key, count) runs in global key order: (int64 keys
    ascending and distinct, int64 counts > 0), on the chunk's device.

    The chunk sort orders keys only within sort_chunk-sized pieces, and a
    host k-way merge needs each run sorted as a whole, so ``chunk_runs``
    merges the pieces' live run starts; a key that spans pieces is summed
    there, which also makes the readback as small as it can be."""
    keys, lengths = count_chunk_device(codes, valid, k, canonical=canonical,
                                       sort_chunk=sort_chunk)
    run_keys, run_cnt, m = chunk_runs(keys, lengths, sort_chunk)
    m = int(m)
    return run_keys[:m], run_cnt[:m]


class _RunReadback:
    """Device runs -> host (keys uint64, counts int64), two chunks in
    flight. On a card each chunk's runs are copied into one of two pinned
    staging buffers without blocking and an event marks the copy's end;
    the buffer is read only after its event, and reused only after it was
    read (chunk i + 2 takes chunk i's buffer)."""

    def __init__(self, device: torch.device, cap: int):
        self.cuda = device.type == "cuda"
        self.pending: list = []
        self.runs: list[tuple[np.ndarray, np.ndarray]] = []
        self.bytes = 0
        self.n = 0
        if self.cuda:
            self.staging = [torch.empty((2, cap), dtype=torch.int64,
                                        pin_memory=True) for _ in range(2)]

    def push(self, keys: torch.Tensor, counts: torch.Tensor) -> None:
        m = keys.numel()
        if self.cuda:
            buf = self.staging[self.n % 2]
            buf[0, :m].copy_(keys, non_blocking=True)
            buf[1, :m].copy_(counts, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self.pending.append((buf, m, done))
        else:
            self.pending.append((torch.stack([keys, counts]), m, None))
        self.n += 1
        if len(self.pending) >= 2:
            self._drain()

    def _drain(self) -> None:
        buf, m, done = self.pending.pop(0)
        if done is not None:
            done.synchronize()
        self.bytes += 2 * 8 * m
        if m:
            # real keys lie below 2**62 and SENTINEL runs were dropped on
            # the device, so the int64 words are the uint64 keys, in order
            host = buf[:, :m].numpy().copy()
            self.runs.append((host[0].view(np.uint64), host[1]))

    def finish(self) -> list[tuple[np.ndarray, np.ndarray]]:
        while self.pending:
            self._drain()
        return self.runs


def _merge_all(runs):
    """Sorted (keys uint64, counts int64) runs -> one (keys, counts) with
    duplicate keys summed: one native k-way merge, or the numpy pairwise
    merge, started from empty, where the native library is absent."""
    if native.available():
        return native.merge_sorted_runs(runs)
    acc = (np.empty(0, np.uint64), np.empty(0, np.int64))
    for rk, rc in runs:
        acc = merge_runs(acc[0], acc[1], rk, rc)
    return acc


def count_batches_device_compact(batches, k: int, canonical: bool = True,
                                 min_count: int = 1, chunk: int = 1 << 24,
                                 device="cuda", sort_chunk: int = CHUNK,
                                 stats=None):
    """File -> table counting with no accumulator on the device
    (``count --mode chunked``): per chunk, the runs are summed on the
    device (chunk_runs_device) and only they are read back; all chunks'
    runs merge on the host at the end. There is no capacity to overflow,
    so the input is read once; the runs wait in host memory (16 bytes
    each) until the merge. Returns (keys uint64, counts uint32), equal to
    every other counting path's.

    ``stats``, a dict, receives the chunks, the runs and bytes read back,
    the host seconds spent merging (``merge_s``), the launches of the
    two kernels, and under ``span_s`` the seconds of the spans
    ``count.input`` and ``count.upload``, as the stream's."""
    check_k(k)
    if chunk <= k:
        raise ValueError("chunk must exceed k")
    dev = resolve_device(device)
    launches0 = (pack_canonical_windows.launches, sort_chunks_runs.launches)
    readback = _RunReadback(dev, chunk)
    chunks = chunk_stream(_coalesce_batches(batches, k, 4 * chunk), chunk, k)
    span_s = {} if stats is None else stats.setdefault("span_s", {})
    with profiling.collect(span_s):
        for codes, valid in _input(chunks):
            readback.push(*chunk_runs_device(
                *_upload(codes, valid, dev), k, canonical=canonical,
                sort_chunk=sort_chunk))
    runs = readback.finish()

    t0 = time.perf_counter()
    if runs:
        keys, cnt = _merge_all(runs)
    else:
        keys, cnt = np.empty(0, np.uint64), np.empty(0, np.int64)
    merge_s = time.perf_counter() - t0
    if stats is not None:
        stats.update(
            chunks=readback.n, runs=sum(len(r[0]) for r in runs),
            readback_bytes=readback.bytes, unique=len(keys),
            total=int(cnt.sum()), merge_s=merge_s,
            pack_launches=pack_canonical_windows.launches - launches0[0],
            sort_runs_launches=sort_chunks_runs.launches - launches0[1])
    keep = cnt >= min_count
    return keys[keep], cnt[keep].astype(np.uint32)

