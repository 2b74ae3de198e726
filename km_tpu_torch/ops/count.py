"""K-mer counting on the device: sort + merge of sorted runs, as in km_tpu.

Replaces the device half of km_tpu/ops/count.py (count_chunk_device,
sum_runs_device, merge_accum_device, count_batches_device_stream,
count_batches_device_compact). The host half (window_valid,
count_batches_host, merge_runs, chunk_stream, _coalesce_batches) is the
port's copy of km_tpu's numpy code, held equal to it by the CPU tests.

Per fixed-size chunk of read bases, uploaded as codes and flags (or, in
``count_fastq_device_stream``, as FASTQ text that the card parses):
  parse_fastq (CUDA kernel, P1)         -> the text's codes and flags
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
is counted again into it. The input is read once. A FASTQ count on a
card reads each file into pinned memory in blocks of whole records and
uploads the text; P1 turns it into the chunk on the card, so the host
neither parses nor joins (``count_fastq_device_stream``).

Two defects of km_tpu's stream are not reproduced:
- run totals are exact (differences of an int64 prefix sum, no
  ``max_run`` bound that can undercount);
- every chunk's unique-key count is checked, so an overflow that
  truncated keys grows the accumulator even when a later chunk brings
  no new key (km_tpu checks only the last and returns a truncated
  table).

``count_batches_device_compact`` (``count --mode chunked``, jellyfish's
``--disk`` count) runs the same loop under a ceiling: the accumulator
grows up to it, and a merge that overflows it is dumped instead. The
accumulator before that merge is read back as one sorted piece (through
two pinned staging buffers, ``_read_staged``), the pair is emptied and
the chunk counted again into it; at the end the last
accumulator is read back too, and the pieces are merged on the host,
where the ``min_count`` cut is made on the merged counts. Host memory
holds the pieces, not every chunk's runs.

Not carried over from km_tpu's compact path: ``pack2_host`` /
``unpack2_device`` (2-bit packing of the upload, which served a narrow
host link; codes and flags go up as they are) and ``_drain_compact``'s
power-of-two pad of the readback (it bounded the number of compiled
slice programs; a tensor slice compiles nothing in torch, so exactly the
live runs cross).
"""

from __future__ import annotations

import functools
import gzip
import itertools
import os

import numpy as np
import torch

from .. import native
from ..device import SENTINEL, check_k, resolve_device
from ..utils import profiling
from . import encode, parse
from .merge import chunk_runs, cut, merge_accum, tally
from .pack import pack_canonical_windows
from .parse import AT, NEWLINE, PLUS
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


# bytes a staging buffer of ``_read_staged`` holds
SLAB_BYTES = 1 << 26


def _read_staged(src: torch.Tensor, dest: np.ndarray) -> None:
    """The first ``len(dest)`` elements of the 1-d tensor ``src`` copied
    into ``dest``, a host array of its dtype, slab by slab through two
    staging buffers of SLAB_BYTES (pinned where ``src`` is on a card):
    while slab i+1 is read from the card into one buffer, slab i is
    copied out of the other into ``dest`` on torch's host threads, so the
    fresh destination's first-touch faults spread over them. A buffer is
    refilled only after its last slab was copied out, in host order."""
    n = len(dest)
    cuda = src.device.type == "cuda"
    step = SLAB_BYTES // src.element_size()
    bufs = [torch.empty(step, dtype=src.dtype, pin_memory=cuda)
            for _ in range(2)]
    out = torch.from_numpy(dest)
    ready = [None, None]  # the event after a buffer's fill

    def fill(lo: int) -> None:
        b = lo // step % 2
        hi = min(lo + step, n)
        bufs[b][:hi - lo].copy_(src[lo:hi], non_blocking=True)
        if cuda:
            ready[b] = torch.cuda.Event()
            ready[b].record()

    fill(0)
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        if hi < n:
            fill(hi)
        b = lo // step % 2
        if cuda:
            ready[b].synchronize()
        out[lo:hi].copy_(bufs[b][:hi - lo])


def _read_piece(acc, out):
    """Accumulator ``acc`` read back whole as one sorted piece of a
    capped count: C1 at ``min_count`` 1 into ``out``'s slots, whose
    contents are dead, then its records copied to the host through the
    staging pair (``_read_staged``). Returns (keys uint64, counts uint32,
    the sum of its counts)."""
    out_cnt = out[1].view(torch.int32)
    kept, total, _ = cut(*acc, 1, out[0], out_cnt).tolist()
    keys = np.empty(kept, np.int64)
    cnt = np.empty(kept, np.int32)
    _read_staged(out[0], keys)
    _read_staged(out_cnt, cnt)
    return keys.view(np.uint64), cnt.view(np.uint32), total


def _merge_pieces(pieces, min_count: int):
    """The pieces of a capped count merged on the host, cut at
    ``min_count`` on the merged counts: (keys uint64, counts uint32, the
    number of distinct keys). One native k-way merge, or numpy's sort
    where the native library is absent."""
    if native.available():
        return native.merge_pieces(pieces, min_count)
    keys, cnt = merge_runs(np.concatenate([k for k, _ in pieces]),
                           np.concatenate([c for _, c in pieces]),
                           np.empty(0, np.uint64), np.empty(0, np.int64))
    keep = cnt >= min_count
    return keys[keep], cnt[keep].astype(np.uint32), len(keys)


def _stream(chunks, k: int, canonical: bool, min_count: int, capacity: int,
            dev: torch.device, sort_chunk: int, stats, counters=None,
            ceiling: int | None = None):
    """The stream's accumulator loop. ``chunks`` yields callables, each of
    which puts one chunk's (codes, valid) on ``dev`` (the input, read
    while the card counts the chunk before it) and is called again by a
    growth or a dump. Returns the keys and counts kept at ``min_count``,
    and fills ``stats`` as ``count_batches_device_stream`` and
    ``count_batches_device_compact`` say.

    Each chunk's live length is read once the next chunk is in, before it
    goes up: a merge that overflowed C is thrown away, the accumulator
    before it is copied into a pair of the smallest doubling of C that
    holds the keys, and the chunk is counted again into it.

    With a ``ceiling`` (at least the chunk, so a chunk's runs fit an
    empty pair of it), C grows no further than it: a merge whose keys
    exceed it is dumped instead (span ``count.dump``). The accumulator
    before the merge is read back as one sorted piece, the pair is
    emptied at the ceiling and the chunk counted again into it. After a
    dump the finish reads the last accumulator back whole too, and the
    pieces are merged and cut on the host (span ``count.host_merge``).

    ``counters``, int64 on ``dev``: [0] and [1] take M1's runs and extra
    bucket rounds, summed over the chunks; a third element, where given,
    is the input's flag of broken text, read in the same wait (one
    allocation for all three, so the input's flag adds nothing to the
    device's peak)."""
    C = capacity if ceiling is None else min(capacity, ceiling)
    grows = n_chunks = 0
    pieces: list = []  # the dumps, (keys uint64, counts uint32) each
    dumped_total = staged = 0
    # the chunk merges from one accumulator into the other, then they swap
    acc, spare = empty_accumulator(C, dev), empty_accumulator(C, dev)
    if counters is None:
        counters = torch.zeros(2, dtype=torch.int64, device=dev)
    bad = counters[2:]

    def merge(chunk):
        nonlocal acc, spare
        rkeys, rlen = count_chunk_device(*chunk(), k, canonical=canonical,
                                         sort_chunk=sort_chunk)
        acc, spare = merge_accum_device(acc, rkeys, rlen, spare,
                                        sort_chunk=sort_chunk), acc

    def fit(chunk):
        """Grow, or dump at the ceiling, if the merge of ``chunk``, the
        last merged, overflowed C; spare still holds the accumulator that
        merge read."""
        nonlocal acc, spare, C, grows, dumped_total, staged
        if not bad.numel():
            n = int(acc[2])
        else:
            n, broken = torch.cat((acc[2].view(1), bad)).tolist()
            if broken:
                raise ValueError("malformed FASTQ record")
        if n <= C:
            return
        if ceiling is not None and n > ceiling:
            with profiling.phase("count.dump"):
                keys, cnt, total = _read_piece(spare, acc)
                pieces.append((keys, cnt))
                dumped_total += total
                staged += keys.nbytes + cnt.nbytes
                acc = spare = None  # freed before the emptied pair
                C = ceiling
                acc = empty_accumulator(C, dev)
                spare = empty_accumulator(C, dev)
                with tally(torch.zeros(2, dtype=torch.int64, device=dev)):
                    merge(chunk)
            return
        with profiling.phase("count.grow"):
            while C < n:
                C *= 2
            if ceiling is not None:
                C = min(C, ceiling)
            acc = _widened(spare, C)
            spare = None  # freed before its successor is allocated
            spare = empty_accumulator(C, dev)
            # the tally holds the chunk's runs already
            with tally(torch.zeros(2, dtype=torch.int64, device=dev)):
                merge(chunk)
        grows += 1

    last = None
    with tally(counters[:2]):
        for chunk in chunks:
            # the last chunk's kernels ran while this one was read, and
            # its upload would wait for them too
            if last is not None:
                fit(last)
            merge(chunk)
            last = chunk
            n_chunks += 1
        if last is not None:
            fit(last)

    n_dumps, dumped = len(pieces), sum(len(p[0]) for p in pieces)
    keys, cnt, kept, total, nu, runs, rounds = cut_readback(
        acc, spare, 1 if n_dumps else min_count, counters[:2])
    if n_dumps:
        with profiling.phase("count.host_merge"):
            pieces.append((keys, cnt))
            keys, cnt, nu = _merge_pieces(pieces, min_count)
        kept, total = len(keys), total + dumped_total
    if stats is not None:
        stats.update(chunks=n_chunks, capacity=C, grows=grows, unique=nu,
                     total=total, kept=kept, runs=runs, m1_rounds=rounds)
        if ceiling is not None:
            stats.update(ceiling=ceiling, dumps=n_dumps, dumped=dumped,
                         dump_staged_bytes=staged)
    return keys, cnt


def _check_stream(k: int, chunk: int, capacity: int,
                  ceiling: int | None = None) -> None:
    check_k(k)
    if chunk <= k:
        raise ValueError("chunk must exceed k")
    if capacity <= 0:
        raise ValueError("capacity must be > 0")
    if ceiling is not None and ceiling < chunk:
        raise ValueError("the ceiling of %d slots is below the chunk of %d "
                         "bases: a chunk's keys must fit an emptied "
                         "accumulator" % (ceiling, chunk))


# device bytes a chunk's kernels hold beside the accumulators, a base of
# the chunk (count.fastq_skewed peaks 0.61 GiB above its 2^28-slot pair
# at 2^24 bases)
CHUNK_WORKING_BYTES = 64


def fitting_ceiling(chunk: int, dev: torch.device) -> int:
    """The largest power of two of slots whose pair of accumulators (32 B
    a slot) fits beside a chunk's working set in the memory free now, and
    at least the chunk: on a card the driver's free memory and the blocks
    torch's allocator holds unused, on CPU tensors the host's available
    memory."""
    if dev.type == "cuda":
        free = torch.cuda.mem_get_info(dev)[0] + (
            torch.cuda.memory_reserved(dev)
            - torch.cuda.memory_allocated(dev))
    else:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    slots = (free - CHUNK_WORKING_BYTES * chunk) // 32
    return max(1 << max(slots, 1).bit_length() - 1,
               1 << (chunk - 1).bit_length())


def _count_batches(batches, k, canonical, min_count, chunk, capacity, dev,
                   sort_chunk, stats, ceiling):
    span_s = {} if stats is None else stats.setdefault("span_s", {})
    with profiling.collect(span_s):
        chunks = chunk_stream(_coalesce_batches(batches, k, 4 * chunk),
                              chunk, k)
        return _stream((functools.partial(_upload, codes, valid, dev)
                        for codes, valid in _input(chunks)),
                       k, canonical, min_count, capacity, dev, sort_chunk,
                       stats, ceiling=ceiling)


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
    _check_stream(k, chunk, capacity)
    return _count_batches(batches, k, canonical, min_count, chunk, capacity,
                          resolve_device(device), sort_chunk, stats, None)


def count_batches_device_compact(batches, k: int, canonical: bool = True,
                                 min_count: int = 1, chunk: int = 1 << 24,
                                 device="cuda", sort_chunk: int = CHUNK,
                                 stats=None, ceiling: int | None = None):
    """(codes, valid) host batches counted as ``count --mode chunked``
    counts them, jellyfish's ``--disk`` count: the stream's loop
    (``count_batches_device_stream``, from 2^22 slots) whose accumulator
    grows no further than ``ceiling`` slots (at least the chunk; None:
    ``fitting_ceiling``, what the device holds now). A merge that
    overflows the ceiling is dumped: the accumulator before it is read
    back as one sorted piece, the pair emptied and the chunk counted
    again into it. At the end, without a dump, the count finishes as the
    stream's does; after one, the last accumulator is read back whole
    and the pieces are merged on the host, the ``min_count`` cut made on
    the merged counts. Returns (keys uint64, counts uint32), equal to
    every other counting path's. Host memory holds the pieces (12 B a
    record) and what is kept.

    ``stats`` receives the stream's numbers (``unique`` and ``total``
    over the merged pieces, ``kept`` after the cut) and ``ceiling``,
    ``dumps`` (the merges dumped), ``dumped`` (the records read back
    in dumps) and ``dump_staged_bytes`` (the bytes the dumps moved
    through the staging pair of ``_read_staged``, 12 a record); under
    ``span_s`` the stream's spans and ``count.dump`` (one dump: the
    wait, the piece copied to the host, the pair emptied and the chunk
    counted again) and ``count.host_merge`` (the pieces merged and cut
    on the host), each absent where none ran."""
    dev = resolve_device(device)
    if ceiling is None:
        ceiling = fitting_ceiling(chunk, dev)
    _check_stream(k, chunk, 1 << 22, ceiling)
    return _count_batches(batches, k, canonical, min_count, chunk, 1 << 22,
                          dev, sort_chunk, stats, ceiling)


class _FastqBlocks:
    """The card path's input: each file, plain or gzip, read with
    ``readinto`` into one of two host buffers of 2 * chunk bytes (pinned
    on a card), in blocks of whole records.

    A block ends at its last whole record, found by a scan of the block's
    tail alone, backwards; the rest is carried to the head of the next
    block. Every record takes at least twice its positions in bytes, so a
    block's reads and separators fit one chunk and no read spans two.
    Files follow each other in the buffers. At a file's end an incomplete
    last record is dropped, as the host parser drops it, and a last line
    without a newline gets one (``_file_end``). The last block of the
    last file is taken whole: the parse checks that it holds whole
    records.

    Iterating yields, for each block, a callable that uploads the block
    without blocking (span ``count.upload``; an event marks the copy's
    end) and parses it into a chunk; a growth calls it again, while the
    block's buffer is intact: a buffer is refilled two blocks later,
    after its last upload's event. Each step's read is the span
    ``count.read``."""

    def __init__(self, paths, chunk: int, min_quality, dev: torch.device,
                 bad: torch.Tensor):
        self.chunk, self.min_quality, self.dev, self.bad = (
            chunk, min_quality, dev, bad)
        self._paths = iter(paths)
        self._file = None  # the file being read
        self._done = False  # every file read to its end
        cuda = dev.type == "cuda"
        self.bufs = [torch.empty(2 * chunk, dtype=torch.uint8,
                                 pin_memory=cuda) for _ in range(2)]
        self.uploaded = [None, None]  # the event after a buffer's upload
        self.input_bytes = self.parsed_bytes = 0

    def __iter__(self):
        tail = None  # (array, start, end) carried over
        try:
            for i in itertools.count():
                b = i % 2
                with profiling.phase("count.read"):
                    a, cut, end = self._read(b, tail)
                    tail = (a, cut, end)
                if cut:
                    yield self._source(b, cut)
                if self._done:
                    return
        finally:
            if self._file is not None:
                self._file.close()

    def _read(self, b: int, tail):
        """Fill buffer b: the tail carried over, then the files' text up
        to the buffer's end or the last file's. Returns (its array, the
        end of its last whole record, the end of its text)."""
        if self.uploaded[b] is not None:
            self.uploaded[b].synchronize()
        a = self.bufs[b].numpy()
        end = 0
        if tail is not None:
            src, lo, hi = tail
            a[:hi - lo] = src[lo:hi]
            end = hi - lo
        view = memoryview(a)
        while end < len(a) and not self._done:
            if self._file is None:
                path = next(self._paths, None)
                if path is None:
                    self._done = True
                    break
                self._file = _open_fastq(path)
            got = self._file.readinto(view[end:])
            if got:
                end += got
                self.input_bytes += got
                continue
            self._file.close()
            self._file = None
            end = _file_end(a, end)  # got 0, so end < len(a)
        cut = end if self._done else _last_record_end(a, end)
        if cut == 0 and end:
            raise ValueError(
                "a FASTQ record longer than the %d-byte block: the card "
                "counts reads of at most %d bases, fewer by half the length "
                "of the header and '+' lines" % (len(a), self.chunk - 3))
        return a, cut, end

    def _source(self, b: int, n: int):
        parsed = False

        def chunk():
            nonlocal parsed
            with profiling.phase("count.upload"):
                text = self.bufs[b][:n]
                if self.dev.type == "cuda":
                    text = text.to(self.dev, non_blocking=True)
                    self.uploaded[b] = torch.cuda.Event()
                    self.uploaded[b].record()
            if not parsed:
                parsed = True
                self.parsed_bytes += n
            return parse.parse_fastq(text, self.chunk, self.min_quality,
                                     self.bad)
        return chunk


def _open_fastq(path: str):
    """A file for ``readinto``: gzip through its decompressor, a plain
    file unbuffered."""
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb", buffering=0)


def _file_end(a: np.ndarray, n: int) -> int:
    """The end of a file's text a[:n], which starts at a record, as the
    card parses it: an incomplete last record is dropped, as
    native/kmio.cpp's ``km_parse_fastq`` drops it (a line starting '@'
    followed by fewer than three newlines, or by a quality line shorter
    than its read), and a last line without a newline gets one at a[n],
    which the caller keeps free. Anything else after the last whole
    record stays, for the parse to find broken."""
    cut = _last_record_end(a, n)
    rest = a[cut:n]
    if len(rest) and rest[0] == AT:
        ends = np.flatnonzero(rest == NEWLINE)[:3]
        if len(ends) < 3 or len(rest) - ends[2] - 1 < ends[1] - ends[0] - 1:
            return cut
    if n and a[n - 1] != NEWLINE:
        a[n] = NEWLINE
        n += 1
    return n


def _last_record_end(a: np.ndarray, n: int) -> int:
    """The end of the last whole FASTQ record of a[:n], which starts at a
    record, or 0 where none ends there. Only the tail is scanned, from
    the end, until nine newlines are seen: a record starts at a line
    starting '@' whose third line starts '+' and whose second and fourth
    lines are of one length, and the last whole record starts at one of
    the four line starts before the last four newlines."""
    w = 4096
    while True:
        lo = max(0, n - w)
        ends = np.flatnonzero(a[lo:n] == NEWLINE) + lo
        if lo == 0:
            ends = np.concatenate(([-1], ends))  # the block starts a record
        for j in range(len(ends) - 5, -1, -1):
            e = ends[j + 1:j + 5]
            if a[ends[j] + 1] == AT and a[e[1] + 1] == PLUS \
                    and e[1] - e[0] == e[3] - e[2]:
                return int(e[3]) + 1
        if lo == 0:
            return 0
        if len(ends) >= 9:
            raise ValueError("malformed FASTQ record")
        w *= 4


def count_fastq_device_stream(paths, k: int, canonical: bool = True,
                              min_count: int = 1, min_quality=None,
                              chunk: int = 1 << 24, capacity: int = 1 << 22,
                              device="cuda", sort_chunk: int = CHUNK,
                              stats=None, ceiling: int | None = None):
    """FASTQ files -> (keys uint64, counts uint32), parsed on the device:
    the stream's accumulator loop (``count_batches_device_stream``'s,
    with its growths and its cut) fed by ``_FastqBlocks``, whose text P1
    (``ops/parse.py::parse_fastq``) turns into each chunk's codes and
    flags. The host reads the files into pinned memory and finds where
    each block's last record ends; nothing else of the text passes
    through it. On CPU tensors the plain parse runs in the kernel's place.

    Equal to ``count_batches_device_stream(read_batches(paths, ...))``
    where every file is FASTQ records: an incomplete last record of a
    file is dropped, as the host parser drops it, and a broken record
    raises ``ValueError``, as the host parser does for a record that does
    not start with '@'. Stricter than the host parser: a third line must
    start with '+' and a quality line must end at its read's length.

    ``stats`` receives what ``count_batches_device_stream`` gives, less
    the span ``count.input`` and plus ``count.read`` (a block read into
    its buffer, its end found), ``input_bytes`` (bytes of text read) and
    ``card_parsed_bytes`` (bytes of text P1 received, each block once: a
    growth's second parse is not counted; a dropped last record is not
    and a newline added at a file's end is).

    With a ``ceiling``, the loop is ``count_batches_device_compact``'s,
    with its dumps, host merge and numbers: ``count --mode chunked`` of
    FASTQ on a card."""
    _check_stream(k, chunk, capacity, ceiling)
    dev = resolve_device(device)
    span_s = {} if stats is None else stats.setdefault("span_s", {})
    with profiling.collect(span_s):
        counters = torch.zeros(3, dtype=torch.int64, device=dev)
        blocks = _FastqBlocks(paths, chunk, min_quality, dev, counters[2:])
        out = _stream(blocks, k, canonical, min_count, capacity, dev,
                      sort_chunk, stats, counters=counters, ceiling=ceiling)
    if stats is not None:
        stats.update(input_bytes=blocks.input_bytes,
                     card_parsed_bytes=blocks.parsed_bytes)
    return out


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
