"""Merges of sorted (key, count) runs, with the counts of equal keys summed,
and the ``min_count`` cut of their result.

``chunk_runs`` (M1), ``merge_accum`` (M2) and ``cut`` (C1) launch
``csrc/merge_runs.cu`` for CUDA tensors and run ``chunk_runs_plain``,
``merge_accum_plain`` and ``cut_plain`` for CPU tensors. M1 and M2
replace km_tpu's XLA merge programs
(``ops/count.py``: ``sum_runs_device`` :195 as the stream uses it,
``merge_accum_device`` :369, the fused step ``_jitted_count_merge``
:408), which re-sorted the whole padded accumulator with every chunk:

- ``chunk_runs`` takes the chunk sort's output (keys sorted within
  ``sort_chunk``-sized pieces, int32 run lengths at run starts, 0
  elsewhere and on SENTINEL runs) to the chunk's runs in global key
  order: ascending distinct keys and exact int64 counts > 0, and their
  number ``m``, left on the device.
- ``merge_accum`` merges those runs into an accumulator (ascending
  distinct keys with counts > 0, its live length on the device) and
  writes the result into a second buffer of the same capacity C: the
  first C keys in key order, SENTINEL and 0 past them, and the true
  number of distinct keys, which may exceed C.
- ``cut`` keeps the accumulator's records whose count reaches
  ``min_count`` and writes them, in key order, as the words of the
  uint64 keys and the uint32 counts the host wants, into buffers the
  caller gives (the stream's spare accumulator), with the number kept,
  the sum of every live count and the live length in one small device
  tensor; only that tensor and the kept records need cross to the host.
  It replaces km_tpu's host numpy cut at the end of its stream.

Lengths stay on the device, so a stream of chunks never waits for the
card. On the card, ``chunk_runs`` is a sample sort: splitters from a
sample of the keys, each piece's live run starts compacted and cut at
the splitters, one block per bucket sorting and summing its slices in
shared memory; ``merge_accum`` is one merge-path pass in tile order.
Both take each output's rank from a decoupled look-back (csrc's design
note). The plain versions compute the same functions with torch: the
live run starts sorted and reduced; merge positions from ``searchsorted``
ranks (A[i] goes to i + #(B < A[i]), B[j] to j + #(A <= B[j])); run
boundaries from key changes, run totals as differences of an int64
cumsum, ranks by cumsum; no atomics. ``cut_plain`` finds the i-th kept
record by a ``searchsorted`` on the cumsum of the kept flags.

While a ``tally`` is open, every ``chunk_runs`` adds its run count and
the bucket rounds it took beyond one a bucket to the tally's two device
counters, without a wait (the plain version takes every bucket at once,
so it adds 0 rounds). The stream count reads them in its finish.
"""

from __future__ import annotations

import contextlib

import torch

from .. import _build
from ..device import SENTINEL
from .sort_runs import CHUNK, _check_chunk


def _scratch(n_bytes: int, dev: torch.device) -> torch.Tensor:
    """A kernel's scratch (the kernel zeroes what must start at 0)."""
    if n_bytes <= 0:
        raise ValueError("the kernel does not take this shape")
    return torch.empty(n_bytes, dtype=torch.uint8, device=dev)


def _check(t: torch.Tensor, dtype: torch.dtype, name: str, dim: int = 1
           ) -> None:
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError("%s must be %d-D and contiguous" % (name, dim))
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % t.device)


def _same_device(tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("tensors on more than one device: %s"
                         % sorted(map(str, devices)))
    return devices.pop()


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0 = a.data_ptr()
    b0 = b.data_ptr()
    a1 = a0 + a.numel() * a.element_size()
    b1 = b0 + b.numel() * b.element_size()
    return a0 < b1 and b0 < a1 and a.numel() > 0 and b.numel() > 0


# ---------------------------------------------------------------------------
# the plain versions


def _merge_plain(ak, ac, bk, bc):
    """The stable merge of two sorted (keys, counts) sequences by ranks;
    on equal keys A comes first."""
    n = ak.numel() + bk.numel()
    dev = ak.device
    pa = torch.arange(ak.numel(), device=dev) + torch.searchsorted(bk, ak)
    pb = torch.arange(bk.numel(), device=dev) + torch.searchsorted(
        ak, bk, right=True)
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    counts = torch.empty(n, dtype=torch.int64, device=dev)
    keys[pa], keys[pb] = ak, bk
    counts[pa], counts[pb] = ac, bc
    return keys, counts


def _reduce_plain(keys, counts, out_k, out_c, cap: int) -> int:
    """Runs of equal keys of a sorted sequence -> (key, total) at each
    run's rank in out_k/out_c where the rank is below cap; returns the
    number of runs."""
    n = keys.numel()
    if n == 0:
        return 0
    start = torch.ones(n, dtype=torch.bool, device=keys.device)
    start[1:] = keys[1:] != keys[:-1]
    end = torch.ones_like(start)
    end[:-1] = start[1:]
    incl = torch.cumsum(counts, 0)
    rank = torch.cumsum(start.to(torch.int64), 0) - 1
    # the count prefix before each run's first record, by rank
    run_start = (incl - counts)[start]
    write = end & (rank < cap)
    at = rank[write]
    out_k[at] = keys[write]
    out_c[at] = incl[write] - run_start[at]
    return int(rank[-1]) + 1


def chunk_runs_plain(keys: torch.Tensor, lengths: torch.Tensor,
                     sort_chunk: int = CHUNK):
    """``chunk_runs``' plain version: every piece's live run starts (the
    pieces are cut only in the kernel), sorted by key, then reduced."""
    n = keys.numel()
    dev = keys.device
    live = lengths > 0
    order = torch.sort(keys[live], stable=True)
    out_k = torch.empty(n, dtype=torch.int64, device=dev)
    out_c = torch.empty(n, dtype=torch.int64, device=dev)
    m = _reduce_plain(order.values,
                      lengths[live].to(torch.int64)[order.indices],
                      out_k, out_c, n)
    return out_k, out_c, torch.tensor(m, dtype=torch.int64, device=dev)


def merge_accum_plain(acc_keys, acc_cnt, acc_n, run_keys, run_cnt, run_n,
                      out_keys, out_cnt, out_n) -> None:
    """``merge_accum``'s plain version, into the out tensors."""
    cap = acc_keys.numel()
    la = min(int(acc_n), cap)
    lb = int(run_n)
    merged = _merge_plain(acc_keys[:la], acc_cnt[:la], run_keys[:lb],
                          run_cnt[:lb])
    runs = _reduce_plain(*merged, out_keys, out_cnt, cap)
    prev = min(int(out_n), cap)
    out_keys[min(runs, cap):prev] = SENTINEL
    out_cnt[min(runs, cap):prev] = 0
    out_n.fill_(runs)


def cut_plain(keys, counts, n, min_count: int, out_keys, out_cnt
              ) -> torch.Tensor:
    """``cut``'s plain version, into out_keys and out_cnt."""
    dev = keys.device
    live = min(int(n), keys.numel())
    c = counts[:live]
    incl = torch.cumsum((c >= min_count).to(torch.int64), 0)
    kept = int(incl[-1]) if live else 0
    at = torch.searchsorted(incl, torch.arange(1, kept + 1, device=dev))
    k = keys[at]
    out_keys[:kept] = torch.where(k == SENTINEL, -1, k)
    low = counts[at] & 0xFFFFFFFF
    out_cnt[:kept] = (low - ((low >> 31) << 32)).to(torch.int32)
    return torch.tensor([kept, int(c.sum()), int(n)], dtype=torch.int64,
                        device=dev)


# ---------------------------------------------------------------------------
# the wrappers

_TALLIES: list[torch.Tensor] = []


@contextlib.contextmanager
def tally(into: torch.Tensor):
    """While open, every ``chunk_runs`` on ``into``'s device adds its run
    count m to into[0] and its bucket rounds beyond one a bucket to
    into[1] (int64 [2]), on the device."""
    _check(into, torch.int64, "tally")
    if into.numel() != 2:
        raise ValueError("a tally holds two counters")
    _TALLIES.append(into)
    try:
        yield into
    finally:
        _TALLIES.pop()


def chunk_runs(keys: torch.Tensor, lengths: torch.Tensor,
               sort_chunk: int = CHUNK):
    """The chunk sort's output (int64 keys [n] sorted within sort_chunk
    pieces, int32 run lengths [n] at run starts) -> (keys [n], counts
    [n], m): keys[:m] ascending and distinct, counts[:m] their exact int64
    totals (> 0), m a 0-d int64 tensor on the keys' device; the slots
    past m are unspecified. Adds to an open ``tally`` on that device."""
    _check_chunk(sort_chunk)
    _check(keys, torch.int64, "keys")
    _check(lengths, torch.int32, "lengths")
    if lengths.numel() != keys.numel():
        raise ValueError("keys and lengths differ in length")
    dev = _same_device((keys, lengths))
    counters = _TALLIES[-1] if _TALLIES and _TALLIES[-1].device == dev \
        else None
    if dev.type == "cpu":
        out = chunk_runs_plain(keys, lengths, sort_chunk)
        if counters is not None:
            counters[0] += out[2]
        return out
    n = keys.numel()
    out_k = torch.empty(n, dtype=torch.int64, device=dev)
    out_c = torch.empty_like(out_k)
    m = torch.zeros((), dtype=torch.int64, device=dev)
    if n == 0:
        return out_k, out_c, m
    lib = _build.lib()
    scratch = _scratch(lib.km_chunk_runs_scratch(n, sort_chunk), dev)
    with torch.cuda.device(dev):
        code = lib.km_chunk_runs(
            keys.data_ptr(), lengths.data_ptr(), n, sort_chunk,
            out_k.data_ptr(), out_c.data_ptr(), scratch.data_ptr(),
            scratch.numel(), m.data_ptr(),
            None if counters is None else counters.data_ptr(),
            _build.stream_ptr(dev))
    _build.check(code, "chunk_runs")
    chunk_runs.launches += 1
    return out_k, out_c, m


chunk_runs.launches = 0


def merge_accum(acc_keys: torch.Tensor, acc_cnt: torch.Tensor,
                acc_n: torch.Tensor, run_keys: torch.Tensor,
                run_cnt: torch.Tensor, run_n: torch.Tensor,
                out_keys: torch.Tensor, out_cnt: torch.Tensor,
                out_n: torch.Tensor) -> None:
    """Merge runs into an accumulator of capacity C = acc_keys.numel(),
    writing into the out buffer of the same capacity.

    acc_keys/acc_cnt: min(acc_n, C) ascending distinct keys with counts
    > 0; run_keys/run_cnt: run_n such runs (``chunk_runs``' output); all
    int64, the lengths 0-d. out_keys/out_cnt must hold SENTINEL and 0
    past min(out_n, C) (an ``empty_accumulator`` does, and so does every
    output of this function), so only slots that were live are padded
    again. Afterwards out holds the first C merged keys in key order
    with summed counts, SENTINEL and 0 past them, and out_n the number of
    distinct keys, which may exceed C. out must not overlap the inputs."""
    tensors = (acc_keys, acc_cnt, run_keys, run_cnt, out_keys, out_cnt)
    for name, t in zip(("acc_keys", "acc_cnt", "run_keys", "run_cnt",
                        "out_keys", "out_cnt"), tensors):
        _check(t, torch.int64, name)
    for name, t in (("acc_n", acc_n), ("run_n", run_n), ("out_n", out_n)):
        _check(t, torch.int64, name, dim=0)
    cap = acc_keys.numel()
    if not (acc_cnt.numel() == out_keys.numel() == out_cnt.numel() == cap
            and cap > 0):
        raise ValueError("the accumulator and the out buffer must have "
                         "the same capacity > 0")
    if run_cnt.numel() != run_keys.numel():
        raise ValueError("run_keys and run_cnt differ in length")
    for out in (out_keys, out_cnt, out_n):
        for t in (*tensors[:4], acc_n, run_n):
            if _overlaps(out, t):
                raise ValueError("the out buffer overlaps an input")
    dev = _same_device((*tensors, acc_n, run_n, out_n))
    if dev.type == "cpu":
        merge_accum_plain(acc_keys, acc_cnt, acc_n, run_keys, run_cnt, run_n,
                          out_keys, out_cnt, out_n)
        return
    max_runs = run_keys.numel()
    lib = _build.lib()
    scratch = _scratch(lib.km_merge_accum_scratch(cap, max_runs), dev)
    with torch.cuda.device(dev):
        code = lib.km_merge_accum(
            acc_keys.data_ptr(), acc_cnt.data_ptr(), acc_n.data_ptr(), cap,
            run_keys.data_ptr(), run_cnt.data_ptr(), run_n.data_ptr(),
            max_runs, out_keys.data_ptr(), out_cnt.data_ptr(),
            out_n.data_ptr(), scratch.data_ptr(), scratch.numel(),
            _build.stream_ptr(dev))
    _build.check(code, "merge_accum")
    merge_accum.launches += 1


merge_accum.launches = 0


def cut(keys: torch.Tensor, counts: torch.Tensor, n: torch.Tensor,
        min_count: int, out_keys: torch.Tensor, out_cnt: torch.Tensor
        ) -> torch.Tensor:
    """The ``min_count`` cut of an accumulator of capacity C =
    keys.numel(): of its min(n, C) live records (int64 keys ascending,
    int64 counts; n 0-d int64), those with count >= min_count go, in key
    order, to out_keys[:kept] as the words of the uint64 keys (int64;
    SENTINEL as all ones) and to out_cnt[:kept] as the counts' low 32
    bits, the words of the uint32 counts (int32). out_keys and out_cnt
    hold C slots or more and must not overlap the inputs. Returns
    (kept, the sum of every live count, n) as an int64 tensor [3] on the
    keys' device; nothing is read on the host."""
    for name, t in (("keys", keys), ("counts", counts),
                    ("out_keys", out_keys)):
        _check(t, torch.int64, name)
    _check(out_cnt, torch.int32, "out_cnt")
    _check(n, torch.int64, "n", dim=0)
    cap = keys.numel()
    if counts.numel() != cap or cap == 0:
        raise ValueError("keys and counts must have the same length > 0")
    if out_keys.numel() < cap or out_cnt.numel() < cap:
        raise ValueError("the out buffers must hold %d slots" % cap)
    for out in (out_keys, out_cnt):
        for t in (keys, counts, n):
            if _overlaps(out, t):
                raise ValueError("an out buffer overlaps an input")
    dev = _same_device((keys, counts, n, out_keys, out_cnt))
    if dev.type == "cpu":
        return cut_plain(keys, counts, n, min_count, out_keys, out_cnt)
    result = torch.empty(3, dtype=torch.int64, device=dev)
    lib = _build.lib()
    scratch = _scratch(lib.km_cut_scratch(cap), dev)
    with torch.cuda.device(dev):
        code = lib.km_cut(
            keys.data_ptr(), counts.data_ptr(), n.data_ptr(), cap, min_count,
            out_keys.data_ptr(), out_cnt.data_ptr(), result.data_ptr(),
            scratch.data_ptr(), scratch.numel(), _build.stream_ptr(dev))
    _build.check(code, "cut")
    cut.launches += 1
    return result


cut.launches = 0
