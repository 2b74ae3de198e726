"""Merges of sorted (key, count) runs, with the counts of equal keys summed.

``chunk_runs`` (M1) and ``merge_accum`` (M2) launch ``csrc/merge_runs.cu``
for CUDA tensors and run ``chunk_runs_plain`` and ``merge_accum_plain``
for CPU tensors. Together they replace km_tpu's XLA merge programs
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

Lengths stay on the device, so a stream of chunks never waits for the
card. The plain versions repeat the kernels' arithmetic: merge positions
from ``searchsorted`` ranks (A[i] goes to i + #(B < A[i]), B[j] to
j + #(A <= B[j])), run boundaries from key changes, run totals as
differences of an int64 cumsum, ranks by cumsum; no atomics.
"""

from __future__ import annotations

import torch

from .. import _build
from ..device import SENTINEL
from .sort_runs import CHUNK, _check_chunk

TILE = 1024  # merged positions per block: kTile in csrc/merge_runs.cu


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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
    """``chunk_runs``' plain version: each piece's live run starts, the
    pieces merged pairwise level by level, then reduced."""
    n = keys.numel()
    dev = keys.device
    segments = []
    for off in range(0, max(n, 1), sort_chunk):
        live = lengths[off:off + sort_chunk] > 0
        segments.append((keys[off:off + sort_chunk][live],
                         lengths[off:off + sort_chunk][live].to(torch.int64)))
    while len(segments) > 1:
        segments = [_merge_plain(*segments[i], *segments[i + 1])
                    if i + 1 < len(segments) else segments[i]
                    for i in range(0, len(segments), 2)]
    out_k = torch.empty(n, dtype=torch.int64, device=dev)
    out_c = torch.empty(n, dtype=torch.int64, device=dev)
    m = _reduce_plain(*segments[0], out_k, out_c, n)
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


# ---------------------------------------------------------------------------
# the wrappers


def chunk_runs(keys: torch.Tensor, lengths: torch.Tensor,
               sort_chunk: int = CHUNK):
    """The chunk sort's output (int64 keys [n] sorted within sort_chunk
    pieces, int32 run lengths [n] at run starts) -> (keys [n], counts
    [n], m): keys[:m] ascending and distinct, counts[:m] their exact int64
    totals (> 0), m a 0-d int64 tensor on the keys' device; the slots
    past m are unspecified."""
    _check_chunk(sort_chunk)
    _check(keys, torch.int64, "keys")
    _check(lengths, torch.int32, "lengths")
    if lengths.numel() != keys.numel():
        raise ValueError("keys and lengths differ in length")
    dev = _same_device((keys, lengths))
    if dev.type == "cpu":
        return chunk_runs_plain(keys, lengths, sort_chunk)
    n = keys.numel()
    out_k = torch.empty(n, dtype=torch.int64, device=dev)
    out_c = torch.empty_like(out_k)
    m = torch.zeros((), dtype=torch.int64, device=dev)
    if n == 0:
        return out_k, out_c, m
    tmp_k = torch.empty_like(out_k)
    tmp_c = torch.empty_like(out_k)
    pieces = _cdiv(n, sort_chunk)
    seg0 = torch.zeros(max(pieces, 2), dtype=torch.int64, device=dev)
    seg1 = torch.zeros(max(_cdiv(pieces, 2), 2), dtype=torch.int64,
                       device=dev)
    stats = torch.empty(3 * _cdiv(n, TILE) + 1, dtype=torch.int64,
                        device=dev)
    with torch.cuda.device(dev):
        code = _build.lib().km_chunk_runs(
            keys.data_ptr(), lengths.data_ptr(), n, sort_chunk,
            out_k.data_ptr(), out_c.data_ptr(), tmp_k.data_ptr(),
            tmp_c.data_ptr(), seg0.data_ptr(), seg1.data_ptr(),
            stats.data_ptr(), stats.numel(), m.data_ptr(),
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
    stats = torch.empty(3 * _cdiv(cap + max_runs, TILE) + 1,
                        dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        code = _build.lib().km_merge_accum(
            acc_keys.data_ptr(), acc_cnt.data_ptr(), acc_n.data_ptr(), cap,
            run_keys.data_ptr(), run_cnt.data_ptr(), run_n.data_ptr(),
            max_runs, out_keys.data_ptr(), out_cnt.data_ptr(),
            out_n.data_ptr(), stats.data_ptr(), stats.numel(),
            _build.stream_ptr(dev))
    _build.check(code, "merge_accum")
    merge_accum.launches += 1


merge_accum.launches = 0
