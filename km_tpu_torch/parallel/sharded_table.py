"""Count table sharded by key range over a process group, and counting
into it; ported from km_tpu/parallel/sharded_table.py onto
torch.distributed.

Keys are the port's int64 words (device.py), with SENTINEL = 2**63 - 1
as padding; there is no (hi, lo) split.

- **The table.** The sorted keys are cut into S contiguous ranges of
  equal record count, per = ceil(N / S), padded with SENTINEL and count
  0, as in km_tpu. Rank r of the group holds range r on its device, and
  every rank holds the boundaries: the first key of each range, SENTINEL
  for a range that is pure padding. Counts are int64 (km_tpu narrows
  them to int32).
- **lookup** (broadcast): the queries are the same on every rank; each
  rank searches its slice and an ``all_reduce(SUM)`` combines the
  hit-or-0 answers.
- **lookup_routed**: each rank has its own queries. Each query travels
  to the one rank whose range can hold it (the rightmost boundary <= q),
  is answered there and comes back: one exchange of the per-owner
  counts, then two variable-size ``all_to_all_single``.
- **Counting** (:func:`count_exchange`, :func:`sharded_count`): each
  rank counts its chunk through K1 and K2 (ops.count.count_chunk_device),
  sends each (key, count) run to the rank that owns its key, and the
  owner sums what it received exactly.

Not carried over from km_tpu, and why:
- ``routed_cap``, the dropped-query count and the broadcast fallback of
  ``lookup_routed`` (km_tpu :226-266), and the bucket cap of the
  counting exchange with its doubling retry (:388-427). XLA needs static
  shapes, so km_tpu routes through fixed-size buckets that can overflow.
  Here the split sizes are exchanged first and each
  ``all_to_all_single`` carries exactly what is sent: nothing can drop,
  so there is nothing to fall back from or retry. Both lookups stay,
  because km_tpu's API has both.
- km_tpu's owner rule for counting. It reads the owner from the top bits
  of the 64-bit word (:326-328), which are 0 for every key with k <= 31
  (keys < 2**62), so every run goes to shard 0. Here the owner comes
  from the top bits of the 2k-bit key (:func:`owner_of`).

Every rank of a group makes the same collective calls in the same
order: split sizes are exchanged before each variable exchange, and the
chunk stream is padded so that every rank takes the same number of
counting steps.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from km_tpu.models.table import CountTable
from km_tpu.ops.count import _coalesce_batches, chunk_stream, merge_runs

from ..device import (SENTINEL, check_k, i64_to_u64, resolve_device,
                      to_device_keys, u64_to_i64)
from ..ops.count import count_chunk_device, sum_runs_device
from ..ops.device_table import canonical as canonical_keys
from .distributed import check_backend, group_size_rank


def _exchange(rows: torch.Tensor, dest: torch.Tensor, group):
    """Send row i of ``rows`` to rank ``dest[i]`` of ``group``. Returns
    (the rows received, by sender rank and in each sender's order; the
    stable order that groups ``rows`` by destination; the send splits;
    the receive splits)."""
    S = dist.get_world_size(group)
    order = torch.argsort(dest, stable=True)
    send = rows[order].contiguous()
    send_n = torch.bincount(dest, minlength=S)
    recv_n = torch.empty_like(send_n)
    dist.all_to_all_single(recv_n, send_n, group=group)
    send_splits, recv_splits = torch.stack([send_n, recv_n]).tolist()
    recv = rows.new_empty((sum(recv_splits),) + tuple(rows.shape[1:]))
    dist.all_to_all_single(recv, send, output_split_sizes=recv_splits,
                           input_split_sizes=send_splits, group=group)
    return recv, order, send_splits, recv_splits


def _global_rank(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def gather_to_first(rows: torch.Tensor, device: torch.device, group=None
                    ) -> np.ndarray | None:
    """Every rank's ``rows`` (row counts may differ) concatenated in rank
    order, as numpy on the group's first rank; None on the others.
    ``rows`` may lie on the host or on ``device``, through which the
    group carries them. The first rank receives one rank's rows at a
    time and moves them straight to host memory, so its device holds at
    most its own rows and one other rank's, never the whole table."""
    S, rank = group_size_rank(group)
    n = torch.tensor([rows.shape[0]], dtype=torch.int64, device=device)
    sizes = [torch.empty_like(n) for _ in range(S)]
    dist.all_gather(sizes, n, group=group)
    sizes = torch.cat(sizes).tolist()
    if rank:
        if sizes[rank]:
            dist.send(rows.to(device).contiguous(), _global_rank(group, 0),
                      group=group)
        return None
    parts = [rows.cpu().numpy()]
    for r in range(1, S):
        part = torch.empty((sizes[r],) + tuple(rows.shape[1:]),
                           dtype=rows.dtype, device=device)
        if sizes[r]:
            dist.recv(part, _global_rank(group, r), group=group)
        parts.append(part.cpu().numpy())
    return np.concatenate(parts)


def _search(keys: torch.Tensor, counts: torch.Tensor, q: torch.Tensor
            ) -> torch.Tensor:
    """Counts of q in one sorted slice (0 where absent)."""
    pos = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
    return torch.where(keys[pos] == q, counts[pos], torch.zeros_like(q))


class ShardedCountTable:
    """A count table cut into equal key ranges, one per rank of
    ``group`` (the world group by default), on ``device``, whose type
    must match the group's backend. Every rank builds it from the same
    km_tpu host CountTable (keys sorted), as km_tpu's does."""

    def __init__(self, host_table, group=None, device="cuda"):
        check_k(host_table.k)
        self.device = resolve_device(device)
        self.group = group
        S, rank = group_size_rank(group)
        check_backend(group, self.device)
        self.k = int(host_table.k)
        self.canonical = bool(host_table.canonical)
        self.name = host_table.name
        keys = u64_to_i64(np.asarray(host_table.keys, dtype=np.uint64))
        counts = np.asarray(host_table.counts).astype(np.int64)
        n = len(keys)
        per = -(-max(n, 1) // S)
        starts = np.arange(S) * per
        bounds = np.full(S, SENTINEL, np.int64)
        bounds[starts < n] = keys[starts[starts < n]]
        lo, hi = min(rank * per, n), min((rank + 1) * per, n)
        slice_keys = np.full(per, SENTINEL, np.int64)
        slice_counts = np.zeros(per, np.int64)
        slice_keys[:hi - lo] = keys[lo:hi]
        slice_counts[:hi - lo] = counts[lo:hi]
        self.keys = torch.from_numpy(slice_keys).to(self.device)
        self.counts = torch.from_numpy(slice_counts).to(self.device)
        self.boundaries = torch.from_numpy(bounds).to(self.device)
        self.per_shard = per
        self.n_shards = S
        self.rank = rank

    def _canon(self, q: torch.Tensor) -> torch.Tensor:
        return canonical_keys(q, self.k) if self.canonical else q

    def lookup(self, q: torch.Tensor) -> torch.Tensor:
        """int64 counts of int64 queries that every rank passes alike;
        every rank gets every answer."""
        out = _search(self.keys, self.counts,
                      self._canon(q).reshape(-1).contiguous())
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out.reshape(q.shape)

    def lookup_routed(self, q: torch.Tensor) -> torch.Tensor:
        """int64 counts of this rank's own int64 queries, each answered
        by the rank that owns its key range."""
        flat = self._canon(q).reshape(-1).contiguous()
        owner = (torch.searchsorted(self.boundaries, flat, right=True)
                 - 1).clamp_(min=0)
        recv, order, send_splits, recv_splits = _exchange(flat, owner,
                                                          self.group)
        answers = _search(self.keys, self.counts, recv)
        back = torch.empty_like(flat)
        dist.all_to_all_single(back, answers, output_split_sizes=send_splits,
                               input_split_sizes=recv_splits,
                               group=self.group)
        out = torch.empty_like(flat)
        out[order] = back
        return out.reshape(q.shape)

    def query_packed(self, keys: np.ndarray, routed: bool = True
                     ) -> np.ndarray:
        """Host convenience: uint64 queries -> int64 counts (numpy)."""
        keys = np.asarray(keys, dtype=np.uint64)
        look = self.lookup_routed if routed else self.lookup
        out = look(to_device_keys(keys.reshape(-1), self.device))
        return out.cpu().numpy().reshape(keys.shape)

    # -- persistence, in km_tpu's format (CountTable.save / .load) --

    def save(self, path: str) -> None:
        """Gather the slices to the first rank, which writes the table
        (every rank calls this; a failed write raises on every rank)."""
        rows = gather_to_first(torch.stack([self.keys, self.counts], 1),
                               self.device, self.group)
        error = None
        if rows is not None:
            keys, counts = rows.T
            real = counts > 0  # padding carries count 0
            try:
                CountTable.from_arrays(
                    i64_to_u64(keys[real]), counts[real], self.k,
                    self.canonical, name=path, presorted=True).save(path)
            except OSError as e:
                error = e
        failed = torch.tensor([error is not None], dtype=torch.int64,
                              device=self.device)
        dist.all_reduce(failed, group=self.group)
        if error is not None:
            raise error
        if int(failed):
            raise OSError("saving %s failed on the first rank" % path)

    @classmethod
    def load(cls, path: str, group=None, device="cuda"
             ) -> "ShardedCountTable":
        """A table saved by :meth:`save`, by km_tpu's ShardedCountTable
        or CountTable (one format), sharded over ``group``."""
        host = CountTable.load(path)
        host.name = path
        return cls(host, group=group, device=device)


# ---------------------------------------------------------------------------
# counting: local count -> runs to their owner -> exact sum at the owner


def owner_of(keys: torch.Tensor, k: int, n_ranks: int) -> torch.Tensor:
    """The rank that owns each real key (0 <= key < 4**k) in counting:
    the top b = ceil(log2 n_ranks) bits of the 2k-bit key, scaled to
    n_ranks. Owners are contiguous key ranges in rank order, so the
    owners' tables concatenated in rank order are sorted. Keys are
    non-negative, so the arithmetic ``>>`` needs no mask; SENTINEL
    (bit 62 set) must be kept out."""
    b = (n_ranks - 1).bit_length()
    top = keys >> (2 * k - b) if 2 * k >= b else keys << (b - 2 * k)
    return torch.clamp((top * n_ranks) >> b, max=n_ranks - 1)


def count_exchange(codes: torch.Tensor, valid: torch.Tensor, k: int,
                   canonical: bool = True, group=None):
    """One counting step over ``group``: this rank's chunk (uint8 codes
    and bool flags on its device) -> the runs of every rank's chunk
    whose keys this rank owns, summed: (keys int64 ascending, counts
    int64 > 0), and the number of runs this rank sent to each owner."""
    check_backend(group, codes.device)
    keys, lengths = count_chunk_device(codes, valid, k, canonical=canonical)
    real = lengths > 0  # run starts of real keys; SENTINEL runs are 0
    keys, lengths = keys[real], lengths[real].to(torch.int64)
    owner = owner_of(keys, k, dist.get_world_size(group))
    recv, _, sent, _ = _exchange(torch.stack([keys, lengths], 1), owner,
                                 group)
    skeys, totals = sum_runs_device(recv[:, 0], recv[:, 1])
    keep = totals > 0
    return skeys[keep], totals[keep], sent


def _rank_chunks(batches, chunk: int, k: int, n_ranks: int, rank: int):
    """This rank's chunk of each group of n_ranks consecutive chunks of
    the stream. The last group is padded with empty chunks, so every
    rank takes the same number of counting steps (km_tpu :400-412)."""
    stream = chunk_stream(_coalesce_batches(batches, k, 4 * chunk), chunk, k)
    mine, i = None, 0
    for i, piece in enumerate(stream, 1):
        if (i - 1) % n_ranks == rank:
            mine = piece
        if i % n_ranks == 0:
            yield mine
            mine = None
    if i % n_ranks:
        yield mine if mine is not None else (np.zeros(chunk, np.uint8),
                                             np.zeros(chunk, bool))


def sharded_count(batches, k: int, group=None, canonical: bool = True,
                  min_count: int = 1, chunk: int = 1 << 18, device="cuda",
                  stats=None):
    """Count k-mers over ``group``: every rank walks the same (codes,
    valid) batches and counts every S-th chunk; the runs go to their
    owner, which merges each step's runs on the host with km_tpu's
    merge_runs. Returns (keys uint64, counts uint32) on the group's
    first rank, like count_batches_host, and None on the others.
    ``stats``, a dict, receives the steps, the runs this rank sent to
    each owner, the seconds of the steps up to the readback of their
    runs (``exchange_s``: count, exchange and sum on the device) and of
    the host merges (``merge_s``)."""
    check_k(k)
    if chunk <= k:
        raise ValueError("chunk must exceed k")
    dev = resolve_device(device)
    S, rank = group_size_rank(group)
    check_backend(group, dev)
    acc_keys = np.empty(0, np.uint64)
    acc_counts = np.empty(0, np.int64)
    sent = np.zeros(S, np.int64)
    steps = 0
    exchange_s = merge_s = 0.0
    for codes, valid in _rank_chunks(batches, chunk, k, S, rank):
        t0 = time.perf_counter()
        keys, counts, to_owner = count_exchange(
            torch.from_numpy(codes).to(dev), torch.from_numpy(valid).to(dev),
            k, canonical=canonical, group=group)
        keys, counts = i64_to_u64(keys.cpu().numpy()), counts.cpu().numpy()
        t1 = time.perf_counter()
        acc_keys, acc_counts = merge_runs(acc_keys, acc_counts, keys, counts)
        merge_s += time.perf_counter() - t1
        exchange_s += t1 - t0
        sent += to_owner
        steps += 1
    if stats is not None:
        stats.update(steps=steps, runs_sent=sent.tolist(),
                     exchange_s=exchange_s, merge_s=merge_s)
    keep = acc_counts >= min_count
    rows = gather_to_first(torch.from_numpy(np.stack(
        [u64_to_i64(acc_keys[keep]), acc_counts[keep]], 1)), dev, group)
    if rows is None:
        return None
    keys, counts = rows.T
    return i64_to_u64(keys), counts.astype(np.uint32)
