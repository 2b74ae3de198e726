"""Overlap graph + double-Dijkstra alternative-path enumeration.

Capability equivalent of km's Graph (reference: km/utils/Graph.py:8-240)
with the same weighting scheme and selection rules:

- every (k-1)-overlap between discovered nodes is an edge of weight 1;
- consecutive target k-mers and the capping edges (source cap -> first
  target k-mer, last target k-mer -> sink cap) are reweighted to 0.01, so
  shortest paths hug the reference except where a variant bridge exists;
- one Dijkstra from the source over the graph and one from the sink over
  the transpose give, for every node, its best predecessor/successor
  (scan-min selection, lowest index on ties, float32 accumulation — matching
  km/utils/Graph.py:63-119 numerics);
- reference edges are deleted from the candidate edge set by walking the
  successor tree (including km's quirk of never deleting the first edge
  of each walk, km/utils/Graph.py:184-198 — this is what makes the
  reference path itself reappear as a candidate and produce Reference
  rows);
- every surviving edge is spliced into predecessor-chain + edge +
  successor-chain; paths that span source->sink are kept and deduplicated.

Representation differs from km: adjacency is sparse — edges live in flat
(src, dst, w) arrays merged last-write-wins into CSR form, never an
N x N dense matrix, and the Dijkstra scan-min runs allocation-free on a
working distance array (visited entries parked at +inf). Spliced paths
reuse memoized predecessor/successor chains instead of re-walking the
trees per edge.
"""

from __future__ import annotations

import logging as log

import numpy as np


class OverlapGraph:
    """Sparse weighted digraph over discovered k-mer nodes + 2 cap nodes."""

    def __init__(self, keys: list[int], k: int):
        """keys: packed node k-mers in node-id order (real nodes only)."""
        self.n_real = len(keys)
        self.n = self.n_real + 2
        self.first_node = self.n_real  # source cap ("BigBang" in km)
        self.last_node = self.n_real + 1  # sink cap ("BigCrunch")
        self.k = k

        # edges as growable parallel arrays; later writes win on merge
        self._src: list[np.ndarray] = []
        self._dst: list[np.ndarray] = []
        self._w: list[np.ndarray] = []

        keys_arr = np.asarray(keys, dtype=np.uint64)
        if self.n_real:
            prefix = keys_arr >> np.uint64(2)
            suffix = keys_arr & np.uint64((1 << (2 * (k - 1))) - 1)
            # node j follows node i iff prefix(key_j) == suffix(key_i)
            order = np.argsort(prefix, kind="stable")
            sp = prefix[order]
            starts = np.searchsorted(sp, suffix, side="left")
            ends = np.searchsorted(sp, suffix, side="right")
            counts = ends - starts
            total = int(counts.sum())
            if total:
                src = np.repeat(np.arange(self.n_real, dtype=np.int64),
                                counts)
                # flat ranges [starts[i], ends[i]) without a Python loop
                flat = (np.arange(total, dtype=np.int64)
                        - np.repeat(np.cumsum(counts) - counts, counts)
                        + np.repeat(starts, counts))
                dst = order[flat]
                keep = src != dst
                src, dst = src[keep], dst[keep]
                self._src.append(src)
                self._dst.append(dst)
                self._w.append(np.ones(len(src), dtype=np.float32))

    def set_edge(self, i: int, j: int, w: float) -> None:
        self._src.append(np.asarray([i], dtype=np.int64))
        self._dst.append(np.asarray([j], dtype=np.int64))
        self._w.append(np.asarray([w], dtype=np.float32))

    def set_edges(self, src, dst, w: float) -> None:
        """Vectorized set_edge over parallel index arrays."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        self._src.append(src)
        self._dst.append(dst)
        self._w.append(np.full(len(src), w, dtype=np.float32))

    def freeze(self) -> None:
        """Merge edge writes (last wins) and build CSR adjacency for the
        forward graph and its transpose."""
        n = self.n
        src = np.concatenate(self._src) if self._src else \
            np.empty(0, np.int64)
        dst = np.concatenate(self._dst) if self._dst else \
            np.empty(0, np.int64)
        w = np.concatenate(self._w) if self._w else np.empty(0, np.float32)

        # last write wins, result sorted by (src, dst) for CSR
        pair = src * n + dst
        _, last_rev = np.unique(pair[::-1], return_index=True)
        keep = len(pair) - 1 - last_rev
        src, dst, w = src[keep], dst[keep], w[keep]

        self.esrc, self.edst = src, dst
        self.edge_set: set[tuple[int, int]] = set(
            zip(src.tolist(), dst.tolist()))

        lens = np.bincount(src, minlength=n)
        self.succ_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=self.succ_ptr[1:])
        self.succ_ids = dst
        self.succ_w = w

        t_order = np.argsort(dst, kind="stable")
        tlens = np.bincount(dst, minlength=n)
        self.pred_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(tlens, out=self.pred_ptr[1:])
        self.pred_ids = src[t_order]
        self.pred_w = w[t_order]

    def _sweep(self, start: int, ptr, ids_flat, w_flat) -> np.ndarray:
        """Scan-min Dijkstra; returns the predecessor array (w.r.t. the
        direction given by the CSR adjacency passed in).

        `work` mirrors `dist` with visited entries parked at +inf, so the
        km scan-min (lowest index among unvisited minima,
        km/utils/Graph.py:91-117) is one argmin over a contiguous array.
        Once the unvisited minimum is +inf no relaxation can improve
        anything (strictly positive weights), so re-scanning a parked
        node is a no-op and the loop stays exactly n iterations.
        """
        from .. import native

        n = self.n
        if native.available():
            return native.dijkstra_scanmin(ptr, ids_flat, w_flat, n, start)
        prev = np.full(n, -1, dtype=np.int32)
        dist = np.full(n, np.inf, dtype=np.float32)
        dist[start] = 0
        work = dist.copy()
        for _ in range(n):
            i = int(work.argmin())
            work[i] = np.inf
            lo, hi = ptr[i], ptr[i + 1]
            if hi > lo:
                ids = ids_flat[lo:hi]
                ndist = w_flat[lo:hi] + dist[i]  # float32, matches km
                better = ndist < dist[ids]
                if better.any():
                    upd = ids[better]
                    nd = ndist[better]
                    dist[upd] = nd
                    work[upd] = nd
                    prev[upd] = i
        return prev

    def init_paths(self) -> None:
        """Build before/after trees and drop reference edges from the
        candidate set (km/utils/Graph.py:121-198 semantics, including the
        first-edge quirk noted in the module docstring)."""
        self.freeze()
        self.set_trees(
            self._sweep(self.first_node, self.succ_ptr, self.succ_ids,
                        self.succ_w),
            self._sweep(self.last_node, self.pred_ptr, self.pred_ids,
                        self.pred_w))

    def set_trees(self, before: np.ndarray, after: np.ndarray) -> None:
        """Install externally computed predecessor/successor trees (the
        batched device sweeps, km_tpu_torch.ops.pathgraph) and finish
        init_paths: ref-edge removal + splice-chain caches. Requires
        freeze() to have run."""
        self.before = before
        self.after = after
        self._before_chain: dict[int, tuple[int, ...]] = {}
        self._after_chain: dict[int, tuple[int, ...]] = {}

        # Lockstep chain walk (vectorized over all reference-path
        # starts): a removed edge is any consecutive pair (c_i, c_i+1)
        # with i >= 1 along an after[]-chain from a start whose
        # before[] is the source cap. NB the `c_i != 0` guard is
        # bug-compatible: km's `last_cur and ...` means node 0 (falsy)
        # never removes its outgoing edge (km/utils/Graph.py:184-198).
        debug = log.getLogger().isEnabledFor(log.DEBUG)
        after = np.asarray(self.after)
        cur = np.unique(np.where(self.before == self.first_node)[0])
        pair_a: list[np.ndarray] = []
        pair_b: list[np.ndarray] = []
        first_step = True
        for _ in range(self.n + 1):
            if not len(cur):
                break
            nxt = after[cur]
            alive = nxt != -1
            if not first_step:
                m = alive & (cur != 0)
                if m.any():
                    pair_a.append(cur[m])
                    pair_b.append(nxt[m])
            first_step = False
            cur = nxt[alive]
        removed = 0
        if pair_a:
            keys = set(zip(np.concatenate(pair_a).tolist(),
                           np.concatenate(pair_b).tolist()))
            hit = self.edge_set & keys
            removed = len(hit)
            if debug:
                for a, b in sorted(hit):
                    log.debug("Removing (%d, %d)", a, b)
            self.edge_set -= hit
        log.info("Removed %d ref edges.", removed)

    def _chain(self, node: int, tree: np.ndarray,
               cache: dict[int, tuple[int, ...]]) -> tuple[int, ...]:
        """Root-first chain (root, ..., node) following `tree` upward,
        memoized across splices."""
        got = cache.get(node)
        if got is not None:
            return got
        stack = []
        cur = node
        while cur not in cache and tree[cur] != -1:
            stack.append(cur)
            cur = int(tree[cur])
        base = cache.get(cur)
        if base is None:
            base = (cur,)
            cache[cur] = base
        for v in reversed(stack):
            base = base + (v,)
            cache[v] = base
        return base

    def _splice(self, a: int, b: int):
        """Shortest source->sink path through edge (a, b), or None."""
        ca = self._chain(a, self.before, self._before_chain)
        if ca[0] != self.first_node:
            return None
        cb = self._chain(b, self.after, self._after_chain)
        if cb[0] != self.last_node:
            return None
        return ca + cb[::-1]

    def all_shortest(self) -> list[tuple[int, ...]]:
        """Unique spliced paths through all surviving candidate edges,
        in deterministic (sorted) order."""
        log.info("%d edges in non-ref edge set.", len(self.edge_set))
        debug = log.getLogger().isEnabledFor(log.DEBUG)
        paths = set()
        for (i, j) in sorted(self.edge_set):
            if debug:
                log.debug("Computing shortest path through edge: (%d, %d)",
                          i, j)
            p = self._splice(i, j)
            if p:
                paths.add(p)
        return sorted(paths)
