"""Batched shortest-path sweeps for alternative-path enumeration (torch).

Replaces km_tpu.ops.pathgraph. Every target's overlap graph needs two
scan-min Dijkstra sweeps (from the source cap over the graph, from the
sink cap over its transpose; reference: km/utils/Graph.py:63-176). A
(k-1)-overlap digraph has out-degree <= 4 plus the cap edges, so each
sweep's adjacency is a fixed-width successor table ``[n, W]``; the
sweeps of many graphs advance in lockstep as one batch ``[B, n, W]``
per (lane width, size class) group, on the table's device.

The iteration is step for step the host spec
(km_tpu.models.pathfinder.OverlapGraph._sweep): extraction is an argmin
over a working distance array whose visited entries are parked at +inf
(the lowest index on ties, as ``torch.argmin`` documents), relaxation a
strict float32 improvement, the predecessor the extracted node. Parked
and unreachable nodes re-extract as no-ops, so a fixed n iterations
equal the spec's loop, and the predecessor trees are equal, not close.

Where it differs from km_tpu, on purpose: successor ids (int64) and
weights (float32) are uploaded as they are, so km_tpu's 16-entry weight
palette, its int16 packing and its "more than 16 weights" host fallback
are gone; the relax step is a ``scatter_reduce(..., "amin")`` into a
fresh +inf row instead of km_tpu's ``[B, W, n+1]`` one-hot (a TPU
workaround; min does not depend on order); no power-of-two padding of
B or n. A graph over MAX_DEVICE_NODES nodes or MAX_WIDTH lanes keeps
km_tpu's logged host sweep, counted in ``batched_sweeps.host_fallbacks``.
"""

from __future__ import annotations

import logging as log

import numpy as np
import torch

from ..utils import graphs as cuda_graphs
from ..utils import profiling

MAX_DEVICE_NODES = 16384  # > km's max_node = 10000 + the two caps
MAX_WIDTH = 64  # degree cap of the fixed-width successor table
SMALL_GRAPH = 512  # graphs up to this size share one group per width
SWEEP_BLOCK = 16  # iterations per CUDA-graph replay
INF = float("inf")


class _Sweeps:
    """The lockstep state of a batch of sweeps: distances, the working
    copy with visited nodes parked at +inf, predecessors; column n is a
    parking slot that empty lanes relax harmlessly."""

    STATE = ("dist", "work", "prev")

    def __init__(self, ids, w, starts):
        B, n, _W = ids.shape
        dev = ids.device
        self.n = n
        self.rows = torch.arange(B, device=dev)
        valid = ids >= 0
        self.sid = torch.where(valid, ids, n)
        self.wt = torch.where(valid, w, INF)
        self.dist = torch.full((B, n + 1), INF, dtype=torch.float32,
                               device=dev)
        self.dist[self.rows, starts] = 0.0
        self.work = self.dist.clone()
        self.prev = torch.full((B, n + 1), -1, dtype=torch.int32, device=dev)
        self.fresh = torch.full_like(self.dist, INF)

    def step(self) -> None:
        rows = self.rows
        i = self.work[:, :self.n].argmin(dim=1)
        work = self.work.index_put((rows, i), self.fresh[:, 0])
        nd = self.wt[rows, i] + self.dist[rows, i].unsqueeze(1)  # float32
        cand = self.fresh.scatter_reduce(1, self.sid[rows, i], nd, "amin")
        better = cand < self.dist
        self.dist = torch.where(better, cand, self.dist)
        self.work = torch.where(better, cand, work)
        self.prev = torch.where(better, i.to(torch.int32).unsqueeze(1),
                                self.prev)


def sweep_kernel(ids: torch.Tensor, w: torch.Tensor, starts: torch.Tensor
                 ) -> torch.Tensor:
    """Lockstep scan-min Dijkstra over a batch of sweeps.

    ids [B, n, W] int64 successor ids (-1 = empty lane), w [B, n, W]
    float32 edge weights, starts [B] int64. Returns the predecessor
    trees [B, n] int32 (-1 = unreached), exactly the host spec's. Past
    SWEEP_BLOCK iterations they run in blocks of SWEEP_BLOCK, one call
    of a ``utils.graphs.Replay`` each, rounding n up to a whole block:
    the extra iterations re-extract parked nodes, which changes
    nothing."""
    sweep_kernel.calls += 1
    sw = _Sweeps(ids, w, starts)
    n = sw.n

    def block():
        for _ in range(SWEEP_BLOCK):
            sw.step()

    if n > SWEEP_BLOCK:
        run = cuda_graphs.Replay(sw, _Sweeps.STATE, block)
        for _ in range(-(-n // SWEEP_BLOCK)):
            run()
    else:
        for _ in range(n):
            sw.step()
    return sw.prev[:, :n]


sweep_kernel.calls = 0


def _pack_bucket(sweeps, n: int, W: int):
    """Many sweeps' CSR adjacencies -> one [B, n, W] successor table
    (ids, -1 for empty lanes) and its weights, in a handful of global
    numpy ops."""
    B = len(sweeps)
    deg = np.concatenate([ptr[1:] - ptr[:-1]
                          for _n, ptr, _i, _w in sweeps]).astype(np.int64)
    rows = np.repeat(np.concatenate([
        s * n + np.arange(g_n, dtype=np.int64)
        for s, (g_n, _p, _i, _w) in enumerate(sweeps)]), deg)
    starts = np.cumsum(deg) - deg
    lane = np.arange(int(deg.sum()), dtype=np.int64) - np.repeat(starts, deg)
    ids = np.full(B * n * W, -1, np.int64)
    wts = np.zeros(B * n * W, np.float32)
    ids[rows * W + lane] = np.concatenate([i for *_, i, _w in sweeps])
    wts[rows * W + lane] = np.concatenate([w_ for *_, w_ in sweeps])
    return ids.reshape(B, n, W), wts.reshape(B, n, W)


def _host_sweeps(g):
    return (g._sweep(g.first_node, g.succ_ptr, g.succ_ids, g.succ_w),
            g._sweep(g.last_node, g.pred_ptr, g.pred_ids, g.pred_w))


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


def batched_sweeps(graphs, device) -> list:
    """Before/after sweeps for a list of frozen OverlapGraphs, one
    lockstep batch per (lane width, size class) group on ``device``;
    returns [(before, after)] int32 numpy pairs aligned with the input.

    Groups never mix lane widths (one wide graph would widen every
    graph's lanes); graphs up to SMALL_GRAPH nodes share a group, larger
    ones keep their power-of-two size class, as in km_tpu."""
    out = [None] * len(graphs)
    groups: dict[tuple[int, int], list[int]] = {}
    for gi, g in enumerate(graphs):
        deg = max(int((g.succ_ptr[1:] - g.succ_ptr[:-1]).max()),
                  int((g.pred_ptr[1:] - g.pred_ptr[:-1]).max())) \
            if g.n else 0
        if g.n > MAX_DEVICE_NODES or deg > MAX_WIDTH:
            log.info("pathgraph: graph (n=%d deg=%d) exceeds the device "
                     "formulation, host sweep", g.n, deg)
            batched_sweeps.host_fallbacks += 1
            out[gi] = _host_sweeps(g)
            continue
        size = 0 if g.n <= SMALL_GRAPH else _pow2(g.n)
        groups.setdefault((max(4, _pow2(deg)), size), []).append(gi)

    # queue every group before the first readback
    pending = []
    for (W, _size), idxs in sorted(groups.items()):
        n = max(graphs[gi].n for gi in idxs)
        sweeps, starts = [], []
        for gi in idxs:
            g = graphs[gi]
            sweeps.append((g.n, g.succ_ptr, g.succ_ids, g.succ_w))
            sweeps.append((g.n, g.pred_ptr, g.pred_ids, g.pred_w))
            starts.extend((g.first_node, g.last_node))
        ids, wts = _pack_bucket(sweeps, n, W)
        prev = sweep_kernel(torch.from_numpy(ids).to(device),
                            torch.from_numpy(wts).to(device),
                            torch.tensor(starts, dtype=torch.int64,
                                         device=device))
        pending.append((idxs, prev))
    for idxs, prev in pending:
        with profiling.phase("sweeps.sync"):
            trees = prev.cpu().numpy()
        for s, gi in enumerate(idxs):
            g = graphs[gi]
            out[gi] = (trees[2 * s, :g.n].copy(),
                       trees[2 * s + 1, :g.n].copy())
    return out


batched_sweeps.host_fallbacks = 0


def batched_alt_paths(finders, device) -> None:
    """The path-enumeration stage of many VariantFinders: graphs built on
    the host, both sweeps of every graph batched on ``device``,
    reference-edge removal and splicing on the host. Sets
    ``finder.alt_paths``."""
    with profiling.phase("graph_host"):
        graphs = []
        for f in finders:
            g = f.build_graph()
            g.freeze()
            graphs.append(g)
    with profiling.phase("sweeps"):
        trees = batched_sweeps(graphs, device)
    with profiling.phase("graph_host"):
        for f, g, (before, after) in zip(finders, graphs, trees):
            g.set_trees(before, after)
            f.paths_from_graph(g)
