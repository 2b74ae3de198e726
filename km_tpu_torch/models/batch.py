"""Batched catalog analysis over the torch count table.

Replaces km_tpu.models.batch. With a torch DeviceCountTable the three
device programs run on the table's device, as km_tpu's do on its
accelerator: the walk (ops.batch_walk.device_discover), the Dijkstra
sweeps of every target's graph (ops.pathgraph) and the NNLS refinement
of every quantification problem (ops.nnls). Graph building, path
splicing, classification and row output run in the port's host modules
(models/{finder,pathfinder,quant,classify}.py) per target.
``walk='host'`` keeps the host-orchestrated frontier walk, in which
every active walklet advances one step per round and each round's child
lookups resolve in one batched call on the table's device.
"""

from __future__ import annotations

import sys

import numpy as np

from ..device import to_device_keys, to_host_keys
from ..ops.device_table import DeviceCountTable
from ..utils import profiling
from .finder import VariantFinder
from .sequence import TargetSeq
from .walk import NodeBudgetExceeded


class _BatchLookup:
    """Uniform child-expansion front-end over host or torch tables."""

    def __init__(self, table, ratio, count):
        self.ratio = ratio
        self.count = count
        self.is_device = isinstance(table, DeviceCountTable)
        self.table = table

    def children(self, tips: np.ndarray):
        """tips (n,) uint64 -> (child_keys (n,4) uint64, mask (n,4))."""
        if self.is_device:
            q = to_device_keys(tips, self.table.device)
            ck, _cnt, mask = self.table.children(q, self.ratio, self.count)
            return to_host_keys(ck), mask.cpu().numpy()
        ck, cc = self.table.children_packed(tips)
        sums = cc.sum(axis=-1, keepdims=True)
        thr = np.maximum(sums.astype(np.float64) * self.ratio, self.count)
        return ck, cc >= thr

    def query(self, keys: np.ndarray) -> np.ndarray:
        return np.asarray(self.table.query_packed(keys)).astype(np.int64)


def batch_discover(targets: list[TargetSeq], table, ratio=0.05, count=5,
                   max_stack=500, max_break=10, max_node=10000,
                   on_budget: str = "raise"):
    """Frontier walk over many targets; returns per-target ordered
    {kmer: count} dicts (target k-mers first, then commits).

    on_budget: 'raise' mirrors the sequential CLI (km hard-exits,
    km/utils/MutationFinder.py:143-148); 'skip' makes only the target
    that outgrew max_node yield None, like the reference's per-target
    shell loop."""
    lut = _BatchLookup(table, ratio, count)
    failed: set[int] = set()

    node_sets: list[set[int]] = []
    node_order: list[list[int]] = []
    for ti, t in enumerate(targets):
        mers = [int(m) for m in t.ref_mer]
        node_sets.append(set(mers))
        node_order.append(list(mers))
        # the sequential engine's first budget check, before any step
        # (km_tpu's batch walk reads the budget only after a commit)
        if len(node_sets[ti]) > max_node:
            if on_budget == "raise":
                raise NodeBudgetExceeded(max_node)
            failed.add(ti)

    # walklet state (parallel lists; stacks as python lists of ints)
    tgt: list[int] = []
    stacks: list[list[int]] = []
    breaks: list[int] = []
    for ti, t in enumerate(targets):
        if ti in failed:
            continue
        for m in t.ref_mer:
            tgt.append(ti)
            stacks.append([int(m)])
            breaks.append(0)

    while tgt:
        tips = np.array([s[-1] for s in stacks], dtype=np.uint64)
        child_keys, mask = lut.children(tips)

        new_tgt: list[int] = []
        new_stacks: list[list[int]] = []
        new_breaks: list[int] = []
        commits: list[tuple[int, list[int]]] = []  # (target, stack)

        for w in range(len(tgt)):
            ti = tgt[w]
            if ti in failed:
                continue
            kids = [int(child_keys[w, j]) for j in range(4) if mask[w, j]]
            b = breaks[w]
            if len(kids) > 1:
                b += 1
                if b > max_break:
                    continue
            stack = stacks[w]
            known = node_sets[ti]
            on_stack = set(stack)
            for child in kids:
                if child in known or child in on_stack:
                    commits.append((ti, stack))
                else:
                    if len(stack) + 1 > max_stack:
                        continue
                    new_tgt.append(ti)
                    new_stacks.append(stack + [child])
                    new_breaks.append(b)

        # apply commits at round end (round-synchronous node-set growth)
        for ti, stack in commits:
            if ti in failed:
                continue
            ns, order = node_sets[ti], node_order[ti]
            for p in stack:
                if p not in ns:
                    ns.add(p)
                    order.append(p)
            if len(order) > max_node:
                if on_budget == "raise":
                    raise NodeBudgetExceeded(max_node)
                failed.add(ti)

        tgt, stacks, breaks = new_tgt, new_stacks, new_breaks

    # resolve counts for every node, one batched query per target
    results = []
    for ti, order in enumerate(node_order):
        if ti in failed:
            results.append(None)
            continue
        keys = np.array(order, dtype=np.uint64)
        counts = lut.query(keys)
        results.append({int(k): int(c) for k, c in zip(keys, counts)})
    return results


class PrecomputedWalker:
    """Adapter letting VariantFinder consume a precomputed node set."""

    def __init__(self, node_data: dict[int, int]):
        self._node_data = node_data

    def discover(self, _ref_mers):
        return self._node_data


def _choose(name: str, value: str, default: str) -> str:
    if value == "auto":
        return default
    if value not in ("host", "device"):
        raise ValueError("%s must be 'auto', 'host' or 'device'; got %r"
                         % (name, value))
    return value


def run_catalog(targets: list[TargetSeq], table, ratio=0.05, count=5,
                max_stack=500, max_break=10, max_node=10000,
                walk: str = "auto", quant: str = "auto",
                pathing: str = "auto", graphical: bool = False,
                on_budget: str = "raise"):
    """Full batched pipeline: walk, then graph / path enumeration /
    quantification / classification across all targets. Returns one
    sorted row list per target.

    ``table`` is a torch DeviceCountTable or a km_tpu host CountTable.
    walk: 'device' = the walk on the table's device (ops.batch_walk),
    'host' = host-orchestrated rounds, 'auto' = device for a torch
    table, host for a host table (km_tpu.models.batch's rule).
    pathing: 'device' = every target's sweeps batched on the device
    (ops.pathgraph), 'host' = per-target host sweeps, 'auto' = follow
    walk. quant: 'device' = every problem's refinement batched on the
    device (ops.nnls), 'host' = per-problem spec NNLS, 'auto' = follow
    walk. A device choice needs a torch table. on_budget: 'raise' = a
    max_node overrun aborts the whole call like the sequential CLI;
    'skip' = the overrunning target alone yields an empty row list, with
    km's error line on stderr."""
    on_device = isinstance(table, DeviceCountTable)
    walk = _choose("walk", walk, "device" if on_device else "host")
    quant = _choose("quant", quant, walk)
    pathing = _choose("pathing", pathing, walk)
    if not on_device and "device" in (walk, quant, pathing):
        raise ValueError("walk/pathing/quant='device' needs a torch "
                         "DeviceCountTable; got %s" % type(table).__name__)
    fetch_counts = None
    with profiling.phase("walk"):
        if walk == "device":
            from ..ops.batch_walk import device_discover

            # the count lookup is queued inside device_discover and read
            # back after graph building and path enumeration
            orders, fetch_counts = device_discover(
                [t.ref_mer for t in targets], table, ratio=ratio,
                count=count, max_stack=max_stack, max_break=max_break,
                max_node=max_node, on_budget=on_budget, defer_counts=True)
            node_datas = [None if o is None else dict.fromkeys(o, 0)
                          for o in orders]
        else:
            node_datas = batch_discover(
                targets, table, ratio=ratio, count=count,
                max_stack=max_stack, max_break=max_break,
                max_node=max_node, on_budget=on_budget)

    finders = []
    with profiling.phase("graph_host"):
        for target, node_data in zip(targets, node_datas):
            if node_data is None:  # only possible with on_budget='skip'
                sys.stderr.write(
                    "ERROR: Node query count limit exceeded: max={} "
                    "(target {}; skipped, batch continues)\n".format(
                        max_node, target.name))
                finders.append(None)
                continue
            finders.append(finder_from_nodes(target, table, node_data))
    live = [f for f in finders if f is not None]
    if pathing == "device":
        from ..ops.pathgraph import batched_alt_paths

        batched_alt_paths(live, table.device)
    else:
        with profiling.phase("graph_host"):
            for finder in live:
                finder.find_alt_paths()

    if fetch_counts is not None:
        with profiling.phase("walk"):
            for finder, node_data in zip(finders, fetch_counts()):
                if finder is not None:
                    finder.counts = list(node_data.values()) + [-1, -1]

    if quant == "device" and not graphical:
        from ..ops import nnls

        jobs, emits, prewarms = [], [], []
        with profiling.phase("nnls"):
            for finder in live:
                for paths, emit, prewarm in finder.quant_jobs():
                    jobs.append((paths, finder.counts))
                    emits.append(emit)
                    prewarms.append(prewarm)
            fetch = nnls.solve_batch(jobs, table.device, defer=True)
        # classification and sequence strings need no coefficients: they
        # run while the queued refinement runs on the device
        with profiling.phase("rows"):
            for prewarm in prewarms:
                prewarm()
        with profiling.phase("nnls"):
            solutions = fetch()
        with profiling.phase("rows"):
            for emit, (coef, rvaf) in zip(emits, solutions):
                emit(coef, rvaf)
    else:
        with profiling.phase("quant_host"):
            for finder in live:
                finder.quantify_paths(graphical)
                finder.quantify_clusters(graphical)
    return [finder.sorted_rows() if finder is not None else []
            for finder in finders]


def finder_from_nodes(target: TargetSeq, table, node_data: dict[int, int]):
    """Build a VariantFinder from an externally discovered node set."""
    finder = VariantFinder.__new__(VariantFinder)
    finder.target = target
    finder.table = table
    finder.k = table.k
    finder.keys = list(node_data.keys())
    finder.counts = list(node_data.values()) + [-1, -1]
    finder.num_k = len(finder.keys) + 2
    finder._node_index = {key: i for i, key in enumerate(finder.keys)}
    target.set_index(finder._node_index)
    finder.start_ix = finder._node_index[target.first_kmer]
    finder.end_ix = finder._node_index[target.last_kmer]
    finder.rows = []
    finder.alt_paths = None
    return finder
