"""Graph discovery: depth-first k-mer walking from target anchors.

Semantics reproduced from km's recursive ``__extend``
(reference: km/utils/MutationFinder.py:137-165):

- walk forward from every target k-mer;
- children of a node are the 4-way extensions whose count passes
  ``max(sum_of_candidates * ratio, count)`` (km/utils/Jellyfish.py:55-72);
- a depth budget (``max_stack``), a per-path branching budget
  (``max_break``) and a global node budget (``max_node``) bound the walk;
- a path is committed to the node set only when it reconnects to a known
  node or closes a loop onto itself.

Differences by design: nodes are packed uint64 keys; all 4 child counts
resolve in one vectorized table lookup with memoization; the walk iterates
over target k-mers in *target order* (km iterates a Python string set whose
order is hash-randomized — any order is admissible, this one is
deterministic). The batched multi-target frontier walk lives in
km_tpu_torch.ops.batch_walk; this host walk (the port's copy of
km_tpu/models/walk.py) is the exact-order spec.
"""

from __future__ import annotations

import logging as log

import numpy as np

from ..ops import encode


class NodeBudgetExceeded(SystemExit):
    """Raised (as SystemExit, matching km's hard exit at
    km/utils/MutationFinder.py:143-148) when discovery outgrows max_node."""

    def __init__(self, max_node: int):
        super().__init__(
            "ERROR: Node query count limit exceeded: max={}".format(max_node)
        )


class Walker:
    """DFS discovery over a count table with memoized batched lookups."""

    def __init__(self, table, ratio: float, count: int,
                 max_stack: int = 500, max_break: int = 10,
                 max_node: int = 10000):
        self.table = table
        self.ratio = ratio
        self.count = count
        self.max_stack = max_stack
        self.max_break = max_break
        self.max_node = max_node
        self._child_cache: dict[int, list[int]] = {}
        self._query_cache: dict[int, int] = {}

    def query(self, key: int) -> int:
        c = self._query_cache.get(key)
        if c is None:
            c = int(self.table.query_packed(np.array([key], np.uint64))[0])
            self._query_cache[key] = c
        return c

    def children(self, key: int) -> list[int]:
        """Thresholded forward children (threshold depends on the sum over
        the 4 candidates, so the group resolves together)."""
        ch = self._child_cache.get(key)
        if ch is None:
            ch = self.table.get_child_keys(key, self.ratio, self.count,
                                           forward=True)
            self._child_cache[key] = ch
        return ch

    def discover(self, ref_mers: np.ndarray) -> dict[int, int]:
        """Run the walk; returns {packed_kmer: count} in insertion order
        (target k-mers first, then committed path nodes in commit order)."""
        node_data: dict[int, int] = {}
        for m in ref_mers:
            node_data[int(m)] = self.query(int(m))
        log.info("Ref. set contains %d kmers.", len(node_data))

        for m in ref_mers:
            self._extend(node_data, int(m))
        return node_data

    def _extend(self, node_data: dict[int, int], start: int) -> None:
        """Iterative DFS, check-for-check equivalent to km's recursion.

        Frame i iterates the children of stack[i]; a frame records the
        ``breaks`` budget its call level carries.
        """
        # --- call entry for __extend([start], 0) ---
        if self.max_stack < 1:
            return
        if len(node_data) > self.max_node:
            raise NodeBudgetExceeded(self.max_node)
        stack = [start]
        on_stack = {start}
        children = self.children(start)
        breaks = 1 if len(children) > 1 else 0
        if len(children) > 1 and breaks > self.max_break:
            return
        frames: list[list] = [[children, 0, breaks]]

        while frames:
            frame = frames[-1]
            if frame[1] >= len(frame[0]):
                frames.pop()
                on_stack.discard(stack.pop())
                continue
            child = frame[0][frame[1]]
            frame[1] += 1

            if child in node_data or child in on_stack:
                if child in on_stack and child not in node_data:
                    log.info("Broke loop at kmer: %s",
                             encode.unpack_kmer(child, self.table.k))
                for p in stack:
                    node_data[p] = self.query(p)
                continue

            # --- call entry for __extend(stack + [child], breaks) ---
            if len(stack) + 1 > self.max_stack:
                continue
            if len(node_data) > self.max_node:
                raise NodeBudgetExceeded(self.max_node)
            ch = self.children(child)
            nb = frame[2] + 1 if len(ch) > 1 else frame[2]
            if len(ch) > 1 and nb > self.max_break:
                continue
            stack.append(child)
            on_stack.add(child)
            frames.append([ch, 0, nb])
