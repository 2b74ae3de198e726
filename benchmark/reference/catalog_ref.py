"""The catalog's plain reference: km's find_mutation, written plainly
from the published algorithm, one target at a time, on a host table of
the same records.

Nothing here comes from the program: k-mers are strings, the walk is
km's recursion, the graph is km's dense matrix with its heapless
Dijkstra, the fit is km's least squares and gradient refinement, and
the rows are named and sorted as km's ``find_mutation`` prints them
(km/utils/MutationFinder.py, Graph.py, PathQuant.py, Jellyfish.py,
common.py). Where km leaves an order open (it walks from a hash-ordered
set of k-mers), the target's order is taken. A target whose walk
outgrows ``nodes`` yields no rows, as the program's ``on_budget='skip'``
does. The golden rows of the bundled samples (tests/golden) witness it.
"""

from __future__ import annotations

import re
import sys

import numpy as np

_TO_DIGITS = str.maketrans("ACGT", "0123")
_COMPLEMENT = str.maketrans("ACGT", "TGCA")


def revcomp(s: str) -> str:
    return s.translate(_COMPLEMENT)[::-1]


class HostTable:
    """k-mer counts: keys uint64 ascending (two bits a base, the first
    base highest), looked up by binary search."""

    def __init__(self, keys: np.ndarray, counts: np.ndarray, k: int,
                 canonical: bool, name: str):
        self.keys = np.ascontiguousarray(keys, np.uint64)
        self.counts = np.asarray(counts)
        self.k, self.canonical, self.name = k, canonical, name
        self._memo: dict[str, int] = {}

    def query(self, kmer: str) -> int:
        got = self._memo.get(kmer)
        if got is None:
            s = min(kmer, revcomp(kmer)) if self.canonical else kmer
            key = np.uint64(int(s.translate(_TO_DIGITS), 4))
            i = int(np.searchsorted(self.keys, key))
            got = int(self.counts[i]) if i < len(self.keys) and \
                self.keys[i] == key else 0
            self._memo[kmer] = got
        return got

    def children(self, kmer: str, ratio: float, count: int) -> list[str]:
        """km's Jellyfish.get_child: the four one-base extensions whose
        count reaches max(sum of the four * ratio, count)."""
        ext = [kmer[1:] + b for b in "ACGT"]
        n = [self.query(s) for s in ext]
        threshold = max(float(sum(n)) * ratio, count)
        return [s for s, c in zip(ext, n) if c >= threshold]


class NodeBudget(Exception):
    pass


def walk(ref: list[str], table: HostTable, p: dict) -> dict[str, int]:
    """The k-mers of the target's graph and their counts, in the order
    they joined it: the target's own, then each extension from them that
    reconnects to the graph or closes a loop (km's ``__extend``)."""
    done = {m: table.query(m) for m in ref}

    def extend(stack: list[str], on_stack: set, breaks: int) -> None:
        if len(stack) > p["steps"]:
            return
        if len(done) > p["nodes"]:
            raise NodeBudget
        children = table.children(stack[-1], p["ratio"], p["count"])
        if len(children) > 1:
            breaks += 1
            if breaks > p["branchs"]:
                return
        for child in children:
            if child in done or child in on_stack:
                for m in stack:
                    if m not in done:
                        done[m] = table.query(m)
            else:
                stack.append(child)
                on_stack.add(child)
                extend(stack, on_stack, breaks)
                on_stack.discard(stack.pop())

    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 2 * p["steps"] + 100))
    try:
        for m in ref:
            extend([m], {m}, 0)
    finally:
        sys.setrecursionlimit(limit)
    return done


def dijkstra(w: np.ndarray, start: int) -> np.ndarray:
    """Predecessors of a scan-min Dijkstra over the dense float32 weights
    ``w`` (inf: no edge); of equal distances the lowest node goes first."""
    n = len(w)
    dist = np.full(n, np.inf, np.float32)
    dist[start] = 0
    prev = np.full(n, -1, np.int64)
    seen = np.zeros(n, bool)
    for _ in range(n):
        i = int(np.argmin(np.where(seen, np.inf, dist)))
        if seen[i] or dist[i] == np.inf:
            break
        seen[i] = True
        nd = w[i] + dist[i]
        better = nd < dist
        dist[better] = nd[better]
        prev[better] = i
    return prev


def chain(node: int, tree: np.ndarray) -> list[int]:
    """node, tree[node], ... up to the root."""
    out = [node]
    while tree[out[-1]] != -1:
        out.append(int(tree[out[-1]]))
    return out


def alt_paths(kmers: list[str], ref_ix: list[int]) -> list[list[int]]:
    """km's Graph: every (k-1)-overlap an edge of weight 1, the target's
    own edges and the two caps' 0.01; Dijkstra from the source cap and,
    on the transpose, from the sink cap; the edges along the target's
    successor chain taken out (km keeps its first, and any edge out of
    node 0); then the shortest source-to-sink path through each edge
    left, caps stripped."""
    n = len(kmers) + 2
    src, snk = n - 2, n - 1
    w = np.full((n, n), np.inf, np.float32)
    by_prefix: dict[str, list[int]] = {}
    for j, m in enumerate(kmers):
        by_prefix.setdefault(m[:-1], []).append(j)
    for i, m in enumerate(kmers):
        for j in by_prefix.get(m[1:], ()):
            if i != j:
                w[i, j] = 1
    for a, b in zip(ref_ix[:-1], ref_ix[1:]):
        w[a, b] = 0.01
    w[src, ref_ix[0]] = 0.01
    w[ref_ix[-1], snk] = 0.01
    edges = set(zip(*(x.tolist() for x in np.nonzero(np.isfinite(w)))))
    before = dijkstra(w, src)
    after = dijkstra(np.ascontiguousarray(w.T), snk)
    for start in np.flatnonzero(before == src).tolist():
        c = chain(start, after)
        for a, b in zip(c[1:-1], c[2:]):
            if a != 0:
                edges.discard((a, b))
    paths = set()
    for a, b in sorted(edges):
        head, tail = chain(a, before), chain(b, after)
        if head[-1] == src and tail[-1] == snk:
            paths.add(tuple(head[::-1] + tail))
    return [list(p[1:-1]) for p in sorted(paths)]


def fit(paths: list[list[int]], counts: np.ndarray, dtype
        ) -> tuple[np.ndarray, np.ndarray]:
    """km's PathQuant: each path a column of how often it holds each
    node; least squares, then projected gradient steps of a tenth of the
    mean gradient until no gradient exceeds 0.01; the ratios of the
    coefficients."""
    n = len(counts)
    contrib = np.zeros((n, len(paths)), np.int32)
    for j, path in enumerate(paths):
        for i in path:
            contrib[i, j] += 1
    a, y = contrib.astype(dtype), counts.astype(dtype)
    coef = np.linalg.lstsq(a, y, rcond=None)[0].astype(dtype)
    coef[coef < 0] = 0
    step = np.inf
    while step > 0.01:
        grad = (2 * (y - a @ coef) * a.T).sum(axis=1) / n
        coef += 0.1 * grad
        grad[coef < 0] = 0
        coef[coef < 0] = 0
        step = np.max(np.abs(grad))
    ratio = coef if max(coef) == 0 else coef / np.sum(coef)
    return coef, ratio


class Diff:
    """km's diff_path_without_overlap: the common prefix, the common
    suffix stopped k short of it, and the suffix scan allowed to overlap
    it (an ITD's scan reaches the prefix)."""

    def __init__(self, ref: list[int], alt: list[int], k: int):
        i = 0
        while i < len(ref) and i < len(alt) and ref[i] == alt[i]:
            i += 1
        r, a = len(ref), len(alt)
        while r >= i + k and a >= i + k and ref[r - 1] == alt[a - 1]:
            r, a = r - 1, a - 1
        ro, ao = r, a
        while ro > i and ref[ro - 1] == alt[ao - 1]:
            ro, ao = ro - 1, ao - 1
        self.start, self.end_ref, self.end_var, self.end_overlap = \
            i, r, a, ro
        self.removed, self.added = ref[i:r], alt[i:a]


def spell(kmers: list[str], path, whole: bool) -> str:
    """The bases of a path of k-mers; without ``whole``, only the last
    base of each."""
    if not len(path):
        return ""
    tail = "".join(kmers[i][-1] for i in path[1:])
    return (kmers[path[0]] if whole else kmers[path[0]][-1]) + tail


def name(kmers: list[str], ref: list[int], alt: list[int], k: int,
         offset: int) -> str:
    """km's get_name: ``Type\\tstart:removed/ADDED:end``."""
    d = Diff(ref, alt, k)
    if len(ref) - len(d.removed) + len(d.added) != len(alt):
        raise ValueError("mutation identification could be incorrect")
    rem = spell(kmers, d.removed, False)
    add = spell(kmers, d.added, False)
    n = 0
    if rem:
        while rem[-(n + 1):] == add[-(n + 1):]:
            n += 1
    if n:
        rem, add = rem[:-n], add[:-n]
    if d.end_ref == d.end_var:
        kind = "Reference" if d.start == d.end_ref else "Substitution"
    elif d.start == d.end_overlap:
        kind = "ITD"
    elif d.end_ref < d.end_var and not rem:
        kind = "Insertion"
    elif d.end_ref > d.end_var and not add:
        kind = "Deletion"
    else:
        kind = "Indel"
    if kind == "Reference":
        return "Reference\t"
    return "%s\t%d:%s/%s:%d" % (kind, d.start + k + offset, rem.lower(),
                               add, d.end_ref + 1 + offset)


class Row:
    """One row of find_mutation's table; ``str`` prints it."""

    def __init__(self, db, query, variant, rvaf, expression, min_cov,
                 offset, seq, ref_expression, ref_seq, info):
        self.fields = (db, query, variant, rvaf, expression, min_cov,
                       offset, seq, ref_expression, ref_seq, info)
        self.rVAF, self.expression = rvaf, expression
        self.ref_expression = ref_expression

    def __str__(self):
        return "%s\t%s\t%s\t%.3f\t%.1f\t%d\t%d\t%s\t%.1f\t%s\t%s" % \
            self.fields


def _natural(s: str) -> list:
    return [int(t) if t.isdigit() else t.lower()
            for t in re.split(r"([0-9]+)", s)]


def ordered(rows: list[Row]) -> list[Row]:
    """km's get_paths(sort=True): by the Info words (the first one
    descending, so vs_ref before cluster), then query, variant name,
    type and minimum coverage, each in natural order."""
    def words(r):
        f = str(r).split("\t")
        return f[11].split(" ") + [f[1], f[3], f[2], f[6]]

    rest = sorted(rows, key=lambda r: [_natural(w) for w in words(r)[1:]])
    return sorted(rest, key=lambda r: _natural(words(r)[0]), reverse=True)


def target_rows(seq: str, query: str, table: HostTable, p: dict,
                dtype=np.float64) -> list[Row]:
    k = table.k
    ref = [seq[i:i + k] for i in range(len(seq) - k + 1)]
    if len(set(ref)) != len(ref):
        raise ValueError("a k-mer repeats in target %s" % query)
    try:
        nodes = walk(ref, table, p)
    except NodeBudget:
        return []
    kmers = list(nodes)
    index = {m: i for i, m in enumerate(kmers)}
    ref_ix = [index[m] for m in ref]
    counts = np.array(list(nodes.values()) + [-1, -1], np.float32)
    paths = alt_paths(kmers, ref_ix)
    rows = []

    def row(alt, ref_path, offset, coef, ratio, j, r, info):
        rows.append(Row(
            table.name, query, name(kmers, ref_path, alt, k, offset),
            ratio[j], coef[j], int(min(counts[alt])), offset,
            spell(kmers, alt, True), coef[r], spell(kmers, ref_path, True),
            info))

    for alt in paths:
        coef, ratio = fit([alt, ref_ix], counts, dtype)
        if alt == ref_ix:
            # km reports no split for the target itself, and as its
            # expression the least count of the graph (the caps' -1)
            ratio = np.full(2, np.nan)
            coef = np.where(coef >= 0, counts.min(), coef)
        row(alt, ref_ix, 0, coef, ratio, 0, 1, "vs_ref")
    for i, (ref_path, clipped, offset) in enumerate(clusters(paths, ref_ix,
                                                             k)):
        coef, ratio = fit([ref_path] + clipped, counts, dtype)
        for j, alt in enumerate(clipped):
            row(alt, ref_path, offset, coef, ratio, j + 1, 0,
                "cluster %d n=%d" % (i + 1, len(clipped)))
    return ordered(rows)


def clusters(paths, ref_ix, k):
    """km's _find_clusters: from the lowest variant not yet taken, take
    in the lowest that overlaps the growing window, leaving out ITDs that
    sit on its right edge; each group's paths cut to the window, widened
    on the left by the group's largest change of length."""
    diffs = [Diff(ref_ix, p, k) for p in paths]
    left = list(range(len(paths)))
    while left:
        first = left.pop(0)
        group = [first]
        lo, hi = diffs[first].start, diffs[first].end_ref
        while True:
            for v in left:
                d = diffs[v]
                if d.end_ref < lo or d.start > hi:
                    continue
                point = d.start == d.end_ref
                if lo == hi and point and lo == d.start:
                    continue
                if hi == d.end_ref and (lo == hi or point):
                    continue
                break
            else:
                break
            left.remove(v)
            group.append(v)
            lo, hi = min(lo, diffs[v].start), max(hi, diffs[v].end_ref)
        if len(group) == 1 and paths[first] == ref_ix:
            continue
        margin = max(abs(diffs[v].end_var - diffs[v].end_ref + 1)
                     for v in group)
        offset = max(0, lo - margin)
        yield (ref_ix[offset:hi],
               [paths[v][offset:diffs[v].end_var + hi - diffs[v].end_ref]
                for v in group], offset)


def catalog_rows(sequences, table: HostTable, params: dict,
                 dtype=np.float64) -> list[list[Row]]:
    """One sorted row list per (sequence, name) target; ``dtype`` is the
    precision of the fit (the control's is float32)."""
    return [target_rows(seq, query, table, params, dtype)
            for seq, query in sequences]
