"""VariantFinder: end-to-end analysis of one target against one count
table — discovery walk, overlap graph, alternative-path enumeration,
quantification (individual + clustered), classification and row output.

Orchestration equivalent of km's MutationFinder
(reference: km/utils/MutationFinder.py:87-833), rebuilt on packed-key
sequences, sparse graphs and batched lookups. Scientific semantics are
preserved rule-for-rule; see the per-module docstrings for the exact
correspondences.
"""

from __future__ import annotations

import logging as log

import numpy as np

from ..utils.natsort import natsortkey
from . import classify, quant
from .pathfinder import OverlapGraph
from .quant import PathRow
from .sequence import TargetSeq
from .walk import Walker


class VariantFinder:
    def __init__(self, target: TargetSeq, table, ratio=0.05, count=5,
                 max_stack=500, max_break=10, max_node=10000):
        self.target = target
        self.table = table
        self.k = table.k

        walker = Walker(table, ratio=ratio, count=count, max_stack=max_stack,
                        max_break=max_break, max_node=max_node)
        node_data = walker.discover(target.ref_mer)

        # node-id space: discovered k-mers in insertion order, then the two
        # cap nodes (source, sink) — counts use a -1 sentinel for caps,
        # deliberately kept inside the quantification count vector exactly
        # like km (MutationFinder.py:122-123).
        self.keys = list(node_data.keys())
        self.counts = list(node_data.values()) + [-1, -1]
        self.num_k = len(self.keys) + 2
        log.info("k-mer graph contains %d nodes.", self.num_k)

        self._node_index = {key: i for i, key in enumerate(self.keys)}
        self.target.set_index(self._node_index)
        self.start_ix = self._node_index[target.first_kmer]
        self.end_ix = self._node_index[target.last_kmer]
        self.rows: list[PathRow] = []
        self.alt_paths: list[tuple[int, ...]] | None = None

    # -- graph -------------------------------------------------------------

    def build_graph(self) -> OverlapGraph:
        """Weighted overlap graph of this target's node set (unfrozen)."""
        g = OverlapGraph(self.keys, self.k)
        ref_ix = self.target.seq_index
        if len(ref_ix) > 1:
            g.set_edges(ref_ix[:-1], ref_ix[1:], 0.01)
        g.set_edge(g.first_node, self.start_ix, 0.01)
        g.set_edge(self.end_ix, g.last_node, 0.01)
        return g

    def paths_from_graph(self, g: OverlapGraph) -> None:
        """Enumerate candidate paths from an initialized graph; strips
        the cap nodes from the spliced paths."""
        self.alt_paths = [p[1:-1] for p in g.all_shortest()]

    def find_alt_paths(self) -> None:
        """Build the overlap graph and enumerate candidate paths."""
        g = self.build_graph()
        g.init_paths()
        self.paths_from_graph(g)

    # -- helpers -----------------------------------------------------------

    def path_counts(self, path) -> list[int]:
        return [self.counts[i] for i in path]

    def _keys_arr(self) -> np.ndarray:
        """Packed node keys as one cached uint64 array (sequence
        materialization gathers from it instead of walking the list)."""
        a = getattr(self, "_keys_np", None)
        if a is None or len(a) != len(self.keys):
            a = np.fromiter(self.keys, dtype=np.uint64,
                            count=len(self.keys))
            self._keys_np = a
        return a

    def path_seq(self, path, skip_prefix=True) -> str:
        cache = self.__dict__.setdefault("_seq_cache", {})
        key = (tuple(path), skip_prefix)
        got = cache.get(key)
        if got is None:
            got = classify.merge_kmers(self._keys_arr(), path, self.k,
                                       skip_prefix=skip_prefix)
            cache[key] = got
        return got

    def variant_name(self, ref_ix, path_ix, offset=0) -> str:
        cache = self.__dict__.setdefault("_name_cache", {})
        key = (tuple(ref_ix), tuple(path_ix), offset)
        got = cache.get(key)
        if got is None:
            got = classify.name_variant(self._keys_arr(), ref_ix,
                                        path_ix, self.k, offset=offset)
            cache[key] = got
        return got

    # -- quantification ----------------------------------------------------

    def quantify_paths(self, graphical: bool = False) -> None:
        """Quantify each alternative path independently against the
        reference path (Info tag ``vs_ref``)."""
        assert self.alt_paths is not None, "call find_alt_paths() first"
        ref_ix = self.target.seq_index

        if graphical:
            self._plot_paths()

        for alt_ix in self.alt_paths:
            log.info("Quantifying %s", self.target.name)
            coef, rvaf = quant.quantify([alt_ix, ref_ix], self.counts)
            self._emit_vs_ref(alt_ix, coef, rvaf)

    def _emit_vs_ref(self, alt_ix, coef, rvaf) -> None:
        """Append the ``vs_ref`` row for one quantified alt path."""
        ref_ix = self.target.seq_index
        if alt_ix == ref_ix:
            coef, rvaf = quant.reference_adjust(coef, rvaf, self.counts)
        self.rows.append(PathRow(
            self.table.name, self.target.name,
            self.variant_name(ref_ix, alt_ix),
            rvaf[0], coef[0], min(self.path_counts(alt_ix)), 0,
            self.path_seq(alt_ix, skip_prefix=False),
            rvaf[1], coef[1],
            self.path_seq(ref_ix, skip_prefix=False),
            "vs_ref",
        ))

    @staticmethod
    def _joins_cluster(window, d) -> bool:
        """Does a variant spanning [d.start, d.end_ref] belong in the
        cluster window? Interval overlap, except degenerate ITD
        placements at the window's right edge, which km excludes from
        clustering (spec: km/utils/MutationFinder.py:666-679)."""
        lo, hi = window
        if d.end_ref < lo or d.start > hi:
            return False
        zero_span = d.start == d.end_ref
        if lo == hi and zero_span and lo == d.start:
            log.info("Terminal ITD ignored in cluster mode.")
        elif hi == d.end_ref and (lo == hi or zero_span):
            log.info("Quasi-terminal ITD ignored in cluster mode.")
        else:
            return True
        return False

    def _find_clusters(self, alt_paths):
        """Group overlapping variants, then clip each group's reference
        and alt paths to a shared window around the affected region.

        PROVENANCE NOTE — spec behavior: the grouping rule (grow a
        window from the lowest unassigned variant, absorbing the lowest
        overlapper each step), the ITD exclusions, and the window
        arithmetic below must match km/utils/MutationFinder.py:651-723
        because cluster numbering and the clipped quantification
        windows feed the byte-exact report contract.
        """
        ref_ix = self.target.seq_index
        diffs = [classify.diff_paths(ref_ix, p, self.k) for p in alt_paths]
        pool = set(range(len(alt_paths)))

        while pool:
            seed = min(pool)
            pool.discard(seed)
            members = [seed]
            window = (diffs[seed].start, diffs[seed].end_ref)
            while True:
                nxt = next((v for v in sorted(pool)
                            if self._joins_cluster(window, diffs[v])),
                           None)
                if nxt is None:
                    break
                pool.remove(nxt)
                members.append(nxt)
                window = (min(window[0], diffs[nxt].start),
                          max(window[1], diffs[nxt].end_ref))

            if len(members) == 1 and alt_paths[seed] == ref_ix:
                continue  # a lone pure-reference path is not a cluster
            lo, hi = window
            # left margin: the largest length change in the group
            margin = max(abs(diffs[v].end_var - diffs[v].end_ref + 1)
                         for v in members)
            offset = max(0, lo - margin)
            clipped = [tuple(alt_paths[v][offset:
                             diffs[v].end_var + hi - diffs[v].end_ref])
                       for v in members]
            yield (tuple(ref_ix[offset:hi]), clipped, offset)

    def quantify_clusters(self, graphical: bool = False) -> None:
        """Joint quantification of overlapping variants on clipped
        windows (Info tag ``cluster i n=j``)."""
        assert self.alt_paths is not None, "call find_alt_paths() first"
        clusters = list(self._find_clusters(self.alt_paths))

        for i, (ref_path, clipped, start_off) in enumerate(clusters):
            log.info("Quantifying %s in cluster mode", self.target.name)
            if graphical:
                self._plot_cluster(ref_path, clipped, start_off)

            coef, rvaf = quant.quantify([ref_path] + clipped, self.counts)
            self._emit_cluster(i + 1, ref_path, clipped, start_off, coef,
                               rvaf)

    def _emit_cluster(self, num_cluster, ref_path, clipped, start_off,
                      coef, rvaf) -> None:
        """Append the rows for one jointly quantified cluster."""
        for j, path in enumerate(clipped):
            assert path != ref_path
            self.rows.append(PathRow(
                self.table.name, self.target.name,
                self.variant_name(ref_path, path, start_off),
                rvaf[1 + j], coef[1 + j], min(self.path_counts(path)),
                start_off, self.path_seq(path, skip_prefix=False),
                rvaf[0], coef[0],
                self.path_seq(ref_path, skip_prefix=False),
                "cluster %d n=%d" % (num_cluster, len(clipped)),
            ))

    def quant_jobs(self):
        """Quantification problems of this target as (paths, emit) pairs:
        ``paths`` is the path list to fit jointly, ``emit(coef, rvaf)``
        appends the resulting row(s). Lets a caller solve many targets'
        problems in one batched device dispatch (km_tpu_torch.ops.nnls) instead
        of looping quantify_paths/quantify_clusters."""
        assert self.alt_paths is not None, "call find_alt_paths() first"
        ref_ix = self.target.seq_index
        jobs = []

        def warm(ref, paths, offset):
            # classification + sequence materialization need no
            # coefficients: running them while the batched solve is in
            # flight hides this host work under the device round trip
            # (results land in the path_seq/variant_name caches)
            self.path_seq(ref, skip_prefix=False)
            for p in paths:
                self.variant_name(ref, p, offset)
                self.path_seq(p, skip_prefix=False)

        for alt_ix in self.alt_paths:
            jobs.append((
                [alt_ix, ref_ix],
                lambda coef, rvaf, a=alt_ix: self._emit_vs_ref(a, coef,
                                                               rvaf),
                lambda a=alt_ix: warm(ref_ix, [a], 0),
            ))
        for i, (ref_path, clipped, start_off) in enumerate(
                self._find_clusters(self.alt_paths)):
            jobs.append((
                [ref_path] + list(clipped),
                lambda coef, rvaf, n=i + 1, r=ref_path, c=clipped, \
                    s=start_off: self._emit_cluster(n, r, c, s, coef, rvaf),
                lambda r=ref_path, c=clipped, s=start_off: warm(r, c, s),
            ))
        return jobs

    # -- output ------------------------------------------------------------

    def sorted_rows(self) -> list[PathRow]:
        """Rows ordered by (Info descending, Query, Variant_name, Type,
        Min_coverage) under natural sort — 'vs_ref' rows come before
        'cluster' rows (reference: km/utils/MutationFinder.py:813-833)."""
        return sorted(
            self.rows,
            key=lambda x: natsortkey(*x[11].split(" "), x[1], x[3], x[2],
                                     x[6], rev_ix=(0,)),
        )

    # -- optional plots ----------------------------------------------------

    def _plot_paths(self):
        import matplotlib.pyplot as plt

        ref_ix = self.target.seq_index
        plt.figure(figsize=(10, 6))
        for alt_ix in self.alt_paths:
            plt.plot(self.path_counts(alt_ix),
                     label=self.variant_name(ref_ix, alt_ix)
                     .replace("\t", " ") + " (%s)" % self.target.name)
        plt.legend()
        plt.show()

    def _plot_cluster(self, ref_path, clipped, start_off):
        import matplotlib.pyplot as plt

        plt.figure(figsize=(10, 6))
        plt.plot(self.path_counts(ref_path), label="Reference")
        for path in clipped:
            plt.plot(self.path_counts(path),
                     label=self.variant_name(ref_path, path, start_off)
                     .split("\t")[0])
        plt.legend()
        plt.show()
