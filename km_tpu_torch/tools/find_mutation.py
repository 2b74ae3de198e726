"""find_mutation: identify and quantify variants for targets vs a count
table. Output (arg echo, 12-column TSV, elapsed-time footer) is the
same as km_tpu's and km's (reference: km/tools/find_mutation.py:17-60);
``--batch`` runs through the torch table (tools/batchmode.py).
"""

from __future__ import annotations

import logging as log
import os
import sys
import time

from ..io.fasta import expand_target_files, read_target
from ..models.finder import VariantFinder
from ..models.quant import PathRow
from ..models.sequence import TargetSeq
from ..models.table import CountTable
from ..utils import profiling

# km's provenance block: exactly its argument set, in its order
# (reference: km/km.py:31-32 + km/tools/find_mutation.py:26-27); the
# port's extras (--batch, --device, --profile) echo behind -vv only
KM_KEYS = ("func", "count", "ratio", "steps", "branchs", "nodes",
           "graphical", "verbose", "debug", "target_fn", "jellyfish_fn")


def load_table(path: str) -> CountTable:
    """Open a count table: .jf (Jellyfish) or .npz (km_tpu's and the
    port's own format)."""
    if path.endswith(".npz"):
        t = CountTable.load(path)
        t.name = path
        return t
    return CountTable.from_jf(path)


def main_find_mut(args, argparser):
    time_start = time.time()

    if args.verbose:
        log.basicConfig(level=log.INFO, format="VERBOSE: %(message)s")
    if args.debug:
        log.basicConfig(level=log.DEBUG, format="VERBOSE: %(message)s")

    present = vars(args)
    for key in KM_KEYS:
        if key in present:
            sys.stdout.write("#" + key + ":" + str(present[key]) + "\n")
    if args.debug:
        for key in sorted(set(present) - set(KM_KEYS)):
            sys.stdout.write("#" + key + ":" + str(present[key]) + "\n")

    profiling.reset()
    with profiling.phase("load_table"):
        table = load_table(args.jellyfish_fn)
        table.name = args.jellyfish_fn

    sys.stdout.write(PathRow.HEADER + "\n")

    targets = []
    for seq_f in expand_target_files(args.target_fn):
        (ref_name, _ext) = os.path.splitext(os.path.basename(seq_f))
        seqs, _attrs = read_target(seq_f)
        # multi-entry targets (exons) concatenate into one sequence
        targets.append(TargetSeq("".join(seqs), ref_name, table.k))

    with profiling.device_trace(getattr(args, "profile", None)):
        if getattr(args, "batch", False):
            from .batchmode import emit_batched

            emit_batched(targets, table, args)
        else:
            for target in targets:
                with profiling.phase("walk"):
                    finder = VariantFinder(
                        target, table, ratio=args.ratio, count=args.count,
                        max_stack=args.steps, max_break=args.branchs,
                        max_node=args.nodes,
                    )
                    finder.find_alt_paths()
                with profiling.phase("quantify"):
                    finder.quantify_paths(args.graphical)
                    finder.quantify_clusters(args.graphical)
                for row in finder.sorted_rows():
                    sys.stdout.write(str(row) + "\n")
    profiling.report()

    sys.stdout.write("#Elapsed time:" + str(time.time() - time_start) + "\n")
