"""min_cov: per-table coverage statistics of a target sequence.
Output-compatible with km (reference: km/tools/min_cov.py:10-25,
km/utils/common.py:73-92), with the per-k-mer query loop replaced by one
batched table lookup.
"""

from __future__ import annotations

import os
import sys

from ..io.fasta import expand_target_files, read_target
from .find_mutation import load_table


def coverage_stats(table, ref_seq: str):
    cov = table.cover(ref_seq)
    mean = float(cov.sum()) / len(cov) if len(cov) else 0
    return (int(cov.sum()), len(ref_seq), int(cov.min()), int(cov.max()),
            mean, len(cov), int((cov == 0).sum()))


def main_min_cov(args, argparser):
    lst_files = expand_target_files(args.jellyfish_fn)

    ref_seq = args.target_fn
    if os.path.isfile(args.target_fn):
        seqs, _ = read_target(args.target_fn)
        ref_seq = "".join(seqs)

    sys.stdout.write("DB\tcount\tlength\tmin\tmax\tmean\tkmer_nb\tkmer_nb_0\n")
    for jf_file in lst_files:
        res = coverage_stats(load_table(jf_file), ref_seq)
        sys.stdout.write("%s\t%d\t%d\t%d\t%d\t%.2f\t%d\t%d\n" % (
            (jf_file,) + res))
