"""Subcommand argument definitions.

find_mutation, find_report, linear_kmin and min_cov take km_tpu's
arguments (which mirror km's), and cohort takes km_tpu's plus
``--device``. The port's own choice is ``--device``:
'cuda' (the default) runs on the card, 'cpu' runs the port's plain
torch versions on CPU tensors, 'host' runs km_tpu's numpy spec.
"""

from __future__ import annotations

from km_tpu.argparsing import schemas as km_tpu_schemas
from km_tpu.argparsing.schemas import (add_find_mutation_args,
                                       add_find_report_args,
                                       add_linear_kmin_args,
                                       add_min_cov_args)

__all__ = ["add_cohort_args", "add_count_args", "add_device_arg",
           "add_find_mutation_args", "add_find_report_args",
           "add_linear_kmin_args", "add_min_cov_args"]

DEVICES = ("cuda", "cpu", "host")


def add_device_arg(parser, what: str):
    parser.add_argument(
        "--device", choices=DEVICES, default="cuda",
        help="Where %s runs: cuda (default; fails without a card), cpu "
             "(plain torch on CPU tensors) or host (numpy)" % what)


def add_count_args(parser):
    parser.add_argument(
        "-k", "--kmer-size", dest="k", default=31, type=int,
        help="k-mer length (default: 31, at most 31)")
    parser.add_argument(
        "-L", "--lower-count", dest="min_count", default=2, type=int,
        help="Drop k-mers with count below this (default: 2, matching "
             "the jellyfish count -L 2 recipe)")
    parser.add_argument(
        "--no-canonical", dest="canonical", action="store_false",
        help="Count k-mers as seen instead of canonical form")
    parser.add_argument(
        "-Q", "--min-quality", dest="min_quality", default=None,
        help="Minimum base quality character; lower-quality bases break "
             "k-mers (like jellyfish count -Q)")
    parser.add_argument(
        "-o", "--output", required=True,
        help="Output count table (.npz, or .jf for Jellyfish's own "
             "binary/sorted layout)")
    add_device_arg(parser, "counting")
    parser.add_argument(
        "reads_fn", nargs="+",
        help="FASTQ/FASTA read files (optionally .gz)")


def add_cohort_args(parser):
    km_tpu_schemas.add_cohort_args(parser)
    add_device_arg(parser, "counting raw-read samples and the catalog")
