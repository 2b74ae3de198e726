"""km_tpu_torch command-line interface.

Subcommands: ``count`` (reads -> count table on the card, sharded over
the processes under torchrun), ``find_mutation`` (``--batch`` walks
every target against the torch table), ``cohort`` (every target against
every sample, one report file per pair; processes under torchrun split
the samples), and ``find_report``, ``linear_kmin`` and ``min_cov``.
Nothing here imports km_tpu.
"""

from __future__ import annotations

import argparse
import sys

from .argparsing import schemas


def main(argv=None):
    """Parse ``argv`` and run the subcommand; returns what it returns
    (count returns a dict of its numbers)."""
    parser = argparse.ArgumentParser(prog="km-tpu-torch")
    subparsers = parser.add_subparsers(help="sub-command help")

    sub = subparsers.add_parser(
        "find_mutation",
        help="Identify and quantify mutations from a target sequence and "
             "a k-mer count table.")
    from .tools.find_mutation import main_find_mut
    sub.set_defaults(func=main_find_mut)
    schemas.add_find_mutation_args(sub)
    schemas.add_device_arg(sub, "the --batch table")

    sub = subparsers.add_parser(
        "find_report",
        help="Parse find_mutation output and reformat it in a more "
             "user-friendly tabulated file.")
    from .tools.find_report import main_find_report
    sub.set_defaults(func=main_find_report)
    schemas.add_find_report_args(sub)

    sub = subparsers.add_parser(
        "linear_kmin",
        help="Find min k-length to decompose a target sequence in a "
             "linear graph.")
    from .tools.linear_kmin import main_linear_kmin
    sub.set_defaults(func=main_linear_kmin)
    schemas.add_linear_kmin_args(sub)

    sub = subparsers.add_parser(
        "min_cov", help="Compute coverage of target sequences.")
    from .tools.min_cov import main_min_cov
    sub.set_defaults(func=main_min_cov)
    schemas.add_min_cov_args(sub)

    sub = subparsers.add_parser(
        "count",
        help="Count k-mers of FASTQ/FASTA reads into a native table "
             "(replaces jellyfish count).")
    from .tools.count import main_count
    sub.set_defaults(func=main_count)
    schemas.add_count_args(sub)

    sub = subparsers.add_parser(
        "cohort",
        help="Run every target of a catalog against every sample (count "
             "tables or raw reads): one find_report file per pair.")
    from .tools.cohort import main_cohort
    sub.set_defaults(func=main_cohort)
    schemas.add_cohort_args(sub)

    if argv is None:
        argv = sys.argv[1:]
    if not argv:
        parser.print_help(sys.stderr)
        sys.exit(1)

    args = parser.parse_args(argv)
    return args.func(args, parser)


if __name__ == "__main__":
    main()
