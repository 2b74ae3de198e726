"""Subcommand argument definitions (the port's copy of
km_tpu/argparsing/schemas.py, with ``--device``).

The port's own choice is ``--device``: 'cuda' (the default) runs on the
card, 'cpu' runs the port's plain torch versions on CPU tensors, 'host'
runs the numpy spec. ``--mode`` of ``count`` (and of ``cohort``, for the
samples it counts) has km_tpu's choices and default; ``count -s/--size``
(jellyfish's hash size, the chunked mode's ceiling) is the port's too.

Defaults are the de-facto algorithm spec shared with km: count 5,
ratio 0.05, steps 500, branchs 10, nodes 10000
(reference: km/argparser/find_mutation.py:6-39), info filter 'vs_ref',
min coverage 1 (km/argparser/find_report.py:23-35), start k 10
(km/argparser/linear_kmin.py:7-13).
"""

from __future__ import annotations

import argparse
import os
import sys


DEVICES = ("cuda", "cpu", "host")


def valid_file(parser, path):
    if not os.path.isfile(path):
        parser.error("The file %s does not exist!" % path)
    return path


def add_find_mutation_args(parser):
    parser.add_argument(
        "-c", "--count", nargs="?", default=5, type=int,
        help="Minimum occurence needed for exploration of alternative "
             "(default: -c 5)")
    parser.add_argument(
        "-p", "--ratio", nargs="?", default=0.05, type=float,
        help="Minimum occurence ratio needed for exploration of "
             "alternative (default: -p 0.05)")
    parser.add_argument(
        "-s", "--steps", nargs="?", default=500, type=int,
        help="Maximum steps to discover a new branch on a target sequence "
             "(default: -s 500)")
    parser.add_argument(
        "-b", "--branchs", nargs="?", default=10, type=int,
        help="Maximum branchs until getback to target sequence "
             "(default: -b 10)")
    parser.add_argument(
        "-n", "--nodes", nargs="?", default=10000, type=int,
        help="Maximum nodes queried from the count table "
             "(default: -n 10000)")
    parser.add_argument(
        "-g", "--graphical", action="store_true",
        help="Display coverage graph.")
    parser.add_argument(
        "-v", "--verbose", action="store_true",
        help="Get more information.")
    parser.add_argument(
        "-vv", "--debug", action="store_true",
        help="Get much more information.")
    parser.add_argument(
        "--profile", nargs="?", const="/tmp/km_tpu_trace", default=None,
        metavar="DIR",
        help="Write a torch.profiler device trace to DIR (and log "
             "per-phase timings; combine with -v).")
    parser.add_argument(
        "--batch", action="store_true",
        help="Walk all targets together through one batched frontier "
             "expansion (km_tpu extension; rows are identical to the "
             "sequential mode's).")
    parser.add_argument(
        "target_fn", nargs="*",
        help="Filename of the target sequence file or directory.")
    parser.add_argument(
        "jellyfish_fn",
        help="Filename of the count table (.jf or .npz).")


def add_find_report_args(parser):
    parser._action_groups.pop()
    required = parser.add_argument_group("required arguments")
    optional = parser.add_argument_group("optional arguments")
    optional.add_argument(
        "-t", dest="target",
        type=lambda x: valid_file(parser, x),
        help="Filename of the target sequence file")
    required.add_argument(
        "infile", nargs="?", type=argparse.FileType("r"), default=sys.stdin)
    optional.add_argument(
        "-i", dest="info", default="vs_ref", type=str,
        help="Filter on info column (Default: vs_ref)")
    optional.add_argument(
        "-m", dest="min_cov", default=1, type=int,
        help="Min coverage allowed (Default: 1)")
    optional.add_argument(
        "-e", "--exclu", dest="exclu", default="", type=str,
        help="Filename of a count table containing k-mers which can "
             "create false positive variants")
    optional.add_argument(
        "-f", "--format", dest="format", choices=["vcf", "table"],
        help="Option 'vcf': Output variants in VCF-like file format -- "
             "Option 'table': Group variants by position and return "
             "per-sample ratio")


def add_linear_kmin_args(parser):
    parser.add_argument(
        "-s", "--start", nargs="?", default=10, type=int,
        help="starting length (default: -s 10)")
    parser.add_argument(
        "target_fn", nargs="*",
        help="Filename of the reference sequence file or directory.")


def add_min_cov_args(parser):
    parser.add_argument(
        "target_fn",
        help="Filename of the target sequence file or directory.")
    parser.add_argument(
        "jellyfish_fn", nargs="*",
        help="Filename of the count table.")


def add_device_arg(parser, what: str):
    parser.add_argument(
        "--device", choices=DEVICES, default="cuda",
        help="Where %s runs: cuda (default; fails without a card), cpu "
             "(plain torch on CPU tensors) or host (numpy)" % what)


def add_mode_arg(parser):
    parser.add_argument(
        "--mode", choices=["auto", "stream", "chunked"], default="auto",
        help="Device counting strategy: 'stream' keeps one accumulator "
             "on-device, grown as the keys need (single readback); "
             "'chunked' is jellyfish's --disk count: the accumulator "
             "grows no further than --size slots, a full one is dumped "
             "to the host as a sorted piece and the pieces are merged "
             "and cut there at the end; 'auto' is 'stream'")


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
    add_mode_arg(parser)
    parser.add_argument(
        "-s", "--size", type=int, default=None,
        help="--mode chunked: the accumulator's ceiling in slots, like "
             "jellyfish count -s (rounded up to a power of two, at least "
             "the chunk: 2^24 bases on cuda, 2^20 on cpu); default: what "
             "the device's free memory holds. The stream ignores it")
    parser.add_argument(
        "reads_fn", nargs="+",
        help="FASTQ/FASTA read files (optionally .gz)")


def add_cohort_args(parser):
    parser.add_argument(
        "-t", "--targets", required=True,
        help="Target FASTA file or catalog directory (every target runs "
             "against every sample).")
    parser.add_argument(
        "-o", "--outdir", required=True,
        help="Output directory; one <outdir>/<sample>/<target>.tsv per "
             "pair (the reference recipe's per-target .xls files).")
    # find_mutation tuning (km defaults)
    parser.add_argument("-c", "--count", default=5, type=int,
                        help="Minimum occurence needed for exploration "
                             "of alternative (default: 5)")
    parser.add_argument("-p", "--ratio", default=0.05, type=float,
                        help="Minimum occurence ratio (default: 0.05)")
    parser.add_argument("-s", "--steps", default=500, type=int,
                        help="Maximum walk steps (default: 500)")
    parser.add_argument("-b", "--branchs", default=10, type=int,
                        help="Maximum branches (default: 10)")
    parser.add_argument("-n", "--nodes", default=10000, type=int,
                        help="Maximum graph nodes (default: 10000)")
    # find_report options (km defaults)
    parser.add_argument("-i", dest="info", default="vs_ref", type=str,
                        help="Filter on info column (default: vs_ref)")
    parser.add_argument("-m", dest="min_cov", default=1, type=int,
                        help="Min coverage allowed (default: 1)")
    parser.add_argument("-e", "--exclu", dest="exclu", default="",
                        type=str,
                        help="Count table of k-mers that create false "
                             "positives")
    parser.add_argument("-f", "--format", dest="format",
                        choices=["vcf", "table"],
                        help="Report format (default: 16-column TSV)")
    # counting options for samples given as raw reads
    parser.add_argument("-k", "--kmer-size", dest="k", default=31,
                        type=int, help="k-mer length for raw-read "
                                       "samples (default: 31)")
    parser.add_argument("-L", "--lower-count", dest="lower_count",
                        default=2, type=int,
                        help="Drop k-mers below this count when counting "
                             "raw reads (default: 2)")
    parser.add_argument("-Q", "--min-quality", dest="min_quality",
                        default=None,
                        help="Minimum base quality for raw-read samples")
    parser.add_argument(
        "samples", nargs="+",
        help="Sample count tables (.jf/.npz) or raw read files "
             "(FASTQ/FASTA, optionally .gz); hosts of a multi-host "
             "slice split this list.")
    add_device_arg(parser, "counting raw-read samples and the catalog")
    add_mode_arg(parser)
