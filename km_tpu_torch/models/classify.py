"""Variant classification: path diffing and naming.

Implements the three-scan comparison between a reference node path and an
alternative node path, and the variant-type decision rules, with the same
outcomes as km (reference: km/utils/MutationFinder.py:190-373 diff,
405-488 naming):

scan 1  longest common prefix of the two index paths;
scan 2  longest common suffix, stopped k short of the prefix so the
        mutated region's k-mers never overlap the prefix's;
scan 3  overlap-allowed suffix scan (end_ref_overlap) whose collapse onto
        the prefix boundary is the ITD signature.

Types: Reference, Substitution, ITD, Insertion, Deletion, Indel — named
``Type\\tstart+k:removed_lower/ADDED_UPPER:end_ref+1`` in 1-based target
coordinates.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..ops import encode

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


class PathDiff(NamedTuple):
    start: int
    end_ref: int
    end_var: int
    kmers_ref: tuple  # node ids specific to the reference (deleted)
    kmers_var: tuple  # node ids specific to the variant (inserted)
    end_ref_overlap: int


def diff_paths(ref, seq, k: int) -> PathDiff:
    """Three-scan diff of two node-id paths (see module docstring)."""
    n_ref, n_seq = len(ref), len(seq)

    i = 0
    while i < n_ref and i < n_seq and ref[i] == seq[i]:
        i += 1

    j_ref, j_seq = n_ref, n_seq
    while j_ref >= i + k and j_seq >= i + k and ref[j_ref - 1] == seq[j_seq - 1]:
        j_ref -= 1
        j_seq -= 1

    k_ref, k_seq = j_ref, j_seq
    while k_ref > i and ref[k_ref - 1] == seq[k_seq - 1]:
        k_ref -= 1
        k_seq -= 1

    return PathDiff(i, j_ref, j_seq, tuple(ref[i:j_ref]), tuple(seq[i:j_seq]),
                    k_ref)


def merge_kmers(keys: list[int], path, k: int, skip_prefix: bool = True) -> str:
    """Merge a node-id path into its base sequence.

    keys[i] is the packed k-mer of node i. With skip_prefix, only the last
    base of the first k-mer is kept (used for the inserted/deleted
    subsequences, whose leading k-1 bases belong to context).
    """
    if not len(path):
        return ""
    first = encode.unpack_kmer(int(keys[path[0]]), k)
    head = first[-1] if skip_prefix else first
    if len(path) == 1:
        return head
    if isinstance(keys, np.ndarray):
        # cached packed-key array (VariantFinder._keys_arr): one fancy
        # gather instead of a python generator over list entries
        idx = np.fromiter(path, dtype=np.intp, count=len(path))
        tail_keys = keys[idx[1:]]
    else:
        tail_keys = np.fromiter((int(keys[i]) for i in path[1:]),
                                dtype=np.uint64, count=len(path) - 1)
    return head + _BASES[(tail_keys & np.uint64(3)).astype(np.intp)] \
        .tobytes().decode("ascii")


class MutationNameError(Exception):
    """Path/diff length bookkeeping mismatch — two copies of the same
    sequence (matches the guard at km/utils/MutationFinder.py:431-440)."""


def name_variant(keys: list[int], ref_ix, path_ix, k: int,
                 offset: int = 0) -> str:
    """Type + position string for an alternative path vs the reference.

    Returns e.g. ``Insertion\\t45:/TCTG:45`` or ``Reference\\t``.
    """
    import sys

    diff = diff_paths(ref_ix, path_ix, k)

    if len(ref_ix) - len(diff.kmers_ref) + len(diff.kmers_var) != len(path_ix):
        sys.stderr.write(
            "ERROR: %s %d != %d" % (
                "mutation identification could be incorrect",
                len(ref_ix) - len(diff.kmers_ref) + len(diff.kmers_var),
                len(path_ix),
            )
        )
        raise MutationNameError()

    del_seq = merge_kmers(keys, diff.kmers_ref, k, skip_prefix=True)
    ins_seq = merge_kmers(keys, diff.kmers_var, k, skip_prefix=True)

    # trim the common right-context shared by the removed/added sequences
    trim = 1  # inverse indexing, so start at 1 and offset back at the end
    if len(del_seq) > 0:
        assert del_seq != ins_seq
        while del_seq[-trim:] == ins_seq[-trim:]:
            trim += 1
    trim -= 1
    if trim != 0:
        del_seq = del_seq[:-trim]
        ins_seq = ins_seq[:-trim]

    if diff.end_ref == diff.end_var:
        if diff.start == diff.end_ref:
            variant = "Reference"
        else:
            variant = "Substitution"
    elif diff.start == diff.end_ref_overlap:
        # the suffix scan retraced the whole reference: duplication
        variant = "ITD"
    else:
        variant = "Indel"
        if diff.end_ref < diff.end_var:
            if len(del_seq) == 0:
                variant = "Insertion"
        elif len(ins_seq) == 0:
            variant = "Deletion"

    if variant == "Reference":
        return variant + "\t"
    return "{}\t{}:{}:{}".format(
        variant,
        diff.start + k + offset,
        del_seq.lower() + "/" + ins_seq,
        diff.end_ref + 1 + offset,
    )
