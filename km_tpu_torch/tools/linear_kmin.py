"""linear_kmin: smallest k whose de Bruijn decomposition of a target is
unique and linear. Output-compatible with km
(reference: km/tools/linear_kmin.py:7-61), but the linearity test is
vectorized over packed keys instead of O(n^2) string comparisons.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..io.fasta import expand_target_files, read_target
from ..ops import encode


def _kmers_unique(seq: str, k: int) -> np.ndarray | None:
    mers = encode.pack_kmers(seq, k)
    if len(np.unique(mers)) != len(mers):
        return None
    return mers


def _is_linear(mers: np.ndarray, k: int) -> bool:
    """Every k-mer has at most one forward and one backward (k-1)-overlap
    neighbor within the target."""
    prefix = np.sort(mers >> np.uint64(2))
    suffix = mers & np.uint64((1 << (2 * (k - 1))) - 1)
    # forward fan-out of i = number of j != i with prefix_j == suffix_i
    lo = np.searchsorted(prefix, suffix, side="left")
    hi = np.searchsorted(prefix, suffix, side="right")
    fwd = hi - lo
    # exclude self-overlap (k-mer whose own prefix equals its suffix)
    self_olap = (mers >> np.uint64(2)) == suffix
    fwd = fwd - self_olap
    if (fwd > 1).any():
        return False
    # backward fan-in: count suffix_j == prefix_i
    ssuffix = np.sort(suffix)
    pref = mers >> np.uint64(2)
    lo = np.searchsorted(ssuffix, pref, side="left")
    hi = np.searchsorted(ssuffix, pref, side="right")
    bwd = (hi - lo) - self_olap
    return not (bwd > 1).any()


def find_kmin(ref_name: str, ref_seq: str, start: int) -> int:
    k = start - 1
    while k < len(ref_seq):
        k += 1
        mers = _kmers_unique(ref_seq, k)
        if mers is None:
            continue
        if _is_linear(mers, k):
            break
    return k


def main_linear_kmin(args, argparser):
    sys.stdout.write("target_name\tlinear_kmin\n")
    for seq_f in expand_target_files(args.target_fn):
        (ref_name, _ext) = os.path.splitext(os.path.basename(seq_f))
        seqs, _ = read_target(seq_f)
        kmin = find_kmin(ref_name, "".join(seqs), args.start)
        sys.stdout.write(ref_name + "\t" + str(kmin) + "\n")
