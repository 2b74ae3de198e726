"""Path expression quantification and the 12-column output row.

The quantification model: each candidate path contributes its k-mer
occupancy as one column of an occurrence matrix ``contrib`` (a k-mer
traversed twice — an ITD — contributes 2); observed k-mer counts are
explained as a non-negative combination of path columns. The fit is an
unconstrained least squares followed by projected gradient descent.

PROVENANCE NOTE — spec-exact numeric kernel. The three small functions
``lstsq_fit`` / ``refine_fit`` / ``ratio_of`` reproduce the reference's
float operation order *exactly* (reference: km/utils/PathQuant.py:111-149)
because the report fields are %.3f/%.1f roundings of their results and
the golden suite requires byte equality: int32 contributions, float32
counts, float64 lstsq, the 0.1 x mean-gradient step with post-update
clamping, and the 0.01 max-gradient stopping rule. Everything around
that kernel (problem assembly, batching, row output) is this repo's own
design; the batched device variant lives in km_tpu_torch.ops.nnls and is
validated field-for-field against these functions (the port's copy of
km_tpu/models/quant.py).
"""

from __future__ import annotations

import logging as log

import numpy as np


def build_contrib(paths, n_kmers: int) -> np.ndarray:
    """Occurrence matrix [n_kmers, n_paths]: entry (i, j) counts how many
    times node i appears on path j (so ITD-duplicated k-mers count 2)."""
    contrib = np.empty((n_kmers, len(paths)), dtype=np.int32)
    for j, path in enumerate(paths):
        idx = np.fromiter(path, dtype=np.intp, count=len(path))
        if idx.size and idx.max() >= n_kmers:
            # fail loud on a malformed path instead of silently dropping
            # its out-of-range nodes from the occurrence matrix
            raise IndexError(
                "path %d references node %d >= n_kmers %d"
                % (j, int(idx.max()), n_kmers))
        contrib[:, j] = np.bincount(idx, minlength=n_kmers)[:n_kmers]
    return contrib


def lstsq_fit(contrib: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Unconstrained least-squares coefficients (minimum-norm on rank
    deficiency, e.g. when the alt path IS the reference path)."""
    coef = np.linalg.lstsq(contrib, counts, rcond=None)[0]
    log.debug("Linear fitting = %s", coef)
    return coef


def refine_fit(contrib: np.ndarray, counts: np.ndarray,
               coef: np.ndarray) -> np.ndarray:
    """Projected gradient refinement (spec-exact; see module note)."""
    n_kmers = contrib.shape[0]
    coef[coef < 0] = 0
    last_max_grad = np.inf
    num_iter = 0
    while last_max_grad > 0.01:
        counts_hat = np.dot(contrib, coef)
        grad = 2 * (counts - counts_hat) * contrib.T
        grad = grad.sum(axis=1) / n_kmers
        coef += 0.1 * grad
        grad[coef < 0] = 0
        coef[coef < 0] = 0
        last_max_grad = np.max(np.abs(grad))
        num_iter += 1
        log.debug("Iteration = %d, max_gradient = %f", num_iter,
                  last_max_grad)
    log.info("Refined fitting = %s", coef)
    return coef


def ratio_of(coef: np.ndarray) -> np.ndarray:
    """rVAF vector: coef / sum(coef), guarded when the fit is all-zero."""
    if max(coef) == 0:
        return coef
    return coef / np.sum(coef)


def quantify(paths, counts) -> tuple[np.ndarray, np.ndarray]:
    """Fit all ``paths`` (lists of node indices) jointly against the
    node count vector; returns (coef, rVAF), one entry per path."""
    counts = np.array(counts, dtype=np.float32)
    contrib = build_contrib(paths, len(counts))
    log.info("%d sequence(s) are observed.", len(paths))
    coef = refine_fit(contrib, counts, lstsq_fit(contrib, counts))
    return coef, ratio_of(coef)


def reference_adjust(coef, rvaf, counts) -> tuple[np.ndarray, np.ndarray]:
    """Pure-reference rows report no variant fraction and the floor
    coverage instead of a fitted split (the fit is degenerate: the alt
    column equals the ref column)."""
    rvaf = rvaf.copy()
    coef = coef.copy()
    rvaf[0] = np.nan
    rvaf[1] = np.nan
    coef[coef >= 0] = min(np.array(counts, dtype=np.float32))
    return coef, rvaf


class PathRow:
    """One output row of find_mutation (12 TSV columns; the variant_name
    slot carries an embedded tab splitting it into Type + Variant_name,
    matching km/utils/PathQuant.py:37-49)."""

    HEADER = "\t".join([
        "Database", "Query", "Type", "Variant_name", "rVAF", "Expression",
        "Min_coverage", "Start_offset", "Sequence", "Reference_expression",
        "Reference_sequence", "Info",
    ])

    def __init__(self, db_name, ref_name, variant_name, ratio, expression,
                 min_coverage, start_off, sequence, ref_ratio,
                 ref_expression, ref_sequence, note):
        self.db_name = db_name
        self.ref_name = ref_name
        self.variant_name = variant_name
        self.rVAF = ratio
        self.expression = expression
        self.min_coverage = min_coverage
        self.start_off = start_off
        self.sequence = sequence
        self.ref_ratio = ref_ratio
        self.ref_expression = ref_expression
        self.ref_sequence = ref_sequence
        self.note = note

    def __str__(self):
        return "%s\t%s\t%s\t%.3f\t%.1f\t%d\t%d\t%s\t%.1f\t%s\t%s" % (
            self.db_name, self.ref_name, self.variant_name, self.rVAF,
            self.expression, self.min_coverage, self.start_off,
            self.sequence, self.ref_expression, self.ref_sequence, self.note)

    @property
    def type(self) -> str:
        """Variant type (the Type column — first half of the embedded
        Type\\tVariant_name pair)."""
        return self.variant_name.split("\t")[0]

    def fields(self):
        return str(self).split("\t")

    def __getitem__(self, i):
        return self.fields()[i]
