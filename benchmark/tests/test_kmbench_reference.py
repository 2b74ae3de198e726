"""The plain references: the count against brute force, the catalog
against km's golden rows, and the controls' breaks."""

import os

import numpy as np
import pytest
import torch

import small
from kmbench.drivers import catalog
from reference import catalog_ref, count_ref

GOLDEN = {
    "NPM1": ("NPM1_4ins_exons_10-11utr", "02H025_NPM1"),
    "FLT3_ITD": ("FLT3-ITD_exons_13-15", "03H116_ITD"),
    "FLT3_IandI": ("FLT3-ITD_exons_13-15", "03H112_IandI"),
    "FLT3_TKD": ("FLT3-TKD_exon_20", "05H094_FLT3-TKD_del"),
    "DNMT3A": ("DNMT3A_R882_exon_23", "02H033_DNMT3A_sub"),
}
PARAMS = {"ratio": 0.05, "count": 5, "steps": 500, "branchs": 10,
          "nodes": 10000}


def brute_count(reads: np.ndarray, k: int):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    counts: dict[str, int] = {}
    for r in reads:
        s = "".join("ACGT"[c] for c in r)
        for i in range(len(s) - k + 1):
            w = s[i:i + k]
            rc = "".join(comp[b] for b in reversed(w))
            key = min(w, rc)
            counts[key] = counts.get(key, 0) + 1
    return counts


def key_of(s: str) -> int:
    v = 0
    for b in s:
        v = v * 4 + "ACGT".index(b)
    return v


@pytest.mark.parametrize("k", [5, 31])
def test_count_reference_against_brute_force(k):
    g = torch.Generator().manual_seed(small.SEED)
    reads = torch.randint(0, 4, (40, 37), generator=g, dtype=torch.uint8)
    reads[5] = reads[3]  # repeated k-mers
    keys, counts, total, distinct = count_ref.count_reads(reads, k, True, 2)
    brute = brute_count(reads.numpy(), k)
    assert total == 40 * (37 - k + 1) and distinct == len(brute)
    want = sorted((key_of(s), n) for s, n in brute.items() if n >= 2)
    assert [int(x) for x in keys] == [w for w, _ in want]
    assert counts.tolist() == [n for _, n in want]


def test_control_loses_exactly_the_windows_across_a_cut():
    keep = count_ref.control_keep(3, 10, 4, 16)
    # read r starts at 11 r; windows [s, s+3] cross a cut at 16 or 32
    starts = [11 * r + j for r in range(3) for j in range(7)]
    assert keep.tolist() == [s // 16 == (s + 3) // 16 for s in starts]
    g = torch.Generator().manual_seed(1)
    reads = torch.randint(0, 4, (200, 100), generator=g, dtype=torch.uint8)
    rk, rc, total, _ = count_ref.count_reads(reads, 31, True, 1)
    ck, cc, ctotal = count_ref.count_reads_control(reads, 31, True, 1,
                                                   1 << 10)
    assert 0 < total - ctotal and count_ref.table_mismatches(
        ck, cc, rk, rc) > 0


def test_table_mismatches():
    k = np.array([1, 2, 3], np.uint64)
    c = np.array([2, 2, 5], np.int64)
    assert count_ref.table_mismatches(k, c.astype(np.uint32), k, c) == 0
    assert count_ref.table_mismatches(k, c + [0, 1, 0], k, c) == 1
    assert count_ref.table_mismatches(k[:2], c[:2], k, c) == 1
    assert count_ref.table_mismatches(
        np.array([1, 2, 4], np.uint64), c, k, c) == 2


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_catalog_reference_gives_the_golden_rows(case):
    target, sample = GOLDEN[case]
    path = os.path.join(small.ROOT, "tests", "golden",
                        case + ".find_mutation.tsv")
    with open(path) as f:
        want = [line.rstrip("\n").split("\t")[1:] for line in f
                if not line.startswith(("#", "Database"))]
    keys, counts, k, canonical = catalog.fixture_union([sample])
    table = catalog_ref.HostTable(keys, counts, k, canonical, "db")
    seqs = {n.rsplit("_", 1)[0]: s for s, n in catalog.catalog_sequences(9)}
    rows = catalog_ref.catalog_rows([(seqs[target], target)], table,
                                    PARAMS)[0]
    got = [str(r).split("\t")[1:] for r in rows]
    assert got == want


def test_fit_precision_changes_values():
    paths = [[0, 1, 3, 3], [1, 2, 3]]
    counts = np.array([10.1, 17.3, 7.7, 27.9, -1, -1], np.float32)
    hi, hr = catalog_ref.fit(paths, counts, np.float64)
    lo, lr = catalog_ref.fit(paths, counts, np.float32)
    assert lo.dtype == np.float32 and hi.dtype == np.float64
    assert 0 < np.abs(lo - hi).max() < 1e-3
    assert abs(hr.sum() - 1) < 1e-12 and (hi >= 0).all()


def test_canonical_haystack_keys():
    g = torch.Generator().manual_seed(small.SEED)
    keys = torch.randint(0, 1 << 62, (1000,), generator=g)
    canon = catalog.canonical_keys(keys, 31)
    for x, c in zip(keys[:50].tolist(), canon[:50].tolist()):
        s = "".join("ACGT"[(x >> (2 * (30 - i))) & 3] for i in range(31))
        rc = s.translate(str.maketrans("ACGT", "TGCA"))[::-1]
        assert c == key_of(min(s, rc))
    assert (canon <= keys).all() and (canon < keys).any()
    assert (catalog.canonical_keys(canon, 31) == canon).all()
