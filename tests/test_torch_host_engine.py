"""The port's host engine against km_tpu's on the same inputs: the host
half of ops.count (window_valid, count_batches_host, merge_runs,
chunk_stream, _coalesce_batches), and models.{sequence, walk,
pathfinder, quant, classify, finder}. Keys, counts, node sets, paths and
names are compared exactly; the quantified rows as their report text
(%.3f and %.1f fields), as tests/test_nnls.py does."""

import os

import numpy as np
import pytest

import km_tpu.models.classify as km_classify
import km_tpu.models.quant as km_quant
import km_tpu.ops.count as km_count
from km_tpu.io.fasta import read_target
from km_tpu.models.finder import VariantFinder as KmFinder
from km_tpu.models.pathfinder import OverlapGraph as KmGraph
from km_tpu.models.sequence import TargetSeq as KmTarget
from km_tpu.models.sequence import target_kmers as km_target_kmers
from km_tpu.models.table import CountTable as KmTable
from km_tpu.models.walk import NodeBudgetExceeded as KmBudget
from km_tpu.models.walk import Walker as KmWalker
from km_tpu.refdata import DATA_DIR as REFDATA

import km_tpu_torch.models.classify as classify
import km_tpu_torch.models.quant as quant
import km_tpu_torch.ops.count as count
from km_tpu_torch import convert
from km_tpu_torch.models import batch as port_batch
from km_tpu_torch.models.finder import VariantFinder
from km_tpu_torch.models.pathfinder import OverlapGraph
from km_tpu_torch.models.sequence import TargetSeq, target_kmers
from km_tpu_torch.models.table import CountTable
from km_tpu_torch.models.walk import NodeBudgetExceeded, Walker
from km_tpu_torch.ops import batch_walk as port_batch_walk

CAT = f"{REFDATA}/catalog/GRCh38"
TARGETS = sorted(os.path.splitext(f)[0] for f in os.listdir(CAT))
SAMPLES = sorted(os.path.splitext(f)[0] for f in os.listdir(f"{REFDATA}/jf"))
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _batches(seed, sizes, invalid=0.02):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 4, n).astype(np.uint8), rng.random(n) > invalid)
            for n in sizes]


# -- the host half of ops.count --------------------------------------------


@pytest.mark.parametrize("k", [1, 5, 31])
def test_window_valid_matches_km_tpu(k):
    for _codes, valid in _batches(50 + k, (40, 1000, k), invalid=0.1):
        np.testing.assert_array_equal(count.window_valid(valid, k),
                                      km_count.window_valid(valid, k))


@pytest.mark.parametrize("k,canonical,min_count", [
    (31, True, 1), (31, False, 1), (7, True, 2), (4, True, 3),
    (4, False, 1), (1, True, 1)])
def test_count_batches_host_matches_km_tpu(k, canonical, min_count):
    batches = _batches(60 + k, (5000, 3, 12000, 0, 700))
    got = count.count_batches_host(iter(batches), k, canonical, min_count)
    want = km_count.count_batches_host(iter(batches), k, canonical,
                                       min_count)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    assert len(got[0]) > 0


@pytest.mark.parametrize("case", ["disjoint", "overlap", "dups_within",
                                  "empty_left", "both_empty"])
def test_merge_runs_matches_km_tpu(case):
    rng = np.random.default_rng(70)

    def run(n, unique=True):
        keys = np.sort(rng.integers(0, 400, n, dtype=np.uint64))
        if unique:
            keys = np.unique(keys)
        return keys, rng.integers(1, 50, len(keys)).astype(np.uint32)

    a, b = {
        "disjoint": ((np.arange(5, dtype=np.uint64), np.ones(5, np.int64)),
                     (np.arange(9, 12, dtype=np.uint64),
                      np.ones(3, np.int64))),
        "overlap": (run(200), run(300)),
        "dups_within": (run(200, unique=False), run(100, unique=False)),
        "empty_left": ((np.empty(0, np.uint64), np.empty(0, np.int64)),
                       run(50)),
        "both_empty": ((np.empty(0, np.uint64), np.empty(0, np.int64)),) * 2,
    }[case]
    got = count.merge_runs(*a, *b)
    want = km_count.merge_runs(*a, *b)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == want[1].dtype
    assert int(got[1].sum()) == int(a[1].sum()) + int(b[1].sum())


@pytest.mark.parametrize("chunk,k", [(64, 31), (100, 5), (4096, 31),
                                     (32, 31)])
def test_chunk_stream_and_coalesce_match_km_tpu(chunk, k):
    batches = _batches(80 + chunk, (1000, 10, 333, k, k - 1, 2 * chunk))
    got = list(count.chunk_stream(iter(batches), chunk, k))
    want = list(km_count.chunk_stream(iter(batches), chunk, k))
    assert len(got) == len(want) > 0
    for (gc, gv), (wc, wv) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gv, wv)
        assert len(gc) == chunk
    got = list(count._coalesce_batches(iter(batches), k, 4 * chunk))
    want = list(km_count._coalesce_batches(iter(batches), k, 4 * chunk))
    assert len(got) == len(want) > 0
    for (gc, gv), (wc, wv) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gv, wv)
    # the pieces' windows tile the stream's: counting them gives the
    # stream's counts
    pieces = count.chunk_stream(
        count._coalesce_batches(iter(batches), k, 4 * chunk), chunk, k)
    a = count.count_batches_host(pieces, k)
    b = km_count.count_batches_host(iter(batches), k)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


# -- models -----------------------------------------------------------------


def _target_text(name):
    seqs, _ = read_target(f"{CAT}/{name}.fa")
    return "".join(seqs)


def _tables(sample):
    theirs = KmTable.from_jf(f"{REFDATA}/jf/{sample}.jf")
    return convert.count_table_from_km_tpu(theirs), theirs


@pytest.mark.parametrize("name", TARGETS)
def test_target_seq_matches_km_tpu(name):
    text = _target_text(name)
    for k in (21, 31):
        mine, theirs = TargetSeq(text, name, k), KmTarget(text, name, k)
        np.testing.assert_array_equal(mine.ref_mer, theirs.ref_mer)
        assert (mine.first_kmer, mine.last_kmer, mine.seq, mine.name) == \
            (theirs.first_kmer, theirs.last_kmer, theirs.seq, theirs.name)
        index = {int(m): i for i, m in enumerate(mine.ref_mer)}
        mine.set_index(index)
        theirs.set_index(index)
        assert mine.seq_index == theirs.seq_index
        back = convert.target_from_km_tpu(theirs)
        assert type(back) is TargetSeq
        np.testing.assert_array_equal(back.ref_mer, theirs.ref_mer)


def test_target_errors_match_km_tpu():
    for fn in (target_kmers, km_target_kmers):
        with pytest.raises(ValueError,
                           match="found multiple times in reference dup"):
            fn("A" * 32, "dup", 31)
    for cls in (TargetSeq, KmTarget):
        with pytest.raises(ValueError, match="shorter than k=31"):
            cls("ACGT", "short", 31)


@pytest.mark.parametrize("sample", SAMPLES)
def test_walker_discovers_km_tpu_nodes(sample):
    """The same nodes with the same counts in the same insertion order,
    on every catalog target, with tight and loose thresholds."""
    mine, theirs = _tables(sample)
    for name in TARGETS:
        target = TargetSeq(_target_text(name), name, mine.k)
        for ratio, n_cut, stack, brk in ((0.05, 5, 500, 10), (0.3, 2, 40, 2)):
            got = Walker(mine, ratio, n_cut, stack, brk).discover(
                target.ref_mer)
            want = KmWalker(theirs, ratio, n_cut, stack, brk).discover(
                target.ref_mer)
            assert list(got.items()) == list(want.items()), (name, ratio)


def test_node_budget_is_one_class_in_the_port():
    """The walk's overrun is the class that the batched path raises and
    catches, with km_tpu's message; km_tpu's own class is another."""
    assert port_batch.NodeBudgetExceeded is NodeBudgetExceeded
    assert port_batch_walk.NodeBudgetExceeded is NodeBudgetExceeded
    assert NodeBudgetExceeded is not KmBudget
    assert issubclass(NodeBudgetExceeded, SystemExit)
    mine, theirs = _tables("03H116_ITD")
    name = "FLT3-ITD_exons_13-15"
    target = TargetSeq(_target_text(name), name, mine.k)
    with pytest.raises(NodeBudgetExceeded) as got:
        Walker(mine, 0.05, 5, max_node=10).discover(target.ref_mer)
    with pytest.raises(KmBudget) as want:
        KmWalker(theirs, 0.05, 5, max_node=10).discover(target.ref_mer)
    assert str(got.value) == str(want.value) == \
        "ERROR: Node query count limit exceeded: max=10"


def _random_graph(cls, seed):
    rng = np.random.default_rng(seed)
    k = 9
    n = int(rng.integers(6, 60))
    # a backbone chain of overlapping k-mers plus random extra ones
    codes = rng.integers(0, 4, n + k - 1)
    keys = []
    for i in range(n):
        key = 0
        for c in codes[i:i + k]:
            key = (key << 2) | int(c)
        keys.append(key)
    keys = list(dict.fromkeys(keys + [int(x) for x in
                                      rng.integers(0, 1 << (2 * k), 10)]))
    g = cls(keys, k)
    n_ref = min(n, len(keys)) // 2
    g.set_edges(list(range(n_ref - 1)), list(range(1, n_ref)), 0.01)
    g.set_edge(g.first_node, 0, 0.01)
    g.set_edge(n_ref - 1, g.last_node, 0.01)
    return g


@pytest.mark.parametrize("seed", range(6))
def test_overlap_graph_matches_km_tpu(seed):
    mine, theirs = _random_graph(OverlapGraph, seed), \
        _random_graph(KmGraph, seed)
    mine.init_paths()
    theirs.init_paths()
    for name in ("succ_ptr", "succ_ids", "succ_w"):
        np.testing.assert_array_equal(getattr(mine, name),
                                      getattr(theirs, name), err_msg=name)
    assert mine.all_shortest() == theirs.all_shortest()
    assert len(mine.all_shortest()) >= 1


@pytest.mark.parametrize("seed", range(5))
def test_quant_matches_km_tpu(seed):
    rng = np.random.default_rng(90 + seed)
    n = int(rng.integers(20, 80))
    ref = list(range(n // 2))
    alt = ref[:5] + list(range(n // 2, n)) + ref[8:]
    dup = ref + ref[3:9]
    paths = [ref, alt, dup][:2 + seed % 2]
    counts = list(rng.integers(0, 400, n))
    np.testing.assert_array_equal(quant.build_contrib(paths, n),
                                  km_quant.build_contrib(paths, n))
    got, want = quant.quantify(paths, counts), km_quant.quantify(paths,
                                                                 counts)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    got = quant.reference_adjust(*got, counts)
    want = km_quant.reference_adjust(*want, counts)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for mod in (quant, km_quant):
        with pytest.raises(IndexError, match="references node"):
            mod.build_contrib([[0, n + 3]], n)
    args = ("db", "q", "Insertion\t4:/TCTG:4", 0.4837, 2422.04, 2428, 0,
            "ACGT", 0.5, 2613.96, "ACG", "vs_ref")
    assert str(quant.PathRow(*args)) == str(km_quant.PathRow(*args))
    assert quant.PathRow.HEADER == km_quant.PathRow.HEADER
    assert quant.PathRow(*args).type == "Insertion"
    assert quant.PathRow(*args)[4] == "0.484"


def test_classify_matches_km_tpu():
    """diff_paths, merge_kmers and name_variant on every alternative path
    that the five fixtures' own targets yield."""
    pairs = [("02H025_NPM1", "NPM1_4ins_exons_10-11utr"),
             ("02H033_DNMT3A_sub", "DNMT3A_R882_exon_23"),
             ("03H112_IandI", "FLT3-ITD_exons_13-15"),
             ("03H116_ITD", "FLT3-ITD_exons_13-15"),
             ("05H094_FLT3-TKD_del", "FLT3-TKD_exon_20")]
    named = 0
    for sample, name in pairs:
        mine, _ = _tables(sample)
        f = VariantFinder(TargetSeq(_target_text(name), name, mine.k), mine)
        f.find_alt_paths()
        keys = f._keys_arr()
        ref = f.target.seq_index
        for path in f.alt_paths:
            assert classify.diff_paths(ref, path, f.k) == \
                tuple(km_classify.diff_paths(ref, path, f.k))
            for skip in (True, False):
                assert classify.merge_kmers(keys, path, f.k, skip) == \
                    km_classify.merge_kmers(keys, path, f.k, skip)
            assert classify.name_variant(keys, ref, path, f.k) == \
                km_classify.name_variant(keys, ref, path, f.k)
            named += 1
    assert named >= 5


def _rows(finder):
    finder.find_alt_paths()
    finder.quantify_paths()
    finder.quantify_clusters()
    return [str(r) for r in finder.sorted_rows()]


@pytest.mark.parametrize("sample", SAMPLES)
@pytest.mark.parametrize("name", TARGETS)
def test_variant_finder_rows_match_km_tpu(name, sample):
    """Every GRCh38 catalog target against every bundled table: the same
    rows, as text."""
    mine, theirs = _tables(sample)
    text = _target_text(name)
    got = _rows(VariantFinder(TargetSeq(text, name, mine.k), mine))
    want = _rows(KmFinder(KmTarget(text, name, theirs.k), theirs))
    assert got == want
    assert any(r.split("\t")[2] == "Reference" for r in got)


@pytest.mark.parametrize("jf,fa", [("SYN1_itd", "SYN1_two_exons"),
                                   ("SYN1_sub", "SYN1_two_exons")])
def test_variant_finder_rows_on_synthetic_fixtures(jf, fa):
    theirs = KmTable.from_jf(os.path.join(FIXTURES, jf + ".jf"))
    mine = CountTable.from_jf(os.path.join(FIXTURES, jf + ".jf"))
    seqs, _ = read_target(os.path.join(FIXTURES, fa + ".fa"))
    text = "".join(seqs)
    got = _rows(VariantFinder(TargetSeq(text, fa, mine.k), mine, count=2))
    want = _rows(KmFinder(KmTarget(text, fa, theirs.k), theirs, count=2))
    assert got == want and len(got) > 1
