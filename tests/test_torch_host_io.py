"""The port's host modules below the engine, each against its km_tpu
original on the same seeded inputs: ops.encode, utils.natsort,
utils.profiling, refdata, native, io.fasta, io.fastq, io.jf and the
count table's files. Integer and text code: equal arrays and equal
bytes, tolerance 0. A table file written by either package loads in the
other."""

import gzip
import os

import numpy as np
import pytest

import km_tpu.io.fasta as km_fasta
import km_tpu.io.fastq as km_fastq
import km_tpu.io.jf as km_jf
import km_tpu.native as km_native
import km_tpu.ops.encode as km_encode
import km_tpu.refdata as km_refdata
import km_tpu.utils.natsort as km_natsort
import km_tpu.utils.profiling as km_profiling
from km_tpu.models.table import CountTable as KmTable

import km_tpu_torch.io.fasta as fasta
import km_tpu_torch.io.fastq as fastq
import km_tpu_torch.io.jf as jf
import km_tpu_torch.native as native
import km_tpu_torch.ops.encode as encode
import km_tpu_torch.refdata as refdata
import km_tpu_torch.utils.natsort as natsort
import km_tpu_torch.utils.profiling as profiling
from km_tpu_torch import _build, convert
from km_tpu_torch.models.table import CountTable

REFDATA = km_refdata.DATA_DIR
CATALOG = sorted(os.listdir(f"{REFDATA}/catalog/GRCh38"))
JFS = sorted(os.listdir(f"{REFDATA}/jf"))
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _seq(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), n))


# -- ops.encode ------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3, 15, 16, 17, 21, 31, 32])
def test_encode_matches_km_tpu(k):
    rng = np.random.default_rng(100 + k)
    seq = _seq(rng, 400)
    keys = encode.pack_kmers(seq, k)
    np.testing.assert_array_equal(keys, km_encode.pack_kmers(seq, k))
    for name in ("revcomp", "canonical", "child_keys_forward",
                 "child_keys_backward"):
        np.testing.assert_array_equal(getattr(encode, name)(keys, k),
                                      getattr(km_encode, name)(keys, k),
                                      err_msg=name)
    codes = rng.integers(0, 4, 300).astype(np.uint8)
    np.testing.assert_array_equal(encode.pack_code_windows(codes, k),
                                  km_encode.pack_code_windows(codes, k))
    # round trips: string -> key -> string, and revcomp twice
    assert [encode.unpack_kmer(x, k) for x in keys[:50]] == \
        [seq[i:i + k] for i in range(50)]
    assert encode.pack_kmer(seq[:k]) == km_encode.pack_kmer(seq[:k]) \
        == int(keys[0])
    np.testing.assert_array_equal(
        encode.revcomp(encode.revcomp(keys, k), k), keys)
    comp = str.maketrans("ACGT", "TGCA")
    assert encode.unpack_kmer(encode.revcomp(keys[:1], k)[0], k) == \
        seq[:k].translate(comp)[::-1]


def test_encode_codes_and_errors():
    rng = np.random.default_rng(7)
    seq = _seq(rng, 200, "ACGTNacgtn-")
    np.testing.assert_array_equal(encode.seq_to_codes(seq),
                                  km_encode.seq_to_codes(seq))
    codes = rng.integers(0, 4, 64).astype(np.uint8)
    assert encode.codes_to_seq(codes) == km_encode.codes_to_seq(codes)
    assert len(encode.pack_kmers("ACG", 5)) == 0
    for mod in (encode, km_encode):
        with pytest.raises(ValueError, match="non-ACGT base 'N' at position 3"):
            mod.pack_kmers("ACGNACGT", 4)


# -- utils ------------------------------------------------------------------


def test_natsort_orders_like_km_tpu():
    rng = np.random.default_rng(8)
    names = ["chr%s:%d-%d" % (rng.choice(["1", "2", "10", "X", "5"]),
                              rng.integers(1, 3000), rng.integers(1, 99))
             for _ in range(200)]
    rows = [(n, "v%d" % rng.integers(0, 30), "%d" % rng.integers(0, 12))
            for n in names]
    for rev in ((), (1,), (0, 2)):
        got = sorted(rows, key=lambda r: natsort.natsortkey(*r, rev_ix=rev))
        want = sorted(rows,
                      key=lambda r: km_natsort.natsortkey(*r, rev_ix=rev))
        assert got == want
    assert sorted(["a10", "a9", "a1"], key=natsort.natsortkey) == \
        ["a1", "a9", "a10"]


def test_profiling_tables_are_separate():
    """Same behaviour, and each package keeps its own table of phases."""
    for mod in (profiling, km_profiling):
        mod.reset()
    with profiling.phase("walk"):
        pass
    with profiling.phase("walk"):
        pass
    with km_profiling.phase("nnls"):
        pass
    assert list(profiling.report()) == ["walk"]
    assert list(km_profiling.report()) == ["nnls"]
    assert profiling.report()["walk"] >= 0.0
    profiling.reset()
    assert profiling.report() == {}
    assert list(km_profiling.report()) == ["nnls"]
    km_profiling.reset()


def test_refdata_paths_and_variable(monkeypatch, tmp_path):
    assert refdata.DATA_DIR == km_refdata.DATA_DIR
    for build in ("GRCh37", "GRCh38"):
        assert refdata.catalog_dir(build) == km_refdata.catalog_dir(build)
    assert refdata.catalog_fa("FLT3-TKD_exon_20") == \
        km_refdata.catalog_fa("FLT3-TKD_exon_20")
    assert refdata.jf_path("03H116_ITD") == km_refdata.jf_path("03H116_ITD")
    assert os.path.exists(refdata.jf_path("03H116_ITD"))
    # the user's setting keeps its name in both packages
    import importlib

    monkeypatch.setenv("KM_TPU_REFDATA", str(tmp_path))
    try:
        assert importlib.reload(refdata).DATA_DIR == str(tmp_path) == \
            importlib.reload(km_refdata).DATA_DIR
    finally:
        monkeypatch.delenv("KM_TPU_REFDATA")
        importlib.reload(refdata)
        importlib.reload(km_refdata)


# -- io.fasta ---------------------------------------------------------------


@pytest.mark.parametrize("build", ["GRCh37", "GRCh38"])
def test_fasta_targets_match_km_tpu(build):
    cat = f"{REFDATA}/catalog/{build}"
    assert fasta.expand_target_files([cat]) == \
        km_fasta.expand_target_files([cat])
    for path in fasta.expand_target_files([cat]):
        assert fasta.read_target(path) == km_fasta.read_target(path)
        assert list(fasta.iter_fasta(path)) == list(km_fasta.iter_fasta(path))
    two = os.path.join(FIXTURES, "SYN1_two_exons.fa")
    assert fasta.read_target(two) == km_fasta.read_target(two)
    header = ">chr5:171410540-171410543 | exon=10 | gene=NPM1"
    assert fasta.parse_header_attrs(header) == \
        km_fasta.parse_header_attrs(header)


# -- io.fastq and native ----------------------------------------------------


def _write_fastq(path, seed, n_reads=400, read_len=100, opener=open):
    rng = np.random.default_rng(seed)
    with opener(path, "wt") as f:
        for i in range(n_reads):
            seq = "".join(rng.choice(list("ACGTN"), read_len,
                                     p=[0.24, 0.24, 0.24, 0.24, 0.04]))
            qual = "".join(chr(int(q)) for q in
                           rng.integers(33, 74, read_len))
            f.write(f"@read{i}\n{seq}\n+\n{qual}\n")


def _concat(batches):
    batches = list(batches)
    return (np.concatenate([c for c, _ in batches]),
            np.concatenate([v for _, v in batches]))


def test_native_library_is_the_ports_own():
    """Built from km_tpu_torch/native/kmio.cpp into the port's build
    directory, never km_tpu's checked-in library."""
    assert native.available(), native.unavailable_reason()
    assert native.unavailable_reason() is None
    path = native.require()._name
    assert path == _build.NATIVE_LIB_PATH
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert "km_tpu_torch" in path and os.path.exists(path)
    assert not _build.native_stale()


def test_native_build_failure_says_why(monkeypatch, tmp_path):
    """A failed build raises with the compiler's command and output; the
    loader keeps the reason and ``require`` raises it."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "NATIVE_LIB_PATH",
                        str(tmp_path / "libkmio.so"))
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "NATIVE_SRC", str(bad))
    with pytest.raises(_build.NativeLibraryError, match="bad.cpp failed"):
        _build.build_native()
    monkeypatch.setenv("CXX", "/nonexistent/compiler")
    with pytest.raises(_build.NativeLibraryError, match="nonexistent"):
        _build.build_native()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_reason", None)
    assert not native.available()
    assert "NativeLibraryError" in native.unavailable_reason()
    with pytest.raises(_build.NativeLibraryError, match="nonexistent"):
        native.require()


@pytest.mark.parametrize("quality", [None, "5", "A"])
@pytest.mark.parametrize("prefer_native", [True, False],
                         ids=["native", "python"])
def test_fastq_batches_match_km_tpu(tmp_path, quality, prefer_native):
    fq = str(tmp_path / "reads.fq")
    _write_fastq(fq, 21)
    got = _concat(fastq.read_batches([fq], min_quality=quality,
                                     prefer_native=prefer_native))
    want = _concat(km_fastq.read_batches([fq], min_quality=quality,
                                         prefer_native=prefer_native))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.bool_ and got[0].dtype == np.uint8


def test_fastq_small_batches_gzip_and_fasta_input(tmp_path):
    gz = str(tmp_path / "reads.fq.gz")
    _write_fastq(gz, 22, n_reads=120, read_len=150, opener=gzip.open)
    for prefer_native in (True, False):
        kw = dict(batch_bases=1 << 12, prefer_native=prefer_native)
        got = _concat(fastq.read_batches([gz], **kw))
        want = _concat(km_fastq.read_batches([gz], **kw))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert list(fastq.iter_reads(gz)) == list(km_fastq.iter_reads(gz))
    # FASTA input: the bundled catalog, native and Python
    fa = [f"{REFDATA}/catalog/GRCh38/{name}" for name in CATALOG]
    for prefer_native in (True, False):
        got = _concat(fastq.read_batches(fa, prefer_native=prefer_native))
        want = _concat(km_fastq.read_batches(fa,
                                             prefer_native=prefer_native))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    bad = tmp_path / "bad.txt"
    bad.write_text("hello\n")
    with pytest.raises(ValueError, match="not FASTA/FASTQ"):
        list(fastq.iter_reads(str(bad)))


def test_native_parse_chunk_and_malformed():
    data = b"@r1\nACGTN\n+\nIIII!\n@r2\nGG"
    for is_fastq, text in ((True, data), (False, b">s\nACGT\nNA\n>t\nCC\n")):
        got = native.parse_chunk(text, fastq=is_fastq, min_quality="+"
                                 if is_fastq else None)
        want = km_native.parse_chunk(text, fastq=is_fastq, min_quality="+"
                                     if is_fastq else None)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for mod in (native, km_native):
        with pytest.raises(ValueError, match="malformed FASTQ"):
            mod.parse_chunk(b"r1\nACGT\n+\nIIII\n", fastq=True)


@pytest.mark.parametrize("k,canonical", [(15, True), (31, True), (31, False),
                                         (4, False)])
def test_native_count_host_matches_km_tpu(k, canonical):
    rng = np.random.default_rng(13)
    codes = rng.integers(0, 4, 30_000).astype(np.uint8)
    valid = rng.random(30_000) > 0.02
    got = native.count_host(codes, valid, k, canonical)
    want = km_native.count_host(codes, valid, k, canonical)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].sum() > 0


def test_native_merge_sorted_runs_matches_km_tpu():
    rng = np.random.default_rng(15)
    runs = []
    for _ in range(7):
        keys = np.unique(rng.integers(0, 500, rng.integers(1, 80),
                                      dtype=np.uint64))
        runs.append((keys, rng.integers(1, 9, len(keys)).astype(np.int64)))
    runs.append((np.empty(0, np.uint64), np.empty(0, np.int64)))
    got = native.merge_sorted_runs(runs)
    want = km_native.merge_sorted_runs(runs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (np.diff(got[0].astype(np.int64)) > 0).all()


def test_native_dijkstra_matches_km_tpu():
    rng = np.random.default_rng(14)
    for _ in range(20):
        n = int(rng.integers(3, 120))
        deg = rng.integers(0, 5, n)
        ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
        ids = rng.integers(0, n, int(ptr[-1])).astype(np.int64)
        w = rng.choice(np.array([1.0, 0.01], np.float32), int(ptr[-1]))
        for start in (0, n - 1):
            np.testing.assert_array_equal(
                native.dijkstra_scanmin(ptr, ids, w, n, start),
                km_native.dijkstra_scanmin(ptr, ids, w, n, start))


# -- io.jf and the table files ---------------------------------------------


@pytest.mark.parametrize("name", JFS)
def test_read_jf_matches_km_tpu(name):
    path = f"{REFDATA}/jf/{name}"
    got, want = jf.read_jf(path), km_jf.read_jf(path)
    assert (got.k, got.canonical, got.header) == \
        (want.k, want.canonical, want.header)
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.counts.dtype == want.counts.dtype
    assert jf.read_header(path) == km_jf.read_header(path)
    cols = got.header["matrix1"]["columns"]
    c = got.header["matrix1"]["c"]
    np.testing.assert_array_equal(jf.jf_hash(got.keys, cols, c),
                                  km_jf.jf_hash(want.keys, cols, c))


def _tables_equal(a, b):
    assert (a.k, a.canonical) == (b.k, b.canonical)
    np.testing.assert_array_equal(a.keys, b.keys)
    np.testing.assert_array_equal(a.counts, b.counts)
    assert a.counts.dtype == b.counts.dtype


def _random_table(cls, seed, k, canonical, wide=False):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << (2 * k), 3000, dtype=np.uint64))
    counts = rng.integers(1, 5000, len(keys))
    if wide:
        counts[3] = (1 << 33) + 5
    return cls.from_arrays(keys, counts, k, canonical, presorted=True)


@pytest.mark.parametrize("ext", ["jf", "npz"])
@pytest.mark.parametrize("k,canonical,wide", [(31, True, False),
                                              (21, False, False),
                                              (16, True, True)])
def test_table_files_cross_between_packages(tmp_path, ext, k, canonical,
                                            wide):
    """The same bytes from both writers; either package's file loads in
    the other with equal keys, counts, k and canonical flag."""
    mine = _random_table(CountTable, 30 + k, k, canonical, wide)
    theirs = _random_table(KmTable, 30 + k, k, canonical, wide)
    _tables_equal(mine, theirs)
    a, b = str(tmp_path / f"port.{ext}"), str(tmp_path / f"km.{ext}")
    mine.save(a)
    theirs.save(b)
    if ext == "jf":
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    for path in (a, b):
        _tables_equal(CountTable.load(path), mine)
        _tables_equal(KmTable.load(path), mine)
        assert CountTable.load(path).name == path


@pytest.mark.parametrize("name", JFS)
def test_count_table_queries_match_km_tpu(name):
    path = f"{REFDATA}/jf/{name}"
    mine, theirs = CountTable.from_jf(path), KmTable.from_jf(path)
    _tables_equal(mine, theirs)
    assert mine.name == theirs.name == path
    _tables_equal(convert.count_table_from_km_tpu(theirs), mine)
    rng = np.random.default_rng(40)
    q = np.concatenate([mine.keys[rng.integers(0, len(mine.keys), 500)],
                        encode.revcomp(mine.keys[:200], mine.k),
                        rng.integers(0, 1 << (2 * mine.k), 500,
                                     dtype=np.uint64)])
    np.testing.assert_array_equal(mine.query_packed(q),
                                  theirs.query_packed(q))
    for forward in (True, False):
        got = mine.children_packed(q[:300], forward=forward)
        want = theirs.children_packed(q[:300], forward=forward)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        for key in q[:40]:
            assert mine.get_child_keys(int(key), 0.05, 5, forward) == \
                theirs.get_child_keys(int(key), 0.05, 5, forward)
    seq = encode.unpack_kmer(int(mine.keys[0]), mine.k) + "ACGTTGCA"
    np.testing.assert_array_equal(mine.cover(seq), theirs.cover(seq))
    assert mine.query(seq[:mine.k]) == theirs.query(seq[:mine.k]) > 0
    assert mine.n_kmers == theirs.n_kmers


def test_table_from_sequences_matches_km_tpu():
    rng = np.random.default_rng(41)
    seqs = [_seq(rng, 300) for _ in range(5)] + ["ACG"]
    for k, canonical, min_count in ((11, True, 1), (5, False, 2)):
        _tables_equal(
            CountTable.from_sequences(seqs, k, canonical, min_count),
            KmTable.from_sequences(seqs, k, canonical, min_count))
