"""The port's other device counter on CPU tensors (the kernels' plain
versions): ``count_batches_device_compact`` (``count --mode chunked``),
against km_tpu's function of the same name (JAX on the CPU) and
``count_batches_host``. Keys and counts are compared exactly, with the
native merge and with the numpy fallback. Then ``--mode`` through both
CLIs, and under a 2-process gloo group, where the sharded count runs
whatever the mode."""

import numpy as np
import pytest

import torch
import torch.distributed as dist

from km_tpu_torch import cli as tcli
from km_tpu_torch.models.table import CountTable as PortTable
from km_tpu_torch.ops import count as tcount

from test_torch_parallel import spawn

torch.set_num_threads(1)

CHUNK = 1 << 12       # bases per chunk, for both packages
SORT_CHUNK = 1 << 10  # the port's sort chunk: four to a chunk


def _km():
    """km_tpu's count module, imported when a test calls this: the
    spawned ranks import this module too and load no JAX."""
    from km_tpu.ops import count as jcount

    return jcount


def _reads_with_n(rng):
    """Reads off a reference, so k-mers repeat; every 37th base invalid."""
    ref = rng.integers(0, 4, 3000, dtype=np.uint8)
    out = []
    for o in rng.integers(0, len(ref) - 90, 150):
        valid = np.ones(90, bool)
        valid[::37] = False
        out.append((ref[o:o + 90].copy(), valid))
    return out


def _short_batch(rng):
    """Batches shorter than k (no window) between ordinary ones."""
    mk = lambda n: (rng.integers(0, 4, n, dtype=np.uint8), np.ones(n, bool))
    first = mk(700)
    return [first, mk(9), mk(15), mk(700), mk(3), first]


def _one_chunk(rng):
    """Less than one chunk: a single run, whose own duplicates (the
    repeat lies in another sort-chunk) must still be collapsed."""
    codes = rng.integers(0, 4, 3000, dtype=np.uint8)
    codes[2000:2400] = codes[100:500]
    return [(codes, rng.random(3000) > 0.01)]


def _spans_sort_chunks(rng):
    """Several chunks; a 600-base repeat every 1500 bases, so its keys
    lie in different sort-chunks of one chunk and in different chunks."""
    codes = rng.integers(0, 4, 20000, dtype=np.uint8)
    for at in range(1500, 19000, 1500):
        codes[at:at + 600] = codes[:600]
    return [(codes, rng.random(20000) > 0.005)]


def _empty(rng):
    return []


CASES = {"reads_with_n": _reads_with_n, "short_batch": _short_batch,
         "one_chunk": _one_chunk, "spans_sort_chunks": _spans_sort_chunks,
         "empty": _empty}


def _batches(case):
    return CASES[case](np.random.default_rng(31))


def _load_km_native(tries: int = 5) -> None:
    """Loads km_tpu's native library, which it builds in place on first
    use with ``make -B``: workers that start together build and load it
    at once, and one may find it half written and keep ``_load_failed``.
    Under an exclusive lock, a failed load is cleared and tried again."""
    import fcntl
    import os
    import tempfile
    import time

    from km_tpu import native as km_native

    lock = os.path.join(tempfile.gettempdir(), "km_tpu_native_load.lock")
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            for attempt in range(tries):
                if km_native.available():
                    return
                km_native._lib = None
                km_native._load_failed = False
                time.sleep(0.5 * (attempt + 1))
            assert km_native.available(), (
                "km_tpu's native library %s does not load"
                % km_native._LIB_PATH)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _mask_native(monkeypatch, native_on):
    if native_on:
        from km_tpu_torch import native

        _load_km_native()
        assert native.available()
        return
    import km_tpu.native

    monkeypatch.setattr(km_tpu.native, "available", lambda: False)
    monkeypatch.setattr(tcount.native, "available", lambda: False)


def _equal(got, want):
    assert got[0].dtype == np.uint64 and got[1].dtype == np.uint32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(np.asarray(got[1], np.int64),
                                  np.asarray(want[1], np.int64))


@pytest.mark.parametrize("native_on", [True, False],
                         ids=["native", "numpy_merge"])
@pytest.mark.parametrize("min_count", [1, 2])
@pytest.mark.parametrize("canonical", [True, False],
                         ids=["canonical", "as_seen"])
@pytest.mark.parametrize("k", [16, 17, 31])
@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_matches_km_tpu_and_host(case, k, canonical, min_count,
                                         native_on, monkeypatch):
    _mask_native(monkeypatch, native_on)
    jcount = _km()
    kw = dict(canonical=canonical, min_count=min_count)
    host = jcount.count_batches_host(iter(_batches(case)), k, **kw)
    if case != "empty":
        assert len(host[0])
    np.testing.assert_array_equal(
        tcount.count_batches_host(iter(_batches(case)), k, **kw)[0], host[0])

    stats = {}
    compact = tcount.count_batches_device_compact(
        iter(_batches(case)), k, chunk=CHUNK, device="cpu",
        sort_chunk=SORT_CHUNK, stats=stats, **kw)
    _equal(compact, host)
    _equal(compact, jcount.count_batches_device_compact(
        iter(_batches(case)), k, chunk=CHUNK, **kw))
    assert stats["readback_bytes"] == 16 * stats["runs"]
    assert stats["pack_launches"] == stats["sort_runs_launches"] == 0
    if case == "spans_sort_chunks":
        assert stats["chunks"] > 1 and stats["runs"] > stats["unique"]
    if case == "one_chunk":
        assert stats["chunks"] == 1 and stats["runs"] == stats["unique"]
    if case == "empty":
        assert stats["chunks"] == stats["runs"] == stats["total"] == 0


def test_chunk_runs_are_globally_sorted_and_summed():
    """One chunk's runs as they are read back: ascending distinct keys
    and no SENTINEL, although the chunk sort orders keys only within its
    sort-chunks, and counts that sum to the chunk's valid windows."""
    from km_tpu_torch.device import SENTINEL

    codes, valid = _spans_sort_chunks(np.random.default_rng(3))[0]
    codes, valid = codes[:CHUNK], valid[:CHUNK]
    k = 21
    keys, lengths = tcount.count_chunk_device(
        torch.from_numpy(codes), torch.from_numpy(valid), k,
        sort_chunk=SORT_CHUNK)
    live = keys[lengths > 0].numpy()
    assert (np.diff(live) < 0).any()  # sorted per sort-chunk only
    rkeys, rcnt = tcount.chunk_runs_device(
        torch.from_numpy(codes), torch.from_numpy(valid), k,
        sort_chunk=SORT_CHUNK)
    assert rkeys.dtype == rcnt.dtype == torch.int64
    assert (np.diff(rkeys.numpy()) > 0).all()
    assert (rkeys != SENTINEL).all() and (rcnt > 0).all()
    assert int(rcnt.sum()) == int(tcount.window_valid(valid, k).sum())
    assert len(rkeys) < len(live)  # keys spanning sort-chunks were summed


@pytest.mark.parametrize("chunk", [16, 31])
def test_chunk_must_exceed_k(chunk):
    for fn in (tcount.count_batches_device_compact,
               tcount.count_batches_device_stream):
        with pytest.raises(ValueError, match="chunk must exceed k"):
            fn(iter([]), 31, chunk=chunk, device="cpu")


# -- the CLIs ----------------------------------------------------------------


def _fastq(path, n_reads=400, seed=17):
    rng = np.random.default_rng(seed)
    ref = "".join(rng.choice(list("ACGT"), 2500))
    with open(path, "w") as f:
        for i, o in enumerate(rng.integers(0, len(ref) - 80, n_reads)):
            seq = ref[o:o + 80]
            if i % 7 == 0:
                seq = seq[:40] + "N" + seq[41:]
            f.write("@r%d\n%s\n+\n%s\n" % (i, seq, "I" * 80))
    return str(path)


def _table(path):
    t = PortTable.load(str(path))
    return t.keys, t.counts, t.k, t.canonical


@pytest.mark.parametrize("min_count", [1, 2])
def test_modes_through_both_clis_write_equal_tables(tmp_path, min_count):
    """The port's ``count --device cpu`` in each mode, and km_tpu's CLI
    in each mode (whose size rule counts so small a file on the host,
    whatever the mode): one table, equal to the numpy count of the
    parsed reads; and ``count_read_files`` rejects an unknown mode."""
    from km_tpu import cli as jcli
    from km_tpu_torch.io.fastq import read_batches
    from km_tpu_torch.tools.count import count_read_files

    fq = _fastq(tmp_path / "reads.fq")
    common = ["-k", "21", "-L", str(min_count)]
    tables = {}
    for mode in ("auto", "stream", "chunked"):
        out = str(tmp_path / ("port_%s.npz" % mode))
        stats = tcli.main(["count", "--device", "cpu", "--mode", mode,
                           *common, "-o", out, fq])
        # both device modes sum the chunks' runs; the stream's M1 also
        # counts its bucket rounds
        assert "runs" in stats
        assert ("m1_rounds" in stats) == (mode != "chunked")
        assert ("retries" in stats) == (mode != "chunked")
        tables["port_" + mode] = _table(out)
        out = str(tmp_path / ("km_%s.npz" % mode))
        jcli.main(["count", "--mode", mode, *common, "-o", out, fq])
        tables["km_" + mode] = _table(out)
    out = str(tmp_path / "port_host.npz")
    tcli.main(["count", "--device", "host", "--mode", "chunked", *common,
               "-o", out, fq])
    tables["port_host"] = _table(out)

    hk, hc = tcount.count_batches_host(read_batches([fq]), 21,
                                       min_count=min_count)
    assert len(hk) > 1000
    for name, (keys, counts, k, canonical) in tables.items():
        assert (k, canonical) == (21, True), name
        assert keys.dtype == np.uint64 and counts.dtype == np.uint32, name
        np.testing.assert_array_equal(keys, hk, err_msg=name)
        np.testing.assert_array_equal(counts, hc, err_msg=name)
    with pytest.raises(ValueError, match="mode"):
        count_read_files([fq], 21, device="cpu", mode="compact")
    with pytest.raises(SystemExit):
        tcli.main(["count", "--device", "cpu", "--mode", "compact", "-o",
                   str(tmp_path / "x.npz"), fq])


def test_cohort_counts_its_reads_in_the_mode_given(tmp_path):
    """``cohort --mode chunked`` on a FASTQ sample writes the reports of
    ``--mode stream``."""
    from km_tpu_torch.refdata import catalog_fa

    fq = _fastq(tmp_path / "reads.fq")
    target = catalog_fa("FLT3-TKD_exon_20")
    reports = {}
    for mode in ("stream", "chunked"):
        out = tmp_path / mode
        tcli.main(["cohort", "--device", "cpu", "--mode", mode, "-k", "21",
                   "-t", target, "-o", str(out), fq])
        reports[mode] = (out / "reads" / "FLT3-TKD_exon_20.tsv").read_text()
    assert reports["chunked"] == reports["stream"]
    assert reports["stream"].startswith("Sample")


def _rank_count(rank, world, tmp, mode):
    """One rank of a gloo group: the port's ``count`` CLI in ``mode``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{mode}",
                            rank=rank, world_size=world)
    stats = tcli.main(["count", "--device", "cpu", "--mode", mode, "-k",
                       "21", "-L", "1", "-o", f"{tmp}/{mode}.npz",
                       f"{tmp}/reads.fq"])
    # the sharded count's numbers, whatever the mode
    assert "steps" in stats and "runs" not in stats, stats
    dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["chunked", "stream"])
def test_mode_under_a_process_group_gives_the_sharded_table(tmp_path, mode):
    from km_tpu_torch.io.fastq import read_batches

    fq = _fastq(tmp_path / "reads.fq")
    spawn(_rank_count, 2, tmp_path, mode)
    keys, counts, k, canonical = _table(tmp_path / (mode + ".npz"))
    hk, hc = tcount.count_batches_host(read_batches([fq]), 21, min_count=1)
    assert (k, canonical) == (21, True)
    np.testing.assert_array_equal(keys, hk)
    np.testing.assert_array_equal(counts, hc)
