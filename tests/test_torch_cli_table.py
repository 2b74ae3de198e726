"""find_mutation --batch from the command line on a jellyfish table, on
the CPU at a small size: the rows it prints against the benchmark's
plain reference (benchmark/reference/catalog_ref.py), and the spans and
counters of the table's load: ``table.read`` (io/jf.py::read_jf),
``table.sort`` (models/table.py::CountTable.from_arrays) and
``table.upload`` (ops/device_table.py::DeviceCountTable), nested in the
phases ``load_table`` and ``table_to_device``. A call's phase table is
its own, and its device table does not outlive it."""

import contextlib
import gc
import io
import os
import sys
import time
import weakref

import numpy as np
import pytest

from km_tpu_torch import cli
from km_tpu_torch.io import jf
from km_tpu_torch.models.table import CountTable
from km_tpu_torch.ops import device_table, encode
from km_tpu_torch.ops.device_table import DeviceCountTable
from km_tpu_torch.refdata import DATA_DIR, catalog_dir
from km_tpu_torch.utils import profiling

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark"))

from reference import catalog_ref  # noqa: E402
from reference import jf as jf_ref  # noqa: E402
from reference.fasta import read_target  # noqa: E402

FIXTURES = ("02H025_NPM1", "02H033_DNMT3A_sub", "03H112_IandI",
            "03H116_ITD", "05H094_FLT3-TKD_del")
EXTRA = 20000
PARAMS = dict(ratio=0.05, count=5, steps=500, branchs=10, nodes=10000)
CATALOG = catalog_dir("GRCh38")
LOAD_SPANS = ("table.read", "table.sort", "table.upload")


@pytest.fixture(autouse=True)
def fresh_tables():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def spans(monkeypatch):
    """(name, start ns, end ns) of every span the program opens, taken
    around ``profiling.phase`` as the benchmark's tracer takes them."""
    out = []
    phase = profiling.phase

    @contextlib.contextmanager
    def spanned(name):
        t0 = time.perf_counter_ns()
        try:
            with phase(name):
                yield
        finally:
            out.append((name, t0, time.perf_counter_ns()))

    monkeypatch.setattr(profiling, "phase", spanned)
    return out


def sample_records(seed: int):
    """The five fixtures united (counts summed) with EXTRA random
    canonical k-mers of count 1 to 4: (keys uint64 ascending, counts)."""
    keys, counts = [], []
    for name in FIXTURES:
        t = jf_ref.read_jf(os.path.join(DATA_DIR, "jf", name + ".jf"))
        keys.append(t.keys)
        counts.append(t.counts.astype(np.int64))
    rng = np.random.default_rng(seed)
    keys.append(encode.canonical(
        rng.integers(0, 1 << 62, EXTRA, dtype=np.uint64), 31))
    counts.append(rng.integers(1, 5, EXTRA))
    uk, inv = np.unique(np.concatenate(keys), return_inverse=True)
    return uk, np.bincount(inv, weights=np.concatenate(counts)).astype(
        np.int64)


def write_sample(tmp_path, seed: int):
    """A .jf of the sample in jellyfish's hash order: (path, keys,
    counts)."""
    keys, counts = sample_records(seed)
    path = str(tmp_path / ("sample%d.jf" % seed))
    jf_ref.write_jf(path, keys, counts, 31, True)
    return path, keys, counts


def run_cli(table_path: str) -> list[str]:
    """The rows ``find_mutation --batch --device cpu`` prints, ``#``
    lines and the header left out."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["find_mutation", "--batch", "--device", "cpu", CATALOG,
                  table_path])
    return [line for line in buf.getvalue().splitlines()
            if not line.startswith("#")
            and not line.startswith("Database\tQuery\t")]


def reference_rows(keys, counts, name: str) -> list[str]:
    sequences = []
    for f in os.listdir(CATALOG):  # the order the command line takes
        seqs, _ = read_target(os.path.join(CATALOG, f))
        sequences.append(("".join(seqs), os.path.splitext(f)[0]))
    table = catalog_ref.HostTable(keys, counts, 31, True, name)
    return [str(r) for rows in catalog_ref.catalog_rows(
        sequences, table, PARAMS) for r in rows]


def counters() -> tuple[int, int, int, int]:
    return (jf.read_jf.records, jf.read_jf.bytes, CountTable.host_sorted,
            DeviceCountTable.host_sorted)


def within(spans, inner: str, outer: str) -> bool:
    (_, a0, a1), = [s for s in spans if s[0] == inner]
    (_, b0, b1), = [s for s in spans if s[0] == outer]
    return b0 <= a0 <= a1 <= b1


@pytest.mark.parametrize("seed", [2 ** 31 + 7, 11])
def test_a_jf_sample_prints_the_reference_rows_and_times_its_load(
        tmp_path, spans, seed):
    path, keys, counts = write_sample(tmp_path, seed)
    in_file = jf_ref.read_jf(path).keys
    assert (in_file != np.sort(in_file)).any()  # not in key order
    before = counters()
    got = run_cli(path)
    want = reference_rows(keys, counts, path)
    assert got == want and len(want) > 9
    names = [s[0] for s in spans]
    for name in LOAD_SPANS:
        assert names.count(name) == 1, name
    assert within(spans, "table.read", "load_table")
    assert within(spans, "table.sort", "load_table")
    assert within(spans, "table.upload", "table_to_device")
    records, nbytes, host, dev = (a - b for a, b in zip(counters(), before))
    assert (records, nbytes) == (len(keys), os.path.getsize(path))
    assert (host, dev) == (len(keys), 0)


def test_a_presorted_npz_opens_no_sort(tmp_path, spans):
    keys, counts = sample_records(5)
    path = str(tmp_path / "sample.npz")
    CountTable.from_arrays(keys, counts, 31, True,
                           presorted=True).save(path)
    before = counters()
    got = run_cli(path)
    assert got == reference_rows(keys, counts, path)
    names = [s[0] for s in spans]
    assert "table.sort" not in names and "table.read" not in names
    assert names.count("table.upload") == 1
    assert within(spans, "table.upload", "table_to_device")
    assert counters() == before


def test_two_calls_keep_their_own_phases_and_free_their_table(
        tmp_path, spans, monkeypatch):
    paths = [write_sample(tmp_path, seed)[0] for seed in (1, 2)]
    tables = []
    init = DeviceCountTable.__init__

    def noted(self, *args, **kwargs):
        init(self, *args, **kwargs)
        tables.append(weakref.ref(self))

    monkeypatch.setattr(device_table.DeviceCountTable, "__init__", noted)
    was_enabled = gc.isenabled()
    gc.disable()  # the table must go with its last reference, not a cycle
    try:
        run_cli(paths[0])
        first = profiling.report()
        assert tables[0]() is None
        del spans[:]
        run_cli(paths[1])
        second = profiling.report()
        assert tables[1]() is None
    finally:
        if was_enabled:
            gc.enable()
    assert set(LOAD_SPANS) <= set(first) and set(LOAD_SPANS) <= set(second)
    for name, sec in second.items():
        # each phase's seconds lie within the second call's own spans
        assert sec <= sum((b - a) / 1e9 for n, a, b in spans
                          if n == name), name
