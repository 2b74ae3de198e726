"""The catalog from the command line (``catalog.cold_cli``) at a size the
CPU runs: a small run is ``correct`` and its traced run reports the
table's load, the driver's hash order is the reference's jellyfish
order, and ``correct`` catches the faults a cold call can have: records
lost in the load, the keys searched in the file's order, a record's key
or count changed or two records swapped on the card where no row shows
it, a printed row altered."""

import contextlib

import numpy as np
import pytest
import torch

import small
from kmbench.drivers import catalog, catalog_cli
from reference import jf as jf_ref

CELL = "catalog.cold_cli"
NEW_METRICS = ("catalog.table_read_pct", "catalog.table_sort_pct",
               "catalog.table_upload_pct", "catalog.cold_call_pct",
               "catalog.host_sorted_pct")
# the catalog cells' spans, which every command-line call opens too
CATALOG_METRICS = ("catalog.graph_host_pct", "catalog.walk_pct",
                   "catalog.sweeps_nnls_pct", "catalog.walk_sync_pct",
                   "catalog.sweeps_nnls_sync_pct", "catalog.graph_build_pct",
                   "catalog.gc_pct")


class ColdCliSpec(small.SmallSpec):
    """The cell at the CPU's size: 2e4 random records a sample."""

    def config(self, name):
        c = super().config(name)
        if name == "leucegene_catalog_cli":
            c.update(extra_records=20000)
        return c


@contextlib.contextmanager
def patched(obj, name, value):
    saved = vars(obj)[name]  # a class's own entry, not a bound method
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def run(traced=False, seconds=0.2):
    return small.run_small(CELL, traced=traced, spec=ColdCliSpec(),
                           seconds=seconds)


def test_a_small_run_is_correct_and_reports_the_load():
    line, obs = run(traced=True)
    assert line["correct"], line["compared"]
    metrics = line["metrics"]
    for name in NEW_METRICS + CATALOG_METRICS:
        assert name in metrics, name
    assert metrics["catalog.host_sorted_pct"]["value"] == 100
    shares = sum(metrics[n]["value"] for n in NEW_METRICS[:4])
    assert 50 < shares <= 100
    c = obs["table_counters"]
    assert c["records"] == c["host_sorted"] > 0 and c["bytes"] > 12 * c[
        "records"]


def test_calls_take_the_samples_in_turn():
    spec = ColdCliSpec()
    w = spec.workload(CELL)
    d = catalog_cli.Driver(spec.config(w["config"]), spec.traffic(w["traffic"]),
                           small.SEED, torch.device("cpu"))
    try:
        d.setup()
        d.begin_window()
        got = [d.call()[0]["sample"] for _ in range(3)]
    finally:
        d.close()
    assert got == [1, 0, 1]


def test_the_table_digest_sees_every_record_and_its_place(monkeypatch):
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(rng.integers(0, 1 << 62, 1000, dtype=np.int64))
    counts = torch.from_numpy(rng.integers(1, 5, 1000, dtype=np.int64))
    whole = catalog_cli.table_digest(keys, counts).tolist()
    monkeypatch.setattr(catalog_cli, "DIGEST_CHUNK", 64)
    assert catalog_cli.table_digest(keys, counts).tolist() == whole
    swapped = keys.clone()
    swapped[[10, 11]] = swapped[[11, 10]]
    bumped = counts.clone()
    bumped[500] += 1
    for k, c in ((swapped, counts), (keys, bumped), (keys[:-1], counts[:-1])):
        assert catalog_cli.table_digest(k, c).tolist() != whole


def test_the_hash_order_is_jellyfish_order():
    fk, fc, k, canonical = catalog.fixture_union(["02H025_NPM1"])
    keys, _ = catalog.big_table(fk, fc, 5000, 4, small.SEED, "cpu", k,
                                canonical)
    columns = catalog_cli.hash_columns(small.SEED, 2 * k, 30)
    got = catalog_cli.hash_order(torch.from_numpy(keys.view(np.int64)),
                                 columns, 2 * k).numpy()
    want = np.argsort(jf_ref.jf_hash(keys, columns, 2 * k), kind="stable")
    np.testing.assert_array_equal(got, want)
    assert (got != np.arange(len(keys))).any()


def test_the_written_file_reads_back_in_hash_order(tmp_path):
    fk, fc, k, canonical = catalog.fixture_union(["03H116_ITD"])
    keys, counts = catalog.big_table(fk, fc, 3000, 4, 7, "cpu", k, canonical)
    header = ColdCliSpec().config("leucegene_catalog_cli")["jf_header"]
    columns = catalog_cli.hash_columns(7, 2 * k, 30)
    path = str(tmp_path / "s.jf")
    size = catalog_cli.write_jf(path, keys, counts, k, canonical, header,
                                columns, "cpu")
    got = jf_ref.read_jf(path)
    assert (got.k, got.canonical, size) == (k, canonical,
                                           len(open(path, "rb").read()))
    assert got.header["size"] == 1 << 30 and got.header["val_len"] == 12
    assert got.header["matrix1"] == {"c": 62, "r": 30, "columns": columns}
    order = np.argsort(jf_ref.jf_hash(keys, columns, 62), kind="stable")
    np.testing.assert_array_equal(got.keys, keys[order])
    np.testing.assert_array_equal(got.counts, counts[order])


def test_records_dropped_in_the_load_are_caught():
    from km_tpu_torch.io.jf import JFData
    from km_tpu_torch.models import table

    real = table.read_jf

    def half(path):
        d = real(path)
        n = len(d.keys) // 2
        return JFData(d.k, d.canonical, d.keys[:n], d.counts[:n], d.header)

    with patched(table, "read_jf", half):
        line, _ = run()
    assert not line["correct"]
    assert line["compared"]["table_records_gap"]["value"] > 0


def _count_changed(d):
    d.counts[len(d.counts) // 2] += 1


def _key_changed(d):
    d.keys[len(d.keys) // 2] ^= np.uint64(1 << 40)


def _swapped_on_the_card(table):
    mid = table.n // 2
    table.keys[[mid, mid + 1]] = table.keys[[mid + 1, mid]].clone()
    table.counts[[mid, mid + 1]] = table.counts[[mid + 1, mid]].clone()


@pytest.mark.parametrize("fault", ["count changed", "key changed",
                                   "two records swapped"])
def test_a_table_wrong_where_no_row_shows_it_is_caught(fault):
    """One random record's count or key changed in the load, or two
    neighbouring random records swapped on the card: the rows come out
    right, the table's digest does not."""
    from km_tpu_torch.models import table
    from km_tpu_torch.ops.device_table import DeviceCountTable

    real_read, init = table.read_jf, DeviceCountTable.__init__

    def read(path):
        d = real_read(path)
        (_count_changed if fault == "count changed" else _key_changed)(d)
        return d

    def swapped(self, *args, **kwargs):
        init(self, *args, **kwargs)
        _swapped_on_the_card(self)

    with contextlib.ExitStack() as stack:
        if fault == "two records swapped":
            stack.enter_context(patched(DeviceCountTable, "__init__",
                                        swapped))
        else:
            stack.enter_context(patched(table, "read_jf", read))
        line, _ = run()
    compared = line["compared"]
    assert not line["correct"]
    assert compared["table_digest_gap"]["value"] > 0
    assert compared["rows_differing"]["value"] == 0
    assert compared["table_records_gap"]["value"] == 0


def test_keys_searched_in_file_order_are_caught():
    """The sort skipped in ``CountTable.from_arrays`` and in
    ``DeviceCountTable``, which sorts unsorted keys itself."""
    from km_tpu_torch.device import u64_to_i64
    from km_tpu_torch.models.table import CountTable
    from km_tpu_torch.ops.device_table import DeviceCountTable

    from_arrays = CountTable.from_arrays.__func__
    init = DeviceCountTable.__init__

    def unsorted(cls, keys, counts, k, canonical, name="", presorted=False):
        return from_arrays(cls, keys, counts, k, canonical, name, True)

    def as_given(self, keys, counts, *args, **kwargs):
        init(self, keys, counts, *args, **kwargs)
        self.keys = torch.from_numpy(u64_to_i64(keys)).to(self.device)
        self.counts = torch.from_numpy(
            np.asarray(counts).astype(np.int64)).to(self.device)

    with patched(CountTable, "from_arrays", classmethod(unsorted)), \
            patched(DeviceCountTable, "__init__", as_given):
        line, _ = run()
    assert not line["correct"]
    assert line["compared"]["rows_differing"]["value"] > 0


def test_a_printed_row_altered_is_caught():
    from km_tpu_torch.tools import batchmode

    real = batchmode.run_catalog

    def altered(*args, **kwargs):
        rows = real(*args, **kwargs)
        next(t for t in rows if t)[0].note += " altered"
        return rows

    with patched(batchmode, "run_catalog", altered):
        line, _ = run()
    assert not line["correct"]
    assert line["compared"]["rows_differing"]["value"] > 0
    assert line["compared"]["value_gap"]["value"] <= catalog.VALUE_GAP_LIMIT
