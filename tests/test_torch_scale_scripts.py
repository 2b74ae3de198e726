"""The port's two scale scripts on the CPU at a small size.

``scripts.scale_count``: the synthesized chunk, byte for byte, against a
numpy uint32 transcription of km_tpu's formula (scripts/scale_count.py,
``one_chunk``); the table of a few chunks against km_tpu's numpy count of
the same codes; the overflow. ``scripts.bigtable_walk``: the union table
and the three runs' rows against km_tpu's host catalog on the same table.
Both ``-m`` entry points: km_tpu's JSON keys, the card by default, and no
JAX in their process."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import torch

from km_tpu.models.batch import run_catalog as km_run_catalog
from km_tpu.models.sequence import TargetSeq as KmTargetSeq
from km_tpu.models.table import CountTable as KmCountTable
from km_tpu.ops import count as jcount

from km_tpu_torch import convert
from km_tpu_torch.models.table import CountTable
from km_tpu_torch.ops.count import CountCapacityOverflow
from km_tpu_torch.refdata import catalog_sequences, jf_path
from km_tpu_torch.scripts import bigtable_walk as bw
from km_tpu_torch.scripts import scale_count as sc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 31


def _km_tpu_chunk(base: np.ndarray, idx: int) -> np.ndarray:
    """km_tpu's ``one_chunk`` synthesis (scripts/scale_count.py:67-76) in
    numpy, with its types: the roll's shift is an int32 product, h is
    uint32 arithmetic. Arrays, not scalars, so that numpy wraps."""
    n = len(base)
    shift = (np.array([idx], np.int32) * np.int32(99991))[0]
    codes = np.roll(base, int(shift))
    pos = np.arange(n, dtype=np.uint32)
    h = (pos * np.uint32(2654435761)
         + np.array([idx], np.uint32) * np.uint32(40503))
    assert h.dtype == np.uint32
    mut = h < np.uint32(429497)
    return np.where(mut, ((h >> np.uint32(16)) & np.uint32(3)).astype(
        np.uint8), codes)


# idx 4096 makes idx * 99991 and idx * 40503 large; at 30000 the int32
# product wraps, and at 2**20 the uint32 one does
@pytest.mark.parametrize("idx", [0, 1, 7, 4096, 30000, 1 << 20])
@pytest.mark.parametrize("log2_chunk", [16, 20])
def test_synthesized_chunk_is_km_tpus_byte_for_byte(idx, log2_chunk):
    base = sc.reference_chunk(1 << log2_chunk, ref_log2=12)
    assert base.dtype == np.uint8 and len(base) == 1 << log2_chunk
    np.testing.assert_array_equal(base[:1 << 12], base[1 << 12:2 << 12])
    want = _km_tpu_chunk(base, idx)
    got = sc.ChunkSynthesizer(torch.from_numpy(base))(idx)
    assert got.dtype == torch.uint8
    assert got.numpy().tobytes() == want.tobytes()
    if log2_chunk == 20:  # ~1e-4 of the positions are mutated
        rolled = np.roll(base, (idx * 99991 + 2 ** 31) % 2 ** 32 - 2 ** 31)
        assert 30 < (want != rolled).sum() < 200


def test_reference_is_seed_7_and_tiles_whole():
    ref = np.random.default_rng(7).integers(0, 4, 1 << 10, dtype=np.uint8)
    np.testing.assert_array_equal(sc.reference_chunk(1 << 12, 10),
                                  np.tile(ref, 4))
    with pytest.raises(ValueError):
        sc.reference_chunk(3 << 10, 11)


@pytest.mark.parametrize("chunks", [1, 4])
def test_scale_count_table_matches_km_tpu_host_count(chunks):
    chunk = 1 << 16
    record, keys, counts = sc.scale_count(chunks, 1 << 18, chunk=chunk,
                                          ref_log2=12, device="cpu",
                                          sort_chunk=1 << 12)
    base = sc.reference_chunk(chunk, 12)
    batches = [(_km_tpu_chunk(base, i), np.ones(chunk, bool))
               for i in range(chunks)]
    hk, hc = jcount.count_batches_host(batches, K, canonical=True,
                                       min_count=1)
    np.testing.assert_array_equal(keys, hk)
    np.testing.assert_array_equal(counts, hc.astype(np.int64))
    windows = chunks * (chunk - K + 1)
    assert record["total_kmers"] == windows == int(counts.sum())
    assert record["distinct_kmers"] == len(hk)
    assert record["bases_counted"] == chunks * chunk
    assert record["hbm_envelope_mb"] is None  # no card, nothing measured
    assert record["pack_launches"] == record["sort_runs_launches"] == 0
    assert (record["value"] is None) == (chunks == 1)


def test_scale_count_overflow_raises():
    # the 2^12-base reference alone has ~4,000 distinct k-mers
    with pytest.raises(CountCapacityOverflow) as e:
        sc.scale_count(3, 1 << 11, chunk=1 << 14, ref_log2=12, device="cpu",
                       sort_chunk=1 << 12)
    assert e.value.capacity == 1 << 11


# -- bigtable_walk -----------------------------------------------------------


def _km_union(fixture, n_extra):
    """km_tpu's big table (scripts/bigtable_walk.py:56-71) from its own
    fixture table, line for line."""
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 1 << 62, n_extra, dtype=np.uint64)
    keys = np.concatenate([fixture.keys, rand])
    counts = np.concatenate([
        fixture.counts.astype(np.uint32),
        rng.integers(1, 5, n_extra, dtype=np.int64).astype(np.uint32)])
    order = np.argsort(keys, kind="stable")
    keys, counts = keys[order], counts[order]
    uniq = np.concatenate([[True], keys[1:] != keys[:-1]])
    keys, counts = keys[uniq], counts[uniq]
    return KmCountTable.from_arrays(keys, counts, fixture.k,
                                    fixture.canonical, name=fixture.name,
                                    presorted=True)


def test_bigtable_walk_rows_match_fixture_and_km_tpu():
    n_extra, n_targets = 50_000, 18
    record, rows = bw.bigtable_walk(n_extra, n_targets, device="cpu")
    assert rows["host"] == rows["device"] == rows["fixture"]
    assert record["rows_match_fixture_only_run"] is True
    assert record["targets"] == n_targets == len(rows["fixture"])
    assert record["rows"] == sum(len(r) for r in rows["fixture"]) > n_targets
    assert record["table_device_bytes"] == 16 * record["table_records"]

    km_fixture = KmCountTable.from_jf(jf_path(bw.SAMPLE))
    km_fixture.name = bw.SAMPLE
    km_big = _km_union(km_fixture, n_extra)
    assert record["table_records"] == km_big.n_kmers == \
        km_fixture.n_kmers + n_extra
    # the port builds the same table from its own fixture table
    carried = convert.count_table_from_km_tpu(km_big)
    fixture = CountTable.from_jf(jf_path(bw.SAMPLE))
    mine = bw.union_table(fixture, n_extra)
    np.testing.assert_array_equal(mine.keys, carried.keys)
    np.testing.assert_array_equal(mine.counts, carried.counts)
    assert mine.counts.dtype == carried.counts.dtype == np.uint32

    km_targets = [KmTargetSeq(seq, name, km_fixture.k)
                  for seq, name in catalog_sequences(n_targets)]
    want = km_run_catalog(km_targets, km_big, walk="host")
    assert [[str(r) for r in rs] for rs in want] == rows["device"]


def test_union_table_keeps_the_fixture_record_of_an_equal_key():
    fixture = CountTable.from_jf(jf_path(bw.SAMPLE))
    # seed 0's first random key, planted in the fixture with a count of 9
    planted = np.random.default_rng(0).integers(0, 1 << 62, 5,
                                                dtype=np.uint64)[:1]
    keys = np.concatenate([fixture.keys, planted])
    counts = np.concatenate([fixture.counts, np.array([9], np.uint32)])
    small = CountTable.from_arrays(keys, counts, fixture.k, True)
    big = bw.union_table(small, 5)
    assert big.n_kmers == small.n_kmers + 4
    assert (np.diff(big.keys.astype(np.int64)) > 0).all()
    at = np.searchsorted(big.keys, planted)[0]
    assert big.keys[at] == planted[0] and big.counts[at] == 9


# -- the entry points --------------------------------------------------------


def _json_keys_of_km_tpu_script(name):
    """The keys of the JSON line that scripts/<name>.py prints, read from
    its source."""
    with open(os.path.join(REPO, "scripts", name + ".py")) as f:
        return re.findall(r'^\s+"(\w+)":', f.read(), re.M)


def test_scale_count_main_prints_km_tpus_keys(capsys):
    assert sc.main(["--chunks", "2", "--capacity", "16", "--chunk", "14",
                    "--device", "cpu"]) == 0
    record = json.loads(capsys.readouterr().out.splitlines()[-1])
    want = _json_keys_of_km_tpu_script("scale_count")
    assert len(want) == 13 and list(record)[:13] == want
    assert record["metric"] == "count_gb_scale_device_kmers_per_s"
    assert record["unit"] == "kmers/s" and record["value"] > 0
    assert record["accumulator_slots"] == 1 << 16
    assert record["bases_counted"] == 2 << 14


def test_bigtable_walk_main_prints_km_tpus_keys(capsys):
    assert bw.main(["--extra", "0", "--targets", "9", "--device",
                    "cpu"]) == 0
    record = json.loads(capsys.readouterr().out.splitlines()[-1])
    want = _json_keys_of_km_tpu_script("bigtable_walk")
    assert len(want) == 7 and list(record)[:7] == want
    assert record["metric"] == "catalog_walk_bigtable"
    assert record["targets"] == 9 and record["table_records"] == 2560


@pytest.mark.parametrize("module", [sc, bw], ids=["scale_count",
                                                  "bigtable_walk"])
def test_entry_points_run_on_the_card_unless_asked(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        module.main([])  # --device defaults to cuda


@pytest.mark.parametrize("argv", [
    ["km_tpu_torch.scripts.scale_count", "--chunks", "2", "--capacity", "16",
     "--chunk", "14", "--device", "cpu"],
    ["km_tpu_torch.scripts.bigtable_walk", "--extra", "0", "--targets", "9",
     "--device", "cpu"]], ids=["scale_count", "bigtable_walk"])
def test_entry_point_loads_nothing_of_km_tpu(argv, tmp_path):
    """``python -m km_tpu_torch.scripts.<name>`` in a fresh process: one
    JSON line, and at its end no module named km_tpu, km_tpu.* or jax."""
    code = (
        "import runpy, sys\n"
        "sys.argv = %r\n"
        "try:\n"
        "    runpy.run_module(sys.argv[0], run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    assert not exc.code, exc.code\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('km_tpu', 'jax'))\n"
        "assert not bad, bad\n"
        "print('NO_KM_TPU')\n" % (argv,))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == "NO_KM_TPU"
    assert "metric" in json.loads(lines[-2])
