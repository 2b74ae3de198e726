"""Catalog walk against a count table of realistic size: host vs device.

The port's form of km_tpu's ``scripts/bigtable_walk.py``. At the size of
the bundled fixtures (a few thousand records) every host lookup hits the
cache. A real RNA-seq sample's table holds 1e8-1e9 records, where each
host binary-search probe takes ~27 cache-missing hops over gigabytes.
This script builds such a table honestly: the bundled fixture's records
united with ``--extra`` million random k-mers whose counts (1..4) all lie
below the ``-c 5`` child threshold, so every walk, path and report row
equals the fixture-only run's (checked), while every lookup searches the
whole table.

    python -m km_tpu_torch.scripts.bigtable_walk [--extra 100]
                                                 [--targets 400]
                                                 [--device cuda]

prints one JSON line with km_tpu's keys: the host and device warm times
of the cycled catalog, and the one-time cost of the table's upload. The
table is 8 bytes of key and 4 of count a record on the host, and 16 on
the device (int64 keys and counts).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.batch import run_catalog
from ..models.table import CountTable
from ..ops.device_table import DeviceCountTable
from ..refdata import catalog_targets, jf_path

SAMPLE = "03H116_ITD"
WARM_RUNS = 3


def union_table(fixture: CountTable, n_extra: int, seed: int = 0
                ) -> CountTable:
    """``fixture``'s records united with ``n_extra`` random keys below
    2^62 with counts 1..4 (seed 0, a stable sort, the first of equal
    keys kept): the child threshold max(sum * ratio, 5) >= 5 rejects
    every random key, so a catalog's rows must equal the fixture-only
    run's, while every lookup searches the full table."""
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 1 << 62, n_extra, dtype=np.uint64)
    keys = np.concatenate([fixture.keys, rand])
    del rand
    counts = np.concatenate([
        fixture.counts.astype(np.uint32),
        rng.integers(1, 5, n_extra, dtype=np.int64).astype(np.uint32)])
    order = np.argsort(keys, kind="stable")
    keys, counts = keys[order], counts[order]
    del order
    # a random key equals a fixture key with probability ~1e-11 each;
    # drop such a duplicate anyway (the fixture's record comes first)
    uniq = np.concatenate([[True], keys[1:] != keys[:-1]])
    if not uniq.all():
        keys, counts = keys[uniq], counts[uniq]
    return CountTable.from_arrays(keys, counts, fixture.k, fixture.canonical,
                                  name=fixture.name, presorted=True)


def _rows_text(rows) -> list[list[str]]:
    return [[str(r) for r in row] for row in rows]


def _best_of(runs: int, fn):
    """(the last result, the least seconds) of ``runs`` calls."""
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return out, best


def bigtable_walk(n_extra: int = 100_000_000, n_targets: int = 400,
                  device="cuda", sample: str = SAMPLE):
    """The cycled catalog of ``n_targets`` targets against ``sample``'s
    fixture united with ``n_extra`` random below-threshold keys, on the
    host path and on ``device``. Returns (record, rows): the record is
    the JSON line's dict, rows the three runs' rows as text ('fixture',
    'host', 'device'). Raises if the big table changed a row."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    fixture = CountTable.from_jf(jf_path(sample))
    fixture.name = sample
    targets = catalog_targets(n_targets, fixture.k)

    t0 = time.perf_counter()
    big = union_table(fixture, n_extra)
    build_s = time.perf_counter() - t0
    sys.stderr.write("table records: %d (%.1f GB host)\n"
                     % (big.n_kmers, big.keys.nbytes / 1e9))

    rows_small = _rows_text(run_catalog(targets, fixture, walk="host"))
    t0 = time.perf_counter()
    rows_host = _rows_text(run_catalog(targets, big, walk="host"))
    host_first_s = time.perf_counter() - t0
    _, host_s = _best_of(WARM_RUNS,
                         lambda: run_catalog(targets, big, walk="host"))
    sys.stderr.write("host warm best: %.3fs\n" % host_s)

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    table = DeviceCountTable.from_host(big, device=dev)
    if on_card:
        torch.cuda.synchronize(dev)
    upload_s = time.perf_counter() - t0
    run_catalog(targets, table)  # cold: stack depth learned, graphs built
    upload_plus_first_s = time.perf_counter() - t0
    rows_dev, dev_s = _best_of(WARM_RUNS, lambda: run_catalog(targets, table))
    rows_dev = _rows_text(rows_dev)
    sys.stderr.write("device warm best: %.3fs\n" % dev_s)

    if rows_host != rows_small:
        raise AssertionError(
            "below-threshold random keys changed the host rows")
    if rows_dev != rows_small:
        raise AssertionError(
            "below-threshold random keys changed the device rows")
    record = {
        "metric": "catalog_walk_bigtable",
        "table_records": int(big.n_kmers),
        "targets": n_targets,
        "host_warm_s": host_s,
        "device_warm_s": dev_s,
        "device_upload_plus_first_s": upload_plus_first_s,
        "rows_match_fixture_only_run": True,
        "device": str(dev),
        "rows": sum(len(r) for r in rows_small),
        "build_s": build_s,
        "upload_s": upload_s,
        "host_first_s": host_first_s,
        "table_device_bytes": int(table.keys.numel()) * 16,
        "hbm_envelope_mb": (torch.cuda.max_memory_allocated(dev) / 1e6
                            if on_card else None),
    }
    return record, dict(fixture=rows_small, host=rows_host, device=rows_dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--extra", type=int, default=100, metavar="M",
                    help="millions of random below-threshold k-mers "
                         "(default 100: 1e8 records)")
    ap.add_argument("--targets", type=int, default=400,
                    help="targets of the cycled catalog (default 400)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    opts = ap.parse_args(argv)
    record, _rows = bigtable_walk(opts.extra * 1_000_000, opts.targets,
                                  device=opts.device)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
