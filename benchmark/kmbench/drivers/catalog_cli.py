"""The catalog from the command line (``catalog.cold_cli``): one
``find_mutation --batch --device <card> <catalog dir> <sample>.jf`` a
call, as a user runs it once a sample, on a table the process has not
seen: the file read and decoded, the table sorted, uploaded, and the
catalog run once against it.

Set-up draws each sample's table as the catalog cells draw theirs
(``catalog.big_table``, the five fixtures united with ``extra_records``
random records; sample i from seed + i), puts its records in the hash
order of a jellyfish ``binary/sorted`` file on the card (the key's bits
XOR the columns of a ``matrix1`` drawn from the seed, then one stable
sort by the hash) and writes the ``.jf`` into a directory of its own,
removed at ``close``. Then one call on the first sample's table, saved
as a ``.npz`` (which ``find_mutation`` takes as sorted), warms up every
kernel and shape of a call at the table's size without the host's sort;
the file is removed after it. The window's calls take the samples in
turn, starting with the second, so no two calls in a row read the same
file. A call is one
``km_tpu_torch.cli.main`` with its standard output in a buffer; its
work is the catalog's targets.

``correct`` compares every call with the plain reference
(reference/catalog_ref.py) on a host table of that sample's records,
named with the sample's path as ``find_mutation`` names its table: the
printed rows, ``#`` lines and the header left out, whose text differs
(limit 0); the widest gap of the rows' unrounded values (a wrapper
round ``tools.batchmode.run_catalog`` keeps them), as the catalog
cells; the records of the table the call put on the card against the
records written, and a digest of the table on the card against that of
the sample's sorted records (``table_digest``; a wrapper round
``DeviceCountTable.__init__`` notes the table's ``n`` and takes the
digest on the card, a few milliseconds of the call); and, as the
catalog cells, the device calls and host sweeps. Neither wrapper keeps
a reference to the table.

``main_find_mut`` resets the program's phase table at its start, so the
driver adds up each call's ``profiling.report()`` itself, with the
counters of the table's load (``io.jf.read_jf.records``,
``read_jf.bytes`` and the records sorted on the host by
``CountTable.from_arrays`` and ``DeviceCountTable``), each None where
the program has no such counter.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import tempfile
import weakref

import numpy as np
import torch

from reference import catalog_ref
from reference import jf as jf_ref
from reference.fasta import read_target
from . import catalog

LIMITS = dict(catalog.LIMITS, table_records_gap=0, table_digest_gap=0)
DIGEST_CHUNK = 1 << 20


def hash_columns(seed: int, c: int, r: int) -> list[int]:
    """``matrix1``'s ``c`` columns of ``r`` bits, drawn from the seed."""
    rng = np.random.default_rng([seed, 0x6a66])
    return [int(x) for x in rng.integers(0, 1 << r, c, dtype=np.uint64)]


def hash_order(keys: torch.Tensor, columns, c: int) -> torch.Tensor:
    """The order of int64 ``keys`` ascending by jellyfish's matrix hash
    (``reference/jf.py::jf_hash``: column j XORed in where key bit
    c-1-j is set), equal hashes in the keys' own order."""
    h = torch.zeros_like(keys)
    for j, col in enumerate(columns):
        h ^= ((keys >> (c - 1 - j)) & 1) * int(col)
    return torch.sort(h, stable=True)[1]


def table_digest(keys: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """An order-sensitive digest of a table's int64 keys and counts, on
    their device: their sums and their sums weighted by the records'
    1-based positions, each mod 2**64. Taken a chunk at a time, so that
    no temporary is larger than a chunk."""
    out = torch.zeros(4, dtype=torch.int64, device=keys.device)
    for lo in range(0, len(keys), DIGEST_CHUNK):
        k = keys[lo:lo + DIGEST_CHUNK]
        c = counts[lo:lo + DIGEST_CHUNK]
        w = torch.arange(lo + 1, lo + 1 + len(k), dtype=torch.int64,
                         device=keys.device)
        out += torch.stack([k.sum(), c.sum(), (k * w).sum(), (c * w).sum()])
    return out


def write_jf(path: str, keys: np.ndarray, counts: np.ndarray, k: int,
             canonical: bool, header: dict, columns, device) -> int:
    """Write a ``binary/sorted`` ``.jf`` of the records (keys uint64,
    counts below 2**32), in the hash order of ``columns``, each record
    (8 B of little-endian key, 4 of count) laid out on ``device``;
    returns the file's bytes. ``header`` gives ``size``,
    ``counter_len`` (4), ``val_len`` and ``cmdline``."""
    if header["counter_len"] != 4 or (
            len(counts) and int(counts.max()) >= 1 << 32):
        raise ValueError("the records' counts are written in 4 bytes")
    c, r = 2 * k, header["size"].bit_length() - 1
    kd = torch.from_numpy(keys.view(np.int64)).to(device)
    order = hash_order(kd, columns, c)
    n = len(keys)
    rec = torch.empty((n, 12), dtype=torch.uint8, device=device)
    rec[:, :8] = kd[order].view(torch.uint8).view(n, 8)
    del kd
    cd = torch.from_numpy(counts.astype(np.int64)).to(device)[order]
    del order
    rec[:, 8:] = cd.to(torch.int32).view(torch.uint8).view(n, 4)
    del cd
    raw = rec.cpu().numpy()
    del rec
    meta = {"alignment": 8, "canonical": bool(canonical),
            "cmdline": list(header["cmdline"]), "counter_len": 4,
            "format": "binary/sorted", "key_len": c,
            "matrix1": {"c": c, "r": r, "columns": [int(x) for x in columns]},
            "max_reprobe": jf_ref._MAX_REPROBE, "reprobes": jf_ref._REPROBES,
            "size": header["size"], "val_len": header["val_len"]}
    blob = json.dumps(meta, sort_keys=True).encode("ascii")
    hlen = -(-(len(blob) + 9) // 8) * 8 - 9
    with open(path, "wb") as f:
        f.write(b"%09d" % hlen)
        f.write(blob + b" " * (hlen - len(blob)))
        f.write(memoryview(raw).cast("B"))
    return 9 + hlen + raw.nbytes


def load_counters() -> dict:
    """The program's counters of the table's load, None where it has no
    such counter."""
    from km_tpu_torch.io import jf
    from km_tpu_torch.models import table
    from km_tpu_torch.ops import device_table

    host = [getattr(table.CountTable, "host_sorted", None),
            getattr(device_table.DeviceCountTable, "host_sorted", None)]
    return {"records": getattr(jf.read_jf, "records", None),
            "bytes": getattr(jf.read_jf, "bytes", None),
            "host_sorted": None if None in host else sum(host)}


class Sample:
    def __init__(self, path: str, keys: np.ndarray, counts: np.ndarray):
        self.path, self.keys, self.counts = path, keys, counts


class Driver(catalog.Driver):
    """The catalog driver's parameters and span wrapper; its own set-up,
    call and comparison."""

    def setup(self) -> None:
        c, t = self.config, self.traffic
        fk, fc, k, canonical = catalog.fixture_union(c["fixtures"])
        if k != c["k"] or canonical != c["canonical"]:
            raise ValueError("the fixtures are not k=%d, canonical=%s"
                             % (c["k"], c["canonical"]))
        self.catalog_dir = os.path.join(catalog.DATA, "catalog")
        self.files = [os.path.join(self.catalog_dir, f)
                      for f in os.listdir(self.catalog_dir)]
        if len(self.files) != t["targets"]:
            raise ValueError("%d targets in %s, the traffic says %d"
                             % (len(self.files), self.catalog_dir,
                                t["targets"]))
        header = c["jf_header"]
        columns = hash_columns(self.seed, 2 * k,
                               header["size"].bit_length() - 1)
        self.workdir = tempfile.mkdtemp(prefix="kmbench-")
        self.samples = []
        for i in range(t["samples"]):
            keys, counts = catalog.big_table(
                fk, fc, c["extra_records"], c["extra_max_count"],
                self.seed + i, self.device, k, canonical)
            path = os.path.join(self.workdir, "sample%d.jf" % (i + 1))
            size = write_jf(path, keys, counts, k, canonical, header,
                            columns, self.device)
            self.samples.append(Sample(path, keys, counts))
            self.info.setdefault("table_records", []).append(len(keys))
            self.info.setdefault("jf_bytes", []).append(size)
        self.info["fixture_records"] = len(fk)
        self._install()
        first = self.samples[0]
        warm = os.path.join(self.workdir, "warm.npz")
        np.savez(warm, keys=first.keys, counts=first.counts,
                 k=np.int64(k), canonical=np.bool_(canonical))
        self.begin_window()
        self._cli(warm)
        os.remove(warm)
        self.info["warm_call_s"] = {name: round(sec, 3)
                                    for name, sec in self.phases.items()}
        self.turn = 1

    def _install(self) -> None:
        """The wrappers that keep each call's row values and note the
        records of its device table, and nothing of the table."""
        from km_tpu_torch.ops import device_table
        from km_tpu_torch.tools import batchmode

        self.saved = (batchmode.run_catalog,
                      device_table.DeviceCountTable.__init__)
        run_catalog, init = self.saved
        driver = self

        def kept_rows(*args, **kwargs):
            rows = run_catalog(*args, **kwargs)
            driver.rows = [[catalog.row_record(r) for r in t] for t in rows]
            return rows

        def noted(table, *args, **kwargs):
            init(table, *args, **kwargs)
            driver.table_n = table.n
            driver.digest = table_digest(table.keys, table.counts)
            driver.table_ref = weakref.ref(table)

        batchmode.run_catalog = kept_rows
        device_table.DeviceCountTable.__init__ = noted

    def _restore(self) -> None:
        from km_tpu_torch.ops import device_table
        from km_tpu_torch.tools import batchmode

        if getattr(self, "saved", None):
            batchmode.run_catalog, device_table.DeviceCountTable.__init__ = \
                self.saved
            self.saved = None

    def begin_window(self) -> None:
        self.phases: dict = {}
        self.counters0 = load_counters()
        self.calls0 = catalog.device_calls()
        self.outlived = 0
        self.allocated: list = []

    def _cli(self, path: str) -> list:
        """One command-line call on the table at ``path``: its printed
        rows, ``#`` lines and the header left out. Adds its phases to the
        window's."""
        from km_tpu_torch import cli
        from km_tpu_torch.utils import profiling

        self.rows = self.table_n = self.digest = self.table_ref = None
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["find_mutation", "--batch", "--device",
                      self.device.type, self.catalog_dir, path])
        for name, sec in profiling.report().items():
            self.phases[name] = self.phases.get(name, 0.0) + sec
        if self.table_ref is not None and self.table_ref() is not None:
            self.outlived += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.allocated.append(torch.cuda.memory_allocated(self.device))
        return [line for line in buf.getvalue().splitlines()
                if not line.startswith("#")
                and not line.startswith("Database\tQuery\t")]

    def call(self):
        sample = self.turn % len(self.samples)
        self.turn += 1
        printed = self._cli(self.samples[sample].path)
        out = dict(sample=sample, printed=printed, rows=self.rows,
                   n=self.table_n,
                   digest=None if self.digest is None
                   else self.digest.tolist())
        self.rows = self.digest = None
        return out, len(self.files)

    def observe(self) -> dict:
        """The phases of the window's calls so far, summed over them, and
        the load's counters over the same calls."""
        now = load_counters()
        counters = {name: (None if v is None or self.counters0[name] is None
                           else v - self.counters0[name])
                    for name, v in now.items()}
        return {"phases": dict(self.phases), "table_counters": counters}

    def end_window(self) -> dict:
        after = catalog.device_calls()
        self.calls = {key: after[key] - self.calls0[key] for key in after}
        self.info.update(tables_outlived_call=self.outlived,
                         allocated_after_call_gib=[
                             round(b / 2 ** 30, 4) for b in self.allocated])
        return self.observe()

    def check(self, results) -> dict:
        self._restore()
        refs = [self.reference(s) for s in self.samples]
        digests = [table_digest(
            torch.from_numpy(s.keys.view(np.int64)),
            torch.from_numpy(s.counts.astype(np.int64))).tolist()
            for s in self.samples]
        differing = gap = records_gap = digest_gap = 0
        for out in results:
            texts, recs = refs[out["sample"]]
            got = out["printed"]
            d = abs(len(got) - len(texts)) + sum(
                a != b for a, b in zip(got, texts))
            if out["rows"] is None:
                d2, g = sum(len(r) for r in recs) or 1, 1.0
            else:
                d2, g = catalog.compare_rows(out["rows"], recs)
            differing, gap = max(differing, d, d2), max(gap, g)
            written = len(self.samples[out["sample"]].keys)
            records_gap = max(records_gap, written if out["n"] is None
                              else abs(out["n"] - written))
            want = digests[out["sample"]]
            digest_gap = max(digest_gap, len(want) if out["digest"] is None
                             else sum(a != b for a, b in
                                      zip(out["digest"], want)))
        n = len(results)
        short = sum(max(0, n - self.calls[key])
                    for key in ("walk", "sweeps", "nnls"))
        self.info.update(device_calls=self.calls,
                         rows=[len(texts) for texts, _ in refs])
        return {"rows_differing": (differing, LIMITS["rows_differing"]),
                "value_gap": (gap, LIMITS["value_gap"]),
                "table_records_gap": (records_gap,
                                      LIMITS["table_records_gap"]),
                "table_digest_gap": (digest_gap, LIMITS["table_digest_gap"]),
                "device_calls_short": (short, LIMITS["device_calls_short"]),
                "host_sweeps": (self.calls["host_sweeps"],
                                LIMITS["host_sweeps"])}

    def reference(self, sample: Sample, dtype=np.float64):
        """The reference's rows of every target for one sample, in the
        order the command line takes the catalog's files: (their printed
        text, a list per target of row records)."""
        c = self.config
        table = catalog_ref.HostTable(sample.keys, sample.counts, c["k"],
                                       c["canonical"], sample.path)
        sequences = []
        for path in self.files:
            seqs, _ = read_target(path)
            sequences.append(("".join(seqs),
                              os.path.splitext(os.path.basename(path))[0]))
        rows = catalog_ref.catalog_rows(sequences, table, self.params(),
                                        dtype)
        return ([str(r) for t in rows for r in t],
                [[catalog.row_record(r) for r in t] for t in rows])

    def close(self) -> None:
        self._restore()
        if getattr(self, "workdir", None):
            shutil.rmtree(self.workdir, ignore_errors=True)
            self.workdir = None
