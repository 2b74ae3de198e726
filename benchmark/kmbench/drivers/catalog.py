"""The catalog cells: one sample's catalog run back to back against its
table, resident on the card.

The table is the union of the bundled fixture tables (their counts
summed where a k-mer is in more than one) with ``extra_records`` random
canonical k-mers whose counts, 1 to 4, all lie below the child
threshold (at least ``count``, 5), so every row is the fixtures' while
every lookup searches a table of a sample's size. The random keys are
drawn, made canonical and sorted on the card from the seed. The traffic's ``targets`` are the 9
GRCh38 catalog targets cycled to that number. One call is one
``run_catalog``; its work is its targets.

``correct`` compares every call's rows with the plain reference's (km's
algorithm written plainly, reference/catalog_ref.py, target by target
on a host table of the same records): the rows whose printed text differs
(limit 0), and the widest gap of the rows' unrounded rVAF, expression
and reference expression, over the larger of the reference's value and
1. The device path is checked too: every call ran the walk, the sweeps
and NNLS on the card, and no graph took the host sweep.
"""

from __future__ import annotations

import contextlib
import math
import os

import numpy as np
import torch

from reference import catalog_ref
from reference.fasta import read_target
from reference.jf import read_jf

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data")
# the limit of value_gap, set from the readings in PERF.md (section 2)
VALUE_GAP_LIMIT = 1e-9
LIMITS = {"rows_differing": 0, "value_gap": VALUE_GAP_LIMIT,
          "device_calls_short": 0, "host_sweeps": 0}


def fixture_union(names) -> tuple[np.ndarray, np.ndarray, int, bool]:
    """The fixtures' records united, counts of equal keys summed."""
    keys, counts, ks, canon = [], [], set(), set()
    for name in names:
        jf = read_jf(os.path.join(DATA, "jf", name + ".jf"))
        keys.append(np.asarray(jf.keys, np.uint64))
        counts.append(np.asarray(jf.counts, np.int64))
        ks.add(jf.k)
        canon.add(bool(jf.canonical))
    if len(ks) != 1 or len(canon) != 1:
        raise ValueError("fixtures of different k or canonical form")
    uk, inv = np.unique(np.concatenate(keys), return_inverse=True)
    uc = np.bincount(inv, weights=np.concatenate(counts)).astype(np.int64)
    return uk, uc, ks.pop(), canon.pop()


def canonical_keys(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Each k-mer key (two bits a base, the first base highest) or its
    reverse complement, whichever is smaller, as a canonical table
    holds it."""
    rest, rc = keys ^ ((1 << (2 * k)) - 1), torch.zeros_like(keys)
    for _ in range(k):
        rc = (rc << 2) | (rest & 3)
        rest = rest >> 2
    return torch.minimum(keys, rc)


def big_table(fixture_keys, fixture_counts, extra: int, max_count: int,
              seed: int, device, k: int = 31, canonical: bool = True):
    """(keys uint64, counts int64) on the host, ascending: the fixture's
    records and ``extra`` random k-mers (canonical where the table is)
    with counts 1 to ``max_count``, drawn and sorted on ``device``; of
    equal keys the first (a fixture's) is kept."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    drawn = torch.randint(0, 1 << (2 * k), (extra,), generator=g,
                          device=device)
    if canonical:
        drawn = canonical_keys(drawn, k)
    keys = torch.cat([
        torch.from_numpy(fixture_keys.view(np.int64)).to(device), drawn])
    del drawn
    counts = torch.cat([
        torch.from_numpy(fixture_counts).to(device),
        torch.randint(1, max_count + 1, (extra,), generator=g,
                      device=device)])
    keys, order = torch.sort(keys, stable=True)
    counts = counts[order]
    del order
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    keys, counts = keys[first], counts[first]
    return keys.cpu().numpy().view(np.uint64), counts.cpu().numpy()


def catalog_sequences(n: int) -> list[tuple[str, str]]:
    """The 9 GRCh38 targets cycled to n, as (sequence, name) with each
    name <target>_<i>."""
    cat = os.path.join(DATA, "catalog")
    base = []
    for fn in sorted(os.listdir(cat)):
        seqs, _ = read_target(os.path.join(cat, fn))
        base.append(("".join(seqs), os.path.splitext(fn)[0]))
    return [(base[i % len(base)][0], "%s_%d" % (base[i % len(base)][1], i))
            for i in range(n)]


def device_calls() -> dict:
    from km_tpu_torch.ops import batch_walk, nnls, pathgraph

    return dict(walk=batch_walk.device_discover.calls,
                sweeps=pathgraph.sweep_kernel.calls,
                nnls=nnls.Refinement.calls,
                host_sweeps=pathgraph.batched_sweeps.host_fallbacks)


class Driver:
    kind = "catalog"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.info: dict = {}

    def params(self) -> dict:
        return {key: self.config[key]
                for key in ("ratio", "count", "steps", "branchs", "nodes")}

    def setup(self) -> None:
        from km_tpu_torch.models.sequence import TargetSeq
        from km_tpu_torch.ops.device_table import DeviceCountTable

        c = self.config
        fk, fc, k, canonical = fixture_union(c["fixtures"])
        if k != c["k"] or canonical != c["canonical"]:
            raise ValueError("the fixtures are not k=%d, canonical=%s"
                             % (c["k"], c["canonical"]))
        self.keys, self.counts = big_table(
            fk, fc, c["extra_records"], c["extra_max_count"], self.seed,
            self.device, k, canonical)
        self.info.update(table_records=len(self.keys),
                         fixture_records=len(fk))
        self.table = DeviceCountTable(self.keys, self.counts, k, canonical,
                                      name=c["table_name"],
                                      device=self.device)
        self.sequences = catalog_sequences(self.traffic["targets"])
        self.targets = [TargetSeq(s, n, k) for s, n in self.sequences]
        self.call()  # cold: the walk learns its stack depth, graphs captured

    def begin_window(self) -> None:
        from km_tpu_torch.utils import profiling

        profiling.reset()
        self.calls0 = device_calls()

    def call(self):
        from km_tpu_torch.models import batch

        rows = batch.run_catalog(
            self.targets, self.table, ratio=self.config["ratio"],
            count=self.config["count"], max_stack=self.config["steps"],
            max_break=self.config["branchs"], max_node=self.config["nodes"],
            on_budget="skip")
        return rows, len(self.targets)

    def observe(self) -> dict:
        """The program's phase seconds of the calls so far."""
        from km_tpu_torch.utils import profiling

        return {"phases": dict(profiling.report())}

    def end_window(self) -> dict:
        after = device_calls()
        self.calls = {key: after[key] - self.calls0[key] for key in after}
        return self.observe()

    @contextlib.contextmanager
    def traced(self, tracer):
        """Host spans of the program's phases (utils.profiling)."""
        from km_tpu_torch.utils import profiling

        phase = profiling.phase

        @contextlib.contextmanager
        def spanned(name):
            with tracer.span(name), phase(name):
                yield

        profiling.phase = spanned
        try:
            yield
        finally:
            profiling.phase = phase

    def check(self, results) -> dict:
        del self.table
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = self.reference()
        differing = gap = 0
        for rows in results:
            d, g = compare_rows([[row_record(r) for r in t] for t in rows],
                                ref)
            differing, gap = max(differing, d), max(gap, g)
        n = len(results)
        short = sum(max(0, n - self.calls[key])
                    for key in ("walk", "sweeps", "nnls"))
        self.info.update(device_calls=self.calls,
                         rows=sum(len(r) for r in ref))
        return {"rows_differing": (differing, LIMITS["rows_differing"]),
                "value_gap": (gap, LIMITS["value_gap"]),
                "device_calls_short": (short, LIMITS["device_calls_short"]),
                "host_sweeps": (self.calls["host_sweeps"],
                                LIMITS["host_sweeps"])}

    def reference(self, dtype=np.float64) -> list:
        """The reference's rows for every target, as (text, values). A
        sequence is run once under the name of its first target; its
        other targets take those rows with their own name."""
        c = self.config
        table = catalog_ref.HostTable(self.keys, self.counts, c["k"],
                                       c["canonical"], c["table_name"])
        first: dict[str, tuple[str, list]] = {}
        out = []
        for seq, name in self.sequences:
            if seq not in first:
                rows = catalog_ref.catalog_rows([(seq, name)], table,
                                                self.params(), dtype)[0]
                first[seq] = (name, [row_record(r) for r in rows])
            own, recs = first[seq]
            out.append([(_renamed(text, own, name), vals)
                        for text, vals in recs])
        return out

    def close(self) -> None:
        pass


def row_record(row) -> tuple[str, tuple]:
    """A row as find_mutation prints it, and its unrounded values."""
    return str(row), (row.rVAF, row.expression, row.ref_expression)


def _renamed(text: str, old: str, new: str) -> str:
    fields = text.split("\t")
    if fields[1] == old:
        fields[1] = new
    return "\t".join(fields)


def compare_rows(got, want) -> tuple[int, float]:
    """(rows whose text differs or that one side lacks, the widest gap of
    the values of rows present on both sides), of two lists of targets'
    row records (``row_record``)."""
    differing, gap = 0, 0.0
    for recs, ref in zip(got, want):
        differing += abs(len(recs) - len(ref))
        for (text, vals), (rtext, rvals) in zip(recs, ref):
            differing += text != rtext
            for a, b in zip(vals, rvals):
                gap = max(gap, value_gap(float(a), float(b)))
    differing += sum(len(r) for r in want[len(got):])
    return differing, gap


def value_gap(a: float, b: float) -> float:
    if math.isnan(a) or math.isnan(b):
        return 0.0 if math.isnan(a) and math.isnan(b) else 1.0
    return abs(a - b) / max(abs(b), 1.0)
