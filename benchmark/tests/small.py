"""The benchmark's cells at a size a CPU test can hold, and what the
tests share. Importing this puts the harness and the repo on the path."""

from __future__ import annotations

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

from kmbench import spec as specmod  # noqa: E402

READS = {"read_len": 100, "transcriptome": 1 << 14, "sub_rate": 0.001,
         "npm1_coverage": 20, "npm1_flank": 100,
         "npm1_target": "NPM1_4ins_exons_10-11utr",
         "npm1_insert": [44, "TCTG"]}
CONFIGS = {"leucegene_count": {"read_bases": 1 << 18, "chunk": 1 << 16},
           "leucegene_catalog": {"extra_records": 20000}}
TRAFFIC = {"fastq": {"reads": READS, "warm_capacity": 1 << 16},
           "resident": {"reads": READS, "batch_reads": 700,
                        "capacity": 1 << 17, "warm_capacity": 1 << 17},
           "batch400": {"targets": 18}}
SEED = 2 ** 31 + 12345  # seeds may exceed what 32 signed bits hold


class SmallSpec(specmod.Spec):
    """BENCHMARK.json with each configuration and traffic mix cut to a
    size the CPU runs in seconds."""

    def __init__(self, path=os.path.join(ROOT, "BENCHMARK.json")):
        super().__init__(path)

    def config(self, name):
        c = super().config(name)
        c.update(CONFIGS.get(name, {}))
        return c

    def traffic(self, name):
        t = super().traffic(name)
        t.update(TRAFFIC.get(name, {}))
        return t


def run_small(cell: str, seed: int = SEED, seconds: float = 0.2,
              traced: bool = False, spec=None):
    """One run of ``cell`` on the CPU, past the harness's look for a
    card: (result line as a dict, the run's observations)."""
    import contextlib
    import io
    import json

    import torch

    import run

    spec = spec or SmallSpec()
    out = run.run_cell(spec, spec.workload(cell), seed, seconds, traced,
                       torch.device("cpu"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run.report(spec, spec.workload(cell), out, traced,
                   torch.device("cpu"))
    return json.loads(buf.getvalue().splitlines()[-1]), out["obs"]
