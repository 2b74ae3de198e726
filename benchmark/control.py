#!/usr/bin/env python3
"""The controls of ``correct``: the plain reference put in the program's
place with one step down, at a cell's own size, on the chip.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13

For a count cell the step is a broken guarantee (the configuration
states no precision): the read stream cut into chunks with no k-1
overlap, so windows across a cut are lost (reference/count_ref.py,
``count_reads_control``). For a catalog cell it is the fit in float32
where the configuration states float64 (the ``dtype`` of
reference/catalog_ref.py's fit). Prints one JSON line per seed with the numbers the
cell compares and their limits; a control that comes out within every
limit would show that ``correct`` cannot catch the step. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from kmbench import reads as gen, spec as specmod  # noqa: E402
from kmbench.drivers import catalog, count  # noqa: E402
from reference import count_ref  # noqa: E402


def count_control(config: dict, traffic: dict, seed: int, device) -> dict:
    p = dict(traffic["reads"], bases=config["read_bases"])
    reads = gen.make_reads(p, seed, device)
    k, canon, lo = config["k"], config["canonical"], config["min_count"]
    rk, rc, total, _ = count_ref.count_reads(reads, k, canon, lo)
    ck, cc, ctotal = count_ref.count_reads_control(
        reads, k, canon, lo, config["chunk"])
    return {"table_mismatches": count_ref.table_mismatches(ck, cc, rk, rc),
            "windows_gap": abs(total - ctotal)}


def catalog_control(config: dict, traffic: dict, seed: int, device) -> dict:
    d = catalog.Driver(config, traffic, seed, device)
    fk, fc, _k, _c = catalog.fixture_union(config["fixtures"])
    d.keys, d.counts = catalog.big_table(
        fk, fc, config["extra_records"], config["extra_max_count"], seed,
        device, config["k"], config["canonical"])
    d.sequences = catalog.catalog_sequences(traffic["targets"])
    ref = d.reference(np.float64)
    low = d.reference(np.float32)
    differing, gap = catalog.compare_rows(low, ref)
    return {"rows_differing": differing, "value_gap": gap}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = specmod.Spec(os.path.join(os.path.dirname(HERE),
                                     "BENCHMARK.json"))
    cell = spec.workload(args.workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    device = torch.device(args.device)
    fn = {"count": count_control, "catalog": catalog_control}[
        traffic["driver"]]
    limits = {"count": count.LIMITS, "catalog": catalog.LIMITS}[
        traffic["driver"]]
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = fn(config, traffic, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": numbers,
                          "limits": {n: limits[n] for n in numbers},
                          "fails": any(v > limits[n]
                                       for n, v in numbers.items())}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
