"""The harness as a whole on the CPU, past its look for a card: a run of
each cell at a small size, the import check, and a cell, a traffic mix
and a metric added as files alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import small
from kmbench import imports

CELLS = ["count.fastq", "catalog.panel9", "count.resident",
         "catalog.batch400"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_small_run_is_correct_and_reports_its_metrics(cell):
    line, obs = small.run_small(cell)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "compared"
    assert all(c["value"] <= c["limit"] for c in line["compared"].values())
    want = {"count": "count_kmers_per_s", "catalog": "catalog_targets_per_s"}
    assert want[obs["kind"]] in line["metrics"]
    assert "setup_s" in line["metrics"]


@pytest.mark.parametrize("cell", ["count.fastq", "catalog.batch400"])
def test_a_traced_run_reports_no_device_metric_from_a_cpu(cell):
    line, obs = small.run_small(cell, traced=True)
    assert line["correct"] and obs["trace"]["events"] == 0
    assert not any(m.startswith(("device.", "kernels."))
                   for m in line["metrics"])
    want = {"count": "count.input_pct", "catalog": "catalog.walk_pct"}
    assert want[obs["kind"]] in line["metrics"]
    assert "setup_s" not in line["metrics"]


def test_the_same_seed_gives_the_same_count():
    _, a = small.run_small("count.resident")
    _, b = small.run_small("count.resident")
    assert a["calls"][0][2] == b["calls"][0][2]


def test_forbidden_modules_are_compared_by_whole_top_level_name():
    assert imports.forbidden_loaded(["km_tpu_torch", "km_tpu_torch.ops",
                                     "jaxtyping", "numpy"]) == []
    assert imports.forbidden_loaded(["km_tpu.ops.count", "jax.numpy",
                                     "flax"]) == ["flax", "jax", "km_tpu"]


def test_the_harness_loads_nothing_of_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; import run, control; "
            "from kmbench.drivers import count, catalog; "
            "import kmbench.trace; from reference import catalog_ref; "
            "import km_tpu_torch.models.batch, km_tpu_torch.tools.count; "
            "from kmbench import imports; print(imports.forbidden_loaded())"
            % (small.BENCH, small.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=small.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_the_program_a_run_prints_no_result(tmp_path):
    shutil.copy(os.path.join(small.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(small.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "count.fastq",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A later change adds a traffic file, a workload entry and a metric
    reader; the harness runs the new cell and reports the new metric."""
    bench = tmp_path / "benchmark"
    shutil.copytree(small.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(small.ROOT, "BENCHMARK.json")) as f:
        data = json.load(f)
    data["workloads"].append({
        "name": "catalog.panel3", "config": "leucegene_catalog",
        "traffic": "panel3", "chips": 1, "why": "three targets a call"})
    data["per_layer"].append({
        "name": "catalog.calls", "unit": "count", "better": "higher",
        "source": "host_clock", "layer": "models host graph",
        "moves": "catalog_targets_per_s", "workloads": ["catalog.panel3"]})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(data, f)
    with open(bench / "traffic" / "panel3.json", "w") as f:
        json.dump({"driver": "catalog", "why": "three targets",
                   "targets": 3}, f)
    with open(bench / "metrics" / "catalog.calls.py", "w") as f:
        f.write("def read(obs):\n    return len(obs['calls'])\n")

    spec = small.SmallSpec(str(tmp_path / "BENCHMARK.json"))
    spec.bench_dir = str(bench)
    assert spec.traffic("panel3")["targets"] == 3
    line, obs = small.run_small("catalog.panel3", traced=False, spec=spec)
    assert line["correct"] and obs["calls"]
    names = [m["name"] for m in spec.metrics("catalog.panel3", True)]
    assert "catalog.calls" in names and "count.retries" not in names
    assert spec.reader("catalog.calls")(obs) == len(obs["calls"])
