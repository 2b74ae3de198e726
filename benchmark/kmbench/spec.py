"""BENCHMARK.json, and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file
``configs`` gives, and a traffic mix, read from ``traffic/<name>.json``.
Every metric has a reader ``metrics/<name>.py`` with a function
``read(obs)`` that returns a number, or None where it finds nothing to
read. Adding a cell, a configuration, a traffic mix or a metric is
adding files and entries; no code here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Spec:
    def __init__(self, path: str):
        self.root = os.path.dirname(os.path.abspath(path))
        with open(path) as f:
            self.data = json.load(f)
        self.bench_dir = HERE

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError("no workload %r in BENCHMARK.json; there are %s"
                       % (name, [w["name"] for w in self.data["workloads"]]))

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError("no configuration %r" % name)

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.bench_dir, "traffic", name + ".json")) as f:
            return json.load(f)

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones
        untraced, the per-layer ones traced; each where its
        ``workloads`` names the cell or it has no ``workloads``."""
        group = self.data["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "kmbench_metric_" + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def load_driver(name: str):
    return importlib.import_module("kmbench.drivers." + name)
