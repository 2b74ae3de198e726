"""BENCHMARK.json keeps to the form a benchmark must have: its keys,
names and units, its files, and what every cell reports."""

import json
import os
import re

import small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def load():
    with open(os.path.join(small.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_and_entry_keys():
    b = load()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_names_units_and_files():
    b = load()
    names = [x["name"] for group in ("configs", "workloads", "end_to_end",
                                     "per_layer") for x in b[group]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(PATH.match(p) for p in b["paths"])
    for p in b["paths"]:
        for d, _, files in os.walk(os.path.join(small.ROOT, p)):
            if "__pycache__" in d:
                continue
            for f in files:
                rel = os.path.relpath(os.path.join(d, f), small.ROOT)
                assert all(NAME.match(part) for part in rel.split("/")), rel
    for c in b["configs"]:
        assert c["file"].startswith(b["paths"][0] + "/")
        with open(os.path.join(small.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_cell_reports_what_it_must():
    b = load()
    spec = small.SmallSpec()
    e2e = {m["name"] for m in b["end_to_end"]}
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(small.BENCH, "traffic",
                                           w["traffic"] + ".json"))
        assert w["config"] in {c["name"] for c in b["configs"]}
        mine = {m["name"] for m in spec.metrics(w["name"], False)}
        assert "setup_s" in mine and len(mine) >= 2
        layers = spec.metrics(w["name"], True)
        assert layers
        for m in layers:
            assert m["moves"] in mine
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(small.BENCH, "metrics",
                                           m["name"] + ".py"))
        assert m.get("moves", "setup_s") in e2e
    for c in b["configs"]:
        assert any(w["config"] == c["name"] for w in b["workloads"])


def test_run_seconds_fit_a_check_of_24_cells():
    rs = load()["run_seconds"]
    assert 1 <= rs <= 51 and isinstance(rs, int)
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
