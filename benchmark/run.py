#!/usr/bin/env python3
"""Run one cell of the km_tpu_torch benchmark once, from the root of a
checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration and its traffic mix are found by name from
BENCHMARK.json (benchmark/README.md). Set-up makes the cell's inputs
from the seed and warms up its shapes; then calls run back to back for
``--seconds`` (the last one started runs to its end); then the outputs
of the window are compared with the plain reference. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics; with ``--trace
1`` its per-layer metrics, read from a torch.profiler trace of the
window), ``device``, ``breakdown`` (traced runs) and, last, ``compared``:
each number compared with its limit, which also close standard error.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), without the program, or if a module of JAX or
of the JAX package (km_tpu) was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

from kmbench import imports, spec as specmod, window  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(code: int, msg: str) -> int:
    sys.stderr.write("benchmark: %s\n" % msg)
    return code


def run_cell(spec, cell: dict, seed: int, seconds: float, traced: bool,
             device) -> dict:
    """Set-up, the window and the comparison of one run; returns the
    result's fields and the observations the metrics read."""
    import torch

    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    driver = specmod.load_driver(traffic["driver"]).Driver(
        config, traffic, seed, device)
    on_card = device.type == "cuda"
    try:
        driver.setup()
        sync = (lambda: torch.cuda.synchronize(device)) if on_card \
            else (lambda: None)
        sync()
        obs = {"kind": driver.kind, "setup_s": time.perf_counter() - T_START}
        setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        driver.begin_window()
        if traced:
            calls, results, failed, layer = traced_window(
                driver, seconds, sync, device,
                traffic.get("trace_seconds", seconds))
        else:
            calls, results, failed = window.closed_loop(
                driver.call, seconds, sync)
        obs.update(driver.end_window())
        obs["calls"] = calls
        window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        obs["peak_window_bytes"] = window_peak
        if traced:
            obs.update(layer)  # the per-layer metrics read the traced part
        compared = driver.check(results)
    finally:
        driver.close()
    return dict(obs=obs, compared=compared, failed=failed,
                attempted=len(calls) + failed, info=driver.info,
                memory_peak=max(setup_peak, window_peak))


def traced_window(driver, seconds, sync, device, trace_seconds):
    """The window with the first ``trace_seconds`` of it traced: the
    profiler, the driver's wrappers and the host spans run until the
    first call that ends that long after the window began. Returns the
    window's calls, results and failures, and the observations of the
    traced part, which the per-layer metrics read."""
    from kmbench.trace import Tracer

    tracer = Tracer(device)
    stack = contextlib.ExitStack()
    stack.enter_context(driver.traced(tracer))
    layer: dict = {}

    def end_trace(calls):
        events = tracer.stop()
        stack.close()
        layer.update(driver.observe())
        layer["calls"] = calls
        if calls:
            layer["trace"] = trace_obs(driver, tracer, events, calls, device)

    tracer.start()
    try:
        calls, results, failed = window.closed_loop(
            driver.call, seconds, sync, tracer, trace_seconds, end_trace)
    finally:
        stack.close()
    return calls, results, failed, layer


def trace_obs(driver, tracer, events, calls, device) -> dict:
    from kmbench import roofline, trace

    import torch

    out = trace.reduce(events, tracer.spans, (calls[0][0], calls[-1][1]))
    if hasattr(driver, "kernel_bytes"):
        out["kernel_bytes"] = driver.kernel_bytes()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else None
    out["hbm_bytes_per_s"] = roofline.HBM_BYTES_PER_S.get(name)
    return out


def breakdown(tr: dict) -> dict:
    from kmbench import roofline

    bw = tr.get("hbm_bytes_per_s")
    kb = tr.get("kernel_bytes", {})
    group_s: dict[str, float] = {}
    for name, (sec, _n) in tr["kernels"].items():
        g = roofline.group_of(name)
        if g:
            group_s[g] = group_s.get(g, 0.0) + sec
    ops = []
    for name, (sec, n) in sorted(tr["kernels"].items(),
                                 key=lambda kv: -kv[1][0])[:10]:
        g = roofline.group_of(name)
        label = "%s x%d" % (name, n)
        if g and bw and kb.get(g, [0])[0] and group_s.get(g):
            label += " [%s: %.1f%% of its bytes bound]" % (
                g, 100 * kb[g][0] / bw / group_s[g])
        ops.append([label, sec])
    gaps = [["idle during %s (%d gaps, longest %.6f s)" % (lab, n, longest),
             sec] for lab, (sec, n, longest) in
            sorted(tr["idle"].items(), key=lambda kv: -kv[1][0])[:10]]
    return {"device_ops": ops, "idle_gaps": gaps}


def main(argv=None) -> int:
    args = parse(argv)
    path = os.path.join(ROOT, "BENCHMARK.json")
    spec = specmod.Spec(path)
    try:
        cell = spec.workload(args.workload)
    except KeyError as exc:
        return fail(2, str(exc))
    import torch

    if not torch.cuda.is_available():
        return fail(3, "no CUDA card")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(3, "the cell asks for %d cards; %d present"
                    % (cell["chips"], torch.cuda.device_count()))
    try:
        import km_tpu_torch  # noqa: F401
    except ImportError as exc:
        return fail(4, "the program is missing: %s" % exc)
    device = torch.device("cuda", 0)
    out = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                   device)
    return report(spec, cell, out, bool(args.trace), device)


def report(spec, cell: dict, out: dict, traced: bool, device) -> int:
    import torch

    obs = out["obs"]
    metrics = {}
    for m in spec.metrics(cell["name"], traced):
        value = spec.reader(m["name"])(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    bad = imports.forbidden_loaded()
    if bad:
        return fail(5, "modules of JAX or of the JAX package were loaded: %s"
                    % bad)
    compared = {name: {"value": v, "limit": lim}
                for name, (v, lim) in out["compared"].items()}
    correct = out["failed"] == 0 and bool(obs["calls"]) and all(
        c["value"] <= c["limit"] for c in compared.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": out["memory_peak"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if traced and "trace" in obs:
        dev.update(busy_s=obs["trace"]["busy_s"],
                   window_s=obs["trace"]["window_s"])
        result["breakdown"] = breakdown(obs["trace"])
    result["compared"] = compared
    secs = sorted((e - s) / 1e9 for s, e, _ in obs["calls"])
    out["info"]["call_s"] = ([round(x, 3) for x in secs] if len(secs) <= 20
                             else [round(secs[int(q * (len(secs) - 1))], 4)
                                   for q in (0, 0.25, 0.5, 0.75, 0.95, 1)])
    sys.stderr.write("info: %s\n" % json.dumps(out["info"], default=str))
    for name, c in compared.items():
        sys.stderr.write("compared %s: %r (limit %r)\n"
                         % (name, c["value"], c["limit"]))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
