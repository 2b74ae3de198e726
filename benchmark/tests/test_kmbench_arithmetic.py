"""The yardstick's arithmetic: byte counts, rates over a window's span,
the device's idle share and the phases' shares, on synthetic inputs."""

import importlib.util
import os

import numpy as np
import pytest

import small
from kmbench import roofline, trace
from kmbench.drivers.catalog import value_gap


def reader(name):
    path = os.path.join(small.BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_byte_counts_of_the_kernel_tables():
    n = 1 << 24
    # PERF.md's bounds at 3.35 TB/s: K1 0.0501 ms, K2 0.1002 ms
    assert roofline.pack_bytes(n) / 3.35e12 * 1e3 == pytest.approx(0.0501,
                                                                  abs=1e-4)
    assert roofline.sort_runs_bytes(n) / 3.35e12 * 1e3 == pytest.approx(
        0.1002, abs=1e-4)
    assert roofline.chunk_runs_bytes(10, 3) == 12 * 10 + 16 * 3
    assert roofline.merge_accum_bytes(7, 5) == 16 * 12


def test_kernel_names():
    assert roofline.kernel_name(
        "void sort_runs_kernel<14, true>(long long const*, long long, int)"
    ) == "sort_runs_kernel"
    assert roofline.kernel_name(
        "(anonymous namespace)::bucket_kernel(long const*)") == "bucket_kernel"
    assert roofline.group_of("merge_cuts_kernel") == "M2 merge_accum"
    assert roofline.group_of("elementwise_kernel") is None


def calls(times, work=1):
    """Back to back calls of the given seconds, in ns spans."""
    out, t = [], 10 ** 9
    for s in times:
        out.append((t, t + int(s * 1e9), work))
        t += int(s * 1e9)
    return out


def test_rates_over_the_span_of_the_window():
    obs = {"kind": "count", "calls": calls([2.0, 3.0, 5.0], work=100)}
    assert reader("count_kmers_per_s")(obs) == pytest.approx(30.0)
    assert reader("catalog_targets_per_s")(obs) is None
    obs["kind"] = "catalog"
    assert reader("catalog_targets_per_s")(obs) == pytest.approx(30.0)


def test_count_layer_shares():
    obs = {"kind": "count", "calls": calls([4.0, 4.0]),
           "count_stats": [{"input_s": 1.0, "retries": 2},
                           {"input_s": 3.0, "retries": 2}],
           "trace": {"span_s": {"call": 8.0, "input": 6.0}}}
    # the spans, not the program's input_s, which leaves out the
    # attempts a retry throws away
    assert reader("count.input_pct")(obs) == pytest.approx(75.0)
    assert reader("count.retries")(obs) == 2
    del obs["count_stats"][0]["retries"]
    assert reader("count.retries")(obs) is None


def test_phase_shares():
    obs = {"kind": "catalog", "calls": calls([1.0, 1.0]),
           "phases": {"walk": 0.5, "graph_host": 0.6, "rows": 0.2,
                      "sweeps": 0.1, "nnls": 0.3}}
    assert reader("catalog.walk_pct")(obs) == pytest.approx(25.0)
    assert reader("catalog.graph_host_pct")(obs) == pytest.approx(40.0)
    assert reader("catalog.sweeps_nnls_pct")(obs) == pytest.approx(20.0)


def test_idle_share_and_gaps_by_host_span():
    ms = 10 ** 6
    names = ["void pack_windows_kernel(int)",
             "Memcpy HtoD (Pageable -> Device)", "bucket_kernel"]
    events = (names, np.array([0, 1, 2, 2]),
              np.array([0, 1, 6, 9]) * ms,
              np.array([2, 3, 7, 12]) * ms)  # the last past the window
    spans = [("call", 0, 10 * ms), ("input", 3 * ms, 6 * ms)]
    red = trace.reduce(events, spans, (0, 10 * ms))
    assert red["window_s"] == pytest.approx(0.010)
    assert red["busy_s"] == pytest.approx(0.005)  # 0-3, 6-7, 9-10
    assert red["kernels"]["bucket_kernel"] == [pytest.approx(0.002), 2]
    assert red["idle"]["input"][:2] == [pytest.approx(0.003), 1]
    assert red["idle"]["call"][:2] == [pytest.approx(0.002), 1]
    assert red["span_s"] == {"call": pytest.approx(0.010),
                             "input": pytest.approx(0.003)}
    obs = {"kind": "count", "trace": red}
    assert reader("device.idle_pct.count")(obs) == pytest.approx(50.0)
    assert reader("device.idle_pct.catalog")(obs) is None


def test_roofline_share_of_the_count_kernels():
    tr = {"events": 10, "kernels": {"pack_windows_kernel": [0.002, 1],
                      "elementwise_kernel": [5.0, 9]},
          "kernel_bytes": {"K1 pack": [3.35e9, 1]},
          "hbm_bytes_per_s": 3.35e12}
    assert reader("kernels.count_roofline_pct")({"trace": tr}) == \
        pytest.approx(50.0)
    tr["hbm_bytes_per_s"] = None  # a card with no peak in the table
    assert reader("kernels.count_roofline_pct")({"trace": tr}) is None


def test_value_gap():
    assert value_gap(1.0, 1.0) == 0
    assert value_gap(0.5, 0.25) == pytest.approx(0.25)
    assert value_gap(300.0, 200.0) == pytest.approx(0.5)
    assert value_gap(float("nan"), float("nan")) == 0
    assert value_gap(float("nan"), 0.5) == 1.0
