"""km_tpu_torch's batched Dijkstra sweeps (on CPU tensors) against
km_tpu's ``batched_sweeps`` (JAX on the CPU) and the host scan-min spec
(``OverlapGraph._sweep``): the predecessor trees are equal
(``np.array_equal``), ties included."""

import logging

import numpy as np
import pytest

import torch

from km_tpu.models.pathfinder import OverlapGraph
from km_tpu.ops.pathgraph import batched_sweeps as jax_sweeps

from km_tpu_torch import convert
from km_tpu_torch.models.finder import VariantFinder as PortFinder
from km_tpu_torch.models.pathfinder import OverlapGraph as PortGraph
from km_tpu_torch.ops import pathgraph

from test_pathgraph import FIXTURES, _finder, _host_trees, _random_graph

# the device path on CPU tensors is thousands of small ops: one intra-op
# thread each, so that parallel test workers do not oversubscribe the
# cores
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _port_graph(g):
    """The port's OverlapGraph with km_tpu graph ``g``'s edge writes,
    frozen by the port's own code."""
    p = PortGraph.__new__(PortGraph)
    p.n_real, p.n, p.k = g.n_real, g.n, g.k
    p.first_node, p.last_node = g.first_node, g.last_node
    p._src = [np.array(a) for a in g._src]
    p._dst = [np.array(a) for a in g._dst]
    p._w = [np.array(a) for a in g._w]
    p.freeze()
    for name in ("succ_ptr", "succ_ids", "succ_w", "pred_ptr", "pred_ids",
                 "pred_w"):
        assert np.array_equal(getattr(p, name), getattr(g, name)), name
    return p


def _check(graphs):
    got = pathgraph.batched_sweeps([_port_graph(g) for g in graphs], CPU)
    for g, (gb, ga), (jb, ja) in zip(graphs, got, jax_sweeps(graphs)):
        hb, ha = _host_trees(g)
        assert gb.dtype == np.int32 and ga.dtype == np.int32
        assert np.array_equal(gb, hb), (g.n, np.flatnonzero(gb != hb))
        assert np.array_equal(ga, ha), (g.n, np.flatnonzero(ga != ha))
        assert np.array_equal(gb, jb)
        assert np.array_equal(ga, ja)


def test_fixture_trees_equal():
    graphs = []
    for jf, fa in FIXTURES:
        g = _finder(jf, fa).build_graph()
        g.freeze()
        graphs.append(g)
    _check(graphs)


def test_fixture_alt_paths_equal():
    for jf, fa in FIXTURES:
        f_host = _finder(jf, fa)
        f_host.find_alt_paths()
        km = _finder(jf, fa)
        f_dev = PortFinder(convert.target_from_km_tpu(km.target),
                           convert.count_table_from_km_tpu(km.table))
        pathgraph.batched_alt_paths([f_dev], CPU)
        assert f_dev.alt_paths == f_host.alt_paths


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_graphs_with_ties(seed):
    """Random digraphs of mixed sizes in one batch, every weight 1 or
    0.01: many equal distances, so the lowest-index tie rule decides."""
    rng = np.random.default_rng(seed)
    _check([_random_graph(rng, int(rng.integers(3, 90)), [1.0, 0.01])
            for _ in range(12)])


def test_forced_ties_lowest_index_wins():
    """A diamond: the sink is reached at the same distance through
    nodes 0..3; its predecessor must be node 0, and the extraction order
    among the equal nodes the lowest index first."""
    g = OverlapGraph.__new__(OverlapGraph)
    g.n_real, g.n, g.first_node, g.last_node, g.k = 4, 6, 4, 5, 31
    g._src, g._dst, g._w = [], [], []
    for j in (3, 1, 2, 0):
        g.set_edge(g.first_node, j, 1.0)
        g.set_edge(j, g.last_node, 1.0)
    g.freeze()
    _check([g])
    before, after = pathgraph.batched_sweeps([_port_graph(g)], CPU)[0]
    assert before[g.last_node] == 0
    assert after[g.first_node] == 0


def test_mixed_widths_and_many_weights():
    """Graphs of different degree and more distinct weights than km_tpu's
    16-entry palette all take the device sweep."""
    rng = np.random.default_rng(11)
    many_w = [float(w) for w in np.linspace(0.01, 2.0, 24)]
    graphs = [_random_graph(rng, 30, [1.0, 0.01], max_extra_deg=2),
              _random_graph(rng, 30, [1.0, 0.01], max_extra_deg=12),
              _random_graph(rng, 40, many_w),
              _random_graph(rng, 500, [1.0, 0.01], max_extra_deg=2),
              _random_graph(rng, 700, [1.0, 0.01], max_extra_deg=2)]
    fallbacks = pathgraph.batched_sweeps.host_fallbacks
    _check(graphs)  # km_tpu takes its host sweep for graphs[2]
    assert pathgraph.batched_sweeps.host_fallbacks == fallbacks


def test_wide_graph_takes_the_counted_host_sweep():
    wide = OverlapGraph.__new__(OverlapGraph)
    wide.n_real = pathgraph.MAX_WIDTH + 10
    wide.n = wide.n_real + 2
    wide.first_node = wide.n_real
    wide.last_node = wide.n_real + 1
    wide.k = 31
    wide._src, wide._dst, wide._w = [], [], []
    for j in range(pathgraph.MAX_WIDTH + 5):
        wide.set_edge(wide.first_node, j, 1.0)
        wide.set_edge(j, wide.last_node, 1.0)
    wide.freeze()
    rng = np.random.default_rng(3)
    fallbacks = pathgraph.batched_sweeps.host_fallbacks
    _check([_random_graph(rng, 20, [1.0, 0.01]), wide])
    assert pathgraph.batched_sweeps.host_fallbacks == fallbacks + 1


def test_max_node_scale_graph_runs_on_device():
    """A graph at km's node ceiling (-n 10000) takes the device sweep,
    with no host fallback, and returns the host spec's trees."""
    rng = np.random.default_rng(13)
    g = _random_graph(rng, 10000, [1.0, 0.01], max_extra_deg=3)
    records = []

    class Catch(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    h = Catch()
    logging.getLogger().addHandler(h)
    calls = pathgraph.sweep_kernel.calls
    try:
        _check([g])
    finally:
        logging.getLogger().removeHandler(h)
    assert not any("host sweep" in m for m in records), records
    assert pathgraph.sweep_kernel.calls == calls + 1
