"""CUDA-graph replay of the device loops: when to warm up, capture and
replay, decided here for the walk, the sweeps and NNLS.

The walk's rounds, the sweeps' iterations and the NNLS steps are loops
of a few dozen small torch ops each, over tensors of fixed shape, whose
state is a handful of tensors. Launched one by one from Python, each op
costs the host ~20 us and the card a few; captured once into a CUDA
graph, a block of iterations replays with one launch. ``Replay`` runs
one block per call: on a card the first call runs it eagerly on a side
stream (real work, and the warm-up a capture needs), the second captures
it with its outputs copied back into the state tensors it read and
replays it, and every later call replays it, so that each replay
continues where the last one stopped. The graph lives as long as the
``Replay``. CPU tensors always run eagerly.
"""

from __future__ import annotations

import torch

from . import profiling


def _warm_up(block) -> None:
    """Run ``block()`` once on a side stream, ordered with the current
    stream on both sides: the span ``graph.warm_up``."""
    with profiling.phase("graph.warm_up"):
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            block()
        main.wait_stream(side)


def _capture(holder, names, block) -> "torch.cuda.CUDAGraph":
    """Capture ``block()``, which replaces the tensors named ``names`` on
    ``holder`` (and may update others in place), into a graph that
    writes its results back into the tensors it started from. Returns
    the graph; ``holder`` keeps those tensors. The block does not run
    until the graph is replayed. The span ``graph.capture``."""
    with profiling.phase("graph.capture"):
        static = {name: getattr(holder, name) for name in names}
        graph = torch.cuda.CUDAGraph()
        # capture_begin/end on a side stream, as torch.cuda.graph does,
        # but without its gc.collect() and empty_cache() (milliseconds
        # each, once per capture, with the catalog's host objects alive)
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                block()
                for name in names:
                    static[name].copy_(getattr(holder, name))
            finally:
                graph.capture_end()
        main.wait_stream(side)
        for name, tensor in static.items():
            setattr(holder, name, tensor)
        return graph


class Replay:
    """Each call does one block of a device loop: ``block()``, which
    replaces the state tensors named ``names`` on ``holder``. The
    device is that of the first of them: on CPU tensors every call runs
    ``block()``; on a card the first call is the warm-up, the second the
    capture and one replay, every later call a replay."""

    def __init__(self, holder, names, block):
        self.holder, self.names, self.block = holder, names, block
        self.on_card = getattr(holder, names[0]).is_cuda
        self.warm = False
        self.graph = None

    def __call__(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        elif not self.on_card:
            self.block()
        elif not self.warm:
            _warm_up(self.block)
            self.warm = True
        else:
            self.graph = _capture(self.holder, self.names, self.block)
            # a holder that keeps its Replay (NNLS) would otherwise keep
            # the graph's memory pool alive until a cyclic collection
            self.holder = self.block = None
            self.graph.replay()
