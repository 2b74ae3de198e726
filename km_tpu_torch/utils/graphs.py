"""CUDA-graph replay of the device loops.

The walk's rounds, the sweeps' iterations and the NNLS steps are loops
of a few dozen small torch ops each, over tensors of fixed shape, whose
state is a handful of tensors. Launched one by one from Python, each op
costs the host ~20 us and the card a few; captured once into a CUDA
graph, a block of iterations replays with one launch. A block is first
run eagerly on a side stream (real work, and the warm-up a capture
needs), then captured with its outputs copied back into the state
tensors it read, so that every replay continues where the last one
stopped.

CUDA tensors always replay; CPU tensors always run eagerly.
"""

from __future__ import annotations

import torch

from . import profiling


def warm_up(block) -> None:
    """Run ``block()`` once on a side stream, ordered with the current
    stream on both sides: the span ``graph.warm_up``."""
    with profiling.phase("graph.warm_up"):
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            block()
        main.wait_stream(side)


def capture(holder, names, block) -> "torch.cuda.CUDAGraph":
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
