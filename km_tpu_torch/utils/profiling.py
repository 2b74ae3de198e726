"""Per-phase timers and an optional device profiler trace.

The reference's only instrumentation is the ``#Elapsed time:`` footer
(reference: km/tools/find_mutation.py:18,60). Here every pipeline phase
(table load, walk/discovery, path enumeration, quantification) and the
host's waits and stalls inside them are spans: ``phase(name)`` adds its
wall time, on ``time.perf_counter_ns``, to a table of seconds by name
that ``report()`` returns and logs at INFO level, as
km_tpu/utils/profiling.py does; the table is this module's own. Call
sites look ``phase`` up on this module when they run, so a caller that
replaces it with a wrapper (a tracer's) sees every span. A
generation-2 collection of the garbage collector is the span ``gc``.

``device_trace`` is a torch.profiler trace of CPU and, when present,
CUDA activity, where km_tpu traces with jax.profiler; while it runs,
every phase is also a ``record_function`` range of the trace.
"""

from __future__ import annotations

import contextlib
import gc
import logging as log
import os
from collections import OrderedDict
from time import perf_counter_ns

_NS: dict[str, int] = {}  # phase -> nanoseconds, in first-seen order
_COUNTS: dict[str, int] = {}
# the collector's own: the start of the collection under way, and the
# nanoseconds and collections not yet added to the tables
_GC = [0, 0, 0]
_in_device_trace = False


def reset() -> None:
    _NS.clear()
    _COUNTS.clear()
    _GC[1] = _GC[2] = 0


class phase:
    """Accumulate wall time under ``name`` (re-entrant across targets)."""

    __slots__ = ("name", "t0", "range")

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def __enter__(self):
        if _in_device_trace:
            import torch

            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        dt = perf_counter_ns() - self.t0
        name = self.name
        _NS[name] = _NS.get(name, 0) + dt
        _COUNTS[name] = _COUNTS.get(name, 0) + 1
        if self.range is not None:
            self.range.__exit__(*exc)


def _on_gc(stage: str, info: dict) -> None:
    """Times generation-2 collections. A collection can start inside
    any allocation, the phase tables' own updates included, so it only
    notes its time here; ``_flush_gc`` adds it to the tables."""
    if info["generation"] == 2:
        if stage == "start":
            _GC[0] = perf_counter_ns()
        else:
            _GC[1] += perf_counter_ns() - _GC[0]
            _GC[2] += 1


def _flush_gc() -> None:
    if _GC[2]:
        _NS["gc"] = _NS.get("gc", 0) + _GC[1]
        _COUNTS["gc"] = _COUNTS.get("gc", 0) + _GC[2]
        _GC[1] = _GC[2] = 0


gc.callbacks.append(_on_gc)


def report() -> "OrderedDict[str, float]":
    """Accumulated (phase -> seconds); logs a summary line per phase."""
    _flush_gc()
    for name, ns in _NS.items():
        log.info("phase total %s: %.4f s over %d call(s)",
                 name, ns / 1e9, _COUNTS[name])
    return OrderedDict((name, ns / 1e9) for name, ns in _NS.items())


class collect:
    """Adds to ``into`` (name -> seconds) the seconds of every span that
    closes while it is open, whatever happens inside."""

    def __init__(self, into: dict):
        self.into = into

    def __enter__(self):
        _flush_gc()
        self.before = dict(_NS)
        return self

    def __exit__(self, *exc) -> None:
        _flush_gc()
        for name, ns in _NS.items():
            dt = ns - self.before.get(name, 0)
            if dt > 0:
                self.into[name] = self.into.get(name, 0.0) + dt / 1e9


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """torch.profiler trace written as a Chrome trace into ``trace_dir``
    (no-op when None/empty); phases inside it are ranges of the trace."""
    global _in_device_trace
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        _in_device_trace = True
        try:
            yield
        finally:
            _in_device_trace = False
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
