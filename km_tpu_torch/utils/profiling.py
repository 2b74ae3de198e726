"""Per-phase timers and an optional device profiler trace.

The reference's only instrumentation is the ``#Elapsed time:`` footer
(reference: km/tools/find_mutation.py:18,60). Here every pipeline phase
(table load, walk/discovery, path enumeration, quantification) is timed
and reported through ``logging`` at INFO level, as
km_tpu/utils/profiling.py does; the table of phases is this module's
own. ``device_trace`` is a torch.profiler trace of CPU and, when
present, CUDA activity, where km_tpu traces with jax.profiler.
"""

from __future__ import annotations

import contextlib
import logging as log
import os
import time
from collections import OrderedDict

_PHASES: "OrderedDict[str, float]" = OrderedDict()
_COUNTS: dict = {}


def reset() -> None:
    _PHASES.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def phase(name: str):
    """Accumulate wall time under ``name`` (re-entrant across targets)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _PHASES[name] = _PHASES.get(name, 0.0) + dt
        _COUNTS[name] = _COUNTS.get(name, 0) + 1
        log.info("phase %s: %.4f s", name, dt)


def report() -> "OrderedDict[str, float]":
    """Accumulated (phase -> seconds); logs a summary line per phase."""
    for name, total in _PHASES.items():
        log.info("phase total %s: %.4f s over %d call(s)",
                 name, total, _COUNTS[name])
    return OrderedDict(_PHASES)


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """torch.profiler trace written as a Chrome trace into ``trace_dir``
    (no-op when None/empty)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
