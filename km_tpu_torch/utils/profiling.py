"""Per-phase timers (km_tpu's) and a device trace on torch.profiler.

The phase timers are km_tpu.utils.profiling's own: they import no JAX.
``device_trace`` replaces km_tpu's jax.profiler trace with a
torch.profiler trace of CPU and, when present, CUDA activity.
"""

from __future__ import annotations

import contextlib
import logging as log
import os

from km_tpu.utils.profiling import phase, report, reset

__all__ = ["device_trace", "phase", "report", "reset"]


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
