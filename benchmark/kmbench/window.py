"""The measured window: one client, calls back to back."""

from __future__ import annotations

import contextlib
import sys
import time
import traceback


def closed_loop(call, seconds: float, sync, tracer=None,
                trace_seconds: float | None = None, end_trace=None):
    """Call ``call()`` back to back until ``seconds`` have passed since
    the first call began; the last call started runs to its end. Each
    call returns (result, work). Returns (spans [(start ns, end ns,
    work)], results, failed): a call that raises is one failure, its
    traceback goes to stderr, and no further call starts.

    With a ``tracer``, ``end_trace(spans)`` is called once, after the
    first call that ends ``trace_seconds`` or more after the first call
    began, or at the end: the traced part of the window."""
    spans, results, failed = [], [], 0
    deadline = trace_end = None
    while True:
        t0 = time.perf_counter_ns()
        if deadline is None:
            deadline = t0 + int(seconds * 1e9)
            trace_end = t0 + int((trace_seconds or seconds) * 1e9)
        ctx = tracer.span("call") if tracer else contextlib.nullcontext()
        try:
            with ctx:
                out, work = call()
                sync()
        except Exception:  # a failed call is counted, not fatal
            traceback.print_exc(file=sys.stderr)
            failed += 1
            break
        t1 = time.perf_counter_ns()
        spans.append((t0, t1, work))
        results.append(out)
        if end_trace and t1 >= trace_end:
            end_trace(list(spans))
            end_trace = None
        if t1 >= deadline:
            break
    if end_trace:
        end_trace(list(spans))
    return spans, results, failed
