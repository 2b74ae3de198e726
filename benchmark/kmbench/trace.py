"""The traced run: device activity from torch.profiler, host spans from
the harness, and what a metric reads from the two.

Only device activity is traced (kernels, copies, fills), so the
profiler adds no event per host operation. Host spans are the harness's
own: each call, and where a driver installs them, the program's phases
and its input generator. Device time is put on the host's clock by a
marker: with the card idle, the harness notes the host time and
launches one fill; the first device event of the trace is that fill.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from .roofline import kernel_name

MAX_SPAN_NS = 120 * 10 ** 9  # no host span of a run lasts longer


class Tracer:
    def __init__(self, device):
        self.device = device
        self.spans: list[tuple[str, int, int]] = []
        self.prof = None
        self.offset_ns = 0
        self.host0_ns = 0

    @contextlib.contextmanager
    def span(self, label: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((label, t0, time.perf_counter_ns()))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        """Device activity only; on a CPU (the tests) the profiler runs
        and sees no device event."""
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        self.prof = profile(activities=[
            ProfilerActivity.CUDA if self.device.type == "cuda"
            else ProfilerActivity.CPU])
        self.prof.__enter__()
        self._sync()
        self.host0_ns = time.perf_counter_ns()
        torch.ones(1, device=self.device)  # the marker
        self._sync()

    def stop(self):
        """Device events as (names, name index, start, end): the start
        and end in host perf_counter ns, the marker left out."""
        self._sync()
        t0 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        t1 = time.perf_counter()
        names, idx, start, end = _device_events(self.prof)
        sys.stderr.write("trace: %d device events; profiler stop %.1f s, "
                         "events read %.1f s\n" % (len(start), t1 - t0,
                                                    time.perf_counter() - t1))
        if not len(start):
            sys.stderr.write("trace: the profiler saw no device event\n")
            return names, idx, start, end
        order = np.argsort(start, kind="stable")
        idx, start, end = idx[order], start[order], end[order]
        offset = start[0] - self.host0_ns
        return names, idx[1:], start[1:] - offset, end[1:] - offset


def _device_events(prof):
    """(distinct names, name index, start ns, end ns) of every device
    event of the trace."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    names: dict[str, int] = {}
    idx, start, end = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        n = e.name()
        i = names.get(n)
        if i is None:
            i = names[n] = len(names)
        s = e.start_ns()
        idx.append(i)
        start.append(s)
        end.append(s + e.duration_ns())
    return (list(names), np.asarray(idx, np.int64),
            np.asarray(start, np.int64), np.asarray(end, np.int64))


def union(start: np.ndarray, end: np.ndarray):
    """The union of [start, end) intervals sorted by start, as arrays of
    merged starts and ends."""
    if not len(start):
        return start, end
    reach = np.maximum.accumulate(end)
    new = np.empty(len(start), bool)
    new[0] = True
    new[1:] = start[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(start) - 1)
    return start[first], reach[last]


def reduce(events, spans, window: tuple[int, int]) -> dict:
    """What the metrics read: the device's busy seconds within the
    window, the window's seconds, device seconds and launches by kernel,
    the host spans' seconds within the window by label, and the idle
    gaps labelled by the innermost host span at their middle ("between
    calls" where none)."""
    names, idx, start, end = events
    w0, w1 = window
    keep = (end > w0) & (start < w1)
    idx, start, end = idx[keep], np.maximum(start[keep], w0), \
        np.minimum(end[keep], w1)
    bs, be = union(start, end)
    by_kernel: dict[str, list] = {}
    sec = np.bincount(idx, weights=(end - start) / 1e9,
                      minlength=len(names))
    n = np.bincount(idx, minlength=len(names))
    for i, raw in enumerate(names):
        if n[i]:
            rec = by_kernel.setdefault(kernel_name(raw), [0.0, 0])
            rec[0] += float(sec[i])
            rec[1] += int(n[i])
    gs = np.append(w0, be)
    ge = np.append(bs, w1)
    open_ = ge > gs
    gs, ge = gs[open_], ge[open_]
    labels = label_points((gs + ge) // 2, spans)
    labelled: dict[str, list] = {}
    for lab, s0, s1 in zip(labels, gs.tolist(), ge.tolist()):
        rec = labelled.setdefault(lab, [0.0, 0, 0.0])
        rec[0] += (s1 - s0) / 1e9
        rec[1] += 1
        rec[2] = max(rec[2], (s1 - s0) / 1e9)
    span_s: dict[str, float] = {}
    for lab, s0, s1 in spans:
        s0, s1 = max(s0, w0), min(s1, w1)
        if s1 > s0:
            span_s[lab] = span_s.get(lab, 0.0) + (s1 - s0) / 1e9
    return dict(busy_s=float((be - bs).sum()) / 1e9,
                window_s=(w1 - w0) / 1e9, kernels=by_kernel,
                idle=labelled, span_s=span_s, events=int(len(start)))


def label_points(points: np.ndarray, spans) -> list[str]:
    """The label of the innermost span (the latest-starting one) that
    covers each point, or "between calls"."""
    spans = sorted(spans, key=lambda sp: sp[1])
    starts = np.array([sp[1] for sp in spans], np.int64)
    ends = np.array([sp[2] for sp in spans], np.int64)
    out = []
    for mid, i in zip(points.tolist(),
                      (np.searchsorted(starts, points, "right") - 1).tolist()):
        label = "between calls"
        while i >= 0 and mid - starts[i] < MAX_SPAN_NS:
            if ends[i] >= mid:
                label = spans[i][0]
                break
            i -= 1
        out.append(label)
    return out
