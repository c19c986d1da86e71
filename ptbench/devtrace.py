"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: device operations (kernels, copies, sets) with their intervals, host
operations with theirs, and the traced window.

The busy time is the length of the union of the device intervals
(``profile_render.py``'s arithmetic); the idle share is one minus busy
time over the window.  An idle gap is a stretch of the window in which no
device operation ran; it is labelled by the innermost host operation
running at its midpoint, CUDA runtime calls left out (a gap inside a
launch is charged to the operator that launched).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

WINDOW = "ptbench.window"  # the host span around the traced units
UNIT = "ptbench.unit"  # the host span around one frame or step


@dataclasses.dataclass
class Trace:
    device: List[Tuple[str, float, float]]  # (name, start us, end us)
    host: List[Tuple[str, float, float]]
    window: Tuple[float, float]  # us

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6


def union_us(spans) -> float:
    """Length of the union of the (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def merged(spans) -> List[Tuple[float, float]]:
    """The union of the intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _clipped(trace: Trace):
    w0, w1 = trace.window
    return [(max(s, w0), min(e, w1)) for _, s, e in trace.device if e > w0 and s < w1]


def busy_s(trace: Trace) -> float:
    """Seconds of the window in which some device operation ran."""
    return union_us(_clipped(trace)) / 1e6


def idle_share(trace: Trace) -> float:
    return 1.0 - busy_s(trace) / trace.window_s


def kernel_time(trace: Trace, patterns) -> Tuple[float, int]:
    """Summed device seconds and count of the device operations whose name
    contains any of ``patterns``."""
    hits = [(s, e) for name, s, e in trace.device if any(p in name for p in patterns)]
    return sum(e - s for s, e in hits) / 1e6, len(hits)


def top_ops(trace: Trace, k: int = 10):
    """[name, seconds] of the device operations that took most time, summed by name."""
    by = {}
    for name, s, e in trace.device:
        by[name] = by.get(name, 0.0) + (e - s) / 1e6
    return [[n[:160], t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(trace: Trace, k: int = 10):
    """[host operation, seconds] of the idle time within the window, summed
    by the innermost host operation at each gap's midpoint, largest first."""
    w0, w1 = trace.window
    gaps, cur = [], w0
    busy = merged(_clipped(trace))
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        gaps.append((cur, w1))
    host = sorted((h for h in trace.host if not h[0].startswith("cu")), key=lambda h: h[1])
    by, active, j = {}, [], 0
    for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (g0 + g1) / 2
        while j < len(host) and host[j][1] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[2] >= mid]
        label = max(active, key=lambda h: h[1])[0] if active else "(no host operation)"
        by[label] = by.get(label, 0.0) + (g1 - g0) / 1e6
    return [[n[:160], t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def _ns(event, what: str) -> float:
    f = getattr(event, what + "_ns", None)
    return f() / 1e3 if f is not None else getattr(event, what + "_us")()


def from_events(events) -> Trace:
    """The trace of ``(name, on_device, start us, end us)`` events.  A
    host span (``record_function``) is mirrored on the device's timeline,
    from its first kernel to its last: that mirror is no operation and is
    dropped."""
    device, host, window = [], [], None
    for name, on_device, start, end in events:
        (device if on_device else host).append((name, start, end))
        if name == WINDOW and not on_device:
            window = (start, end)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} span")
    spans = {name for name, _, _ in host}
    return Trace(device=[d for d in device if d[0] not in spans], host=host, window=window)


def from_profiler(prof) -> Trace:
    """The trace of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    def events():
        for e in prof.profiler.kineto_results.events():
            start = _ns(e, "start")
            yield e.name(), e.device_type() == DeviceType.CUDA, start, start + _ns(e, "duration")

    return from_events(events())
