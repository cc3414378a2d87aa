"""From the profiled calls' events to the device's numbers: device time
by kernel and the union of device activity (busy), from a profile of
device activity alone; the idle gaps named by the innermost host range
open at the gap, from a profile with host activity.

An event is (name, on_device, start_us, end_us).  Host ranges are the
benchmark's own `span:<name>` annotations (the program's stage spans, the
core's phases, and `span:window` around the whole profiled call); their
copies on the device's timeline (annotations, not work) are left out of
the device's activity.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

SPAN = "span:"
TOP = 10


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _split(events: Sequence[tuple]):
    dev = [(n, a, b) for n, on_dev, a, b in events
           if on_dev and not n.startswith(SPAN) and b > a]
    host = [(n[len(SPAN):], a, b) for n, on_dev, a, b in events
            if not on_dev and n.startswith(SPAN)]
    return dev, host


def device_side(events: Sequence[tuple]) -> dict:
    """Device time by kernel and the union of device activity (busy) of a
    profile of device activity alone."""
    dev, _host = _split(events)
    if not dev:
        return {}
    kernels: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    for n, a, b in dev:
        kernels[n][0] += (b - a) * 1e-6
        kernels[n][1] += 1
    busy_s = sum(b - a for a, b in _union([(a, b) for _n, a, b in dev]))
    by_time = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return dict(busy_s=busy_s * 1e-6,
                kernels={k: list(v) for k, v in kernels.items()},
                device_ops=[[k[:160], v[0]] for k, v in by_time[:TOP]])


def idle_gaps(events: Sequence[tuple]) -> List[list]:
    """The idle gaps of a profile with host ranges (`span:window` around
    it), each named by the innermost host range that holds its middle,
    summed by name, the longest first."""
    dev, host = _split(events)
    win = [(a, b) for n, a, b in host if n == "window"]
    if not win:
        return []
    w0, w1 = win[0]
    busy = _union([(max(a, w0), min(b, w1)) for _n, a, b in dev
                   if b > w0 and a < w1])
    gaps, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    # host ranges nest (one thread): the innermost that holds a point is
    # the latest-starting one that has not ended before it
    inner = sorted((a, b, n) for n, a, b in host if n != "window")
    starts = [a for a, _b, _n in inner]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0 and inner[i][1] < mid:
            i -= 1
        idle[inner[i][2] if i >= 0 else "window"] += (b - a) * 1e-6
    return [[k, v] for k, v in
            sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]


def kernel_seconds(kernels: Dict[str, list], pattern: str) -> float:
    """Device seconds of the kernels whose name holds `pattern`."""
    return sum(v[0] for k, v in kernels.items() if pattern in k)
