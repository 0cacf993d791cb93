"""Reduction of a ``torch.profiler`` trace of the traced window.

The trace gives device activities (kernels, copies, sets) and host events
(the harness's spans, operators, runtime calls) on one clock.  From them:
the union of the device's busy intervals, the device operations that took
most time, the longest idle gaps with what the host was doing in each,
and the host-issued launches and graph replays.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Tuple

LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                   "cuGraphLaunch")
SPAN_PREFIX = "portbench."


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(merged, lo: float, hi: float) -> float:
    """Length of ``merged`` inside [lo, hi]."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


def gaps(merged, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle intervals of [lo, hi] between the busy ones."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def _host_at(host, t: float) -> str:
    """The harness span and the innermost host event that cover ``t``."""
    span, inner, inner_len = "", "", float("inf")
    for name, s, e in host:
        if s <= t <= e:
            if name.startswith(SPAN_PREFIX):
                span = name[len(SPAN_PREFIX):]
            elif e - s < inner_len:
                inner, inner_len = name, e - s
    return "/".join(x for x in (span, inner) if x) or "none"


def events(prof):
    """(device activities, host events) as (name, start s, end s) lists,
    from the profiler's own event records.  The device's copies of the
    harness's spans (user annotations) are no device work."""
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
        kind = str(ev.device_type()).split(".")[-1].upper()
        if kind == "CUDA":
            if ev.is_user_annotation() or ev.name().startswith(SPAN_PREFIX):
                continue
            dev.append((ev.name(), start, end))
        else:
            host.append((ev.name(), start, end))
    return dev, host


def reduce(dev, host, lo: float, hi: float, top: int = 10) -> dict:
    """Busy seconds, the busiest operations and the longest idle gaps in
    the window [lo, hi] (seconds on the trace's clock), and the launches
    the host issued there."""
    merged = union([(s, e) for _, s, e in dev if e > lo and s < hi])
    by_name = defaultdict(float)
    for name, s, e in dev:
        by_name[name] += max(0.0, min(e, hi) - max(s, lo))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(merged, lo, hi), key=lambda g: g[0] - g[1])[:top]
    hosts = [(n, s, e) for n, s, e in host if e > lo and s < hi]
    launches = sum(1 for n, s, _ in hosts
                   if n.startswith(LAUNCH_PREFIXES) and lo <= s <= hi)
    return dict(
        busy_s=busy_seconds(merged, lo, hi), window_s=hi - lo,
        device_ops=[[n, v] for n, v in ops],
        idle_gaps=[[_host_at(hosts, 0.5 * (s + e)), e - s] for s, e in idle],
        launches=launches)


def op_table(dev, lo: float, hi: float) -> dict:
    """{device operation: [seconds, activities]} in the window [lo, hi]."""
    out = defaultdict(lambda: [0.0, 0])
    for name, s, e in dev:
        if e > lo and s < hi:
            out[name][0] += min(e, hi) - max(s, lo)
            out[name][1] += 1
    return dict(out)


def window_bounds(host) -> Tuple[float, float]:
    """Start and end of the harness's traced-window span."""
    for name, s, e in host:
        if name == SPAN_PREFIX + "window":
            return s, e
    raise RuntimeError("the trace holds no portbench.window span")
