"""Where a traced window's device time goes by the program's own spans
(``gmrm.<name>``, gmrm_tpu_torch/trace.py).

Each device activity goes to the innermost ``gmrm.`` span that covers the
runtime call that launched it, matched by correlation id (a kernel
replayed from a CUDA graph carries its ``cudaGraphLaunch``'s); an
activity whose launch no span covers is ``unattributed``.  Each idle gap
of the window goes to the innermost ``gmrm.`` span covering its midpoint
(the rule of ``trace._host_at``), or to ``outside``.  Per span name:
calls, host ms and self host ms (less the part its child spans cover),
device-busy ms (the union of its activities), device-idle ms and
launches.
"""

from __future__ import annotations

from collections import defaultdict

from pbcore import trace

PREFIX = "gmrm."


def events(prof):
    """(device activities, host events) of a profiler, each as (name,
    start s, end s, correlation id); the device's copies of user
    annotations are no device work."""
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() * 1e-9
        item = (ev.name(), start, start + ev.duration_ns() * 1e-9,
                ev.correlation_id())
        if str(ev.device_type()).split(".")[-1].upper() == "CUDA":
            if not ev.is_user_annotation():
                dev.append(item)
        else:
            host.append(item)
    return dev, host


class _Spans:
    """The gmrm. spans of the window, innermost first at any time."""

    def __init__(self, host, lo, hi):
        self.spans = sorted(
            ((n[len(PREFIX):], s, e) for n, s, e, _ in host
             if n.startswith(PREFIX) and e > lo and s < hi),
            key=lambda x: x[2] - x[1])

    def at(self, t):
        for name, s, e in self.spans:
            if s <= t <= e:
                return name
        return None

    def self_seconds(self, s, e):
        """The span's length less the union of the spans inside it."""
        inner = [(a, b) for _, a, b in self.spans
                 if s <= a and b <= e and (a, b) != (s, e)]
        return (e - s) - trace.busy_seconds(trace.union(inner), s, e)


def reduce_spans(dev, host, lo: float, hi: float) -> dict:
    """The window [lo, hi]'s device time by gmrm. span (see the module)."""
    spans = _Spans(host, lo, hi)
    per = defaultdict(lambda: {"calls": 0, "host_ms": 0.0,
                               "self_host_ms": 0.0, "busy": [],
                               "idle_ms": 0.0, "launches": 0})
    for name, s, e in spans.spans:
        p = per[name]
        p["calls"] += 1
        p["host_ms"] += 1e3 * (e - s)
        p["self_host_ms"] += 1e3 * spans.self_seconds(s, e)
    # Runtime calls (cuda*, cu*) by correlation id; the profiler's own
    # operator events count from 1 in another series.
    launched = {c: s for n, s, _, c in host if n.startswith("cu")}
    for n, s, _, _ in host:
        if n.startswith(trace.LAUNCH_PREFIXES) and lo <= s <= hi:
            name = spans.at(s)
            if name is not None:
                per[name]["launches"] += 1
    window = [(n, max(s, lo), min(e, hi), c) for n, s, e, c in dev
              if e > lo and s < hi]
    unattributed = []
    for _, s, e, c in window:
        t = launched.get(c)
        name = None if t is None else spans.at(t)
        (unattributed if name is None else per[name]["busy"]).append((s, e))
    merged = trace.union([(s, e) for _, s, e, _ in window])
    outside = 0.0
    for s, e in trace.gaps(merged, lo, hi):
        name = spans.at(0.5 * (s + e))
        if name is None:
            outside += 1e3 * (e - s)
        else:
            per[name]["idle_ms"] += 1e3 * (e - s)
    out = {}
    for name, p in per.items():
        busy = p.pop("busy")
        p["busy_ms"] = 1e3 * trace.busy_seconds(trace.union(busy), lo, hi)
        out[name] = p
    return {"spans": out,
            "busy_ms": 1e3 * trace.busy_seconds(merged, lo, hi),
            "unattributed_ms": 1e3 * trace.busy_seconds(
                trace.union(unattributed), lo, hi),
            "idle_outside_ms": outside}
