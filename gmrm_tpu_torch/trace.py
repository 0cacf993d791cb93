"""Spans of the port's phases and stamps of its kernels, on while a
``torch.profiler`` records.

There is no option: tracing is on exactly while a profiler records (the
benchmark's ``--trace 1``, or an operator's own profiler).  While none
does, :func:`span` returns one shared null context after a single flag
read, and the kernels run their unstamped instantiations.

While a profiler records:

- a span is a ``torch.profiler.record_function`` named ``gmrm.<name>``,
  so it lands in the profiler's trace on the clock of the device
  activities, the profiler's stack giving parent and child.  It also keeps
  its host seconds, reduced by :func:`span_summaries`; what the device did
  under a span is read from the profiler's trace, not here;
- the kernels that can stamp themselves (7/8, 6 and C) run their stamped
  instantiations for one sweep, the first of the stretch, into the
  persistent buffers of :func:`sweep_stamps`; every later sweep runs
  unstamped, so that the stamps' own cost (on an H100 about 3% of a
  sweep of 7/8 and 10% of one of C) stays out of the rest of the trace;
  the stamped sweep itself is in it.  :func:`stamp_summaries` reduces
  each kernel's stamped sweep.

The readings are those of the latest stretch of recording: the first
:func:`recording` call that finds a profiler newly started drops the last
stretch's.  They are process-wide, as the profiler itself is.
"""

from __future__ import annotations

import contextlib
import time

import torch

PREFIX = "gmrm."
_NULL = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


class _Stretch:
    """What the spans and stamps recorded since the profiler started."""

    def __init__(self):
        self.on = False
        self.clear()

    def clear(self):
        self.sums = {}              # name -> [calls, host s]
        self.stamps = {}            # kernel -> (buffer, reducer)

    def add(self, name, host_s):
        s = self.sums.setdefault(name, [0, 0.0])
        s[0] += 1
        s[1] += host_s


_STRETCH = _Stretch()
_BUFFERS = {}                       # kernel -> its persistent stamp buffer


def recording() -> bool:
    """Whether a profiler records now; the first call of a new stretch of
    recording drops the last stretch's readings."""
    on = _profiling()
    if on != _STRETCH.on:
        if on:
            _STRETCH.clear()
        _STRETCH.on = on
    return on


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        _STRETCH.add(self.name, host_s)
        return False


def span(name: str):
    """A context around one phase (never one block): the shared null
    context while no profiler records, else the span ``gmrm.<name>``."""
    if not recording():
        return _NULL
    return _Span(name)


def span_summaries() -> dict:
    """Each span name of the latest stretch of recording: ``calls`` and
    mean ``host_ms``."""
    return {name: {"calls": c, "host_ms": 1e3 * h / c}
            for name, (c, h) in _STRETCH.sums.items()}


def sweep_stamps(kernel: str, shape, device, reduce):
    """For a sweep of ``kernel`` while a profiler records: its persistent
    int64 stamp buffer of ``shape`` (allocated at first use), noted as the
    buffer of the stretch's stamped sweep, which ``reduce(buffer on the
    host)`` summarises; None where a sweep of it is stamped already."""
    if kernel in _STRETCH.stamps:
        return None
    buf = _BUFFERS.get(kernel)
    if buf is None or tuple(buf.shape) != tuple(shape) or buf.device != device:
        buf = _BUFFERS[kernel] = torch.zeros(shape, dtype=torch.int64,
                                             device=device)
    _STRETCH.stamps[kernel] = (buf, reduce)
    return buf


def stamp_summaries() -> dict:
    """Each stamped kernel's stamped sweep in the latest stretch of
    recording, reduced on the host: {kernel: summary}.  Waits for the
    device."""
    return {kernel: reduce(buf.cpu())
            for kernel, (buf, reduce) in _STRETCH.stamps.items()}
