"""The program's own record of a traced window (gmrm_tpu_torch/trace.py):
its spans' readings and its kernels' stamps, read after the run.  Empty
where the run was not traced or the program keeps no such record."""

from __future__ import annotations


def _trace(run):
    if not run.get("trace"):
        return None
    try:
        from gmrm_tpu_torch import trace
    except ImportError:
        return None
    return trace


def spans(run) -> dict:
    """{span name: {"calls", "host_ms"}} (host ms a call)."""
    t = _trace(run)
    return {} if t is None else t.span_summaries()


def stamps(run) -> dict:
    """{kernel: its stamped sweep's summary}."""
    t = _trace(run)
    return {} if t is None else t.stamp_summaries()
