"""Kernel 6/C's SM cycles a step (a marker) of its chain, over the
launches of its stamped sweep (the traced window's first), from its stamps
(``scan_kernel.scan_stamp_summary``)."""

from pbcore import program


def read(run):
    s = program.stamps(run).get("serial_scan")
    return None if s is None else s["cycles_per_step"]
