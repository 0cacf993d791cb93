"""Kernel 7/8's period a block in its stamped sweep (the traced window's
first), in µs: the mean gap between CTA 0's starts of consecutive inner
blocks, from the kernel's own %globaltimer stamps
(``sweep_kernel.stamp_summary``)."""

from pbcore import program


def read(run):
    s = program.stamps(run).get("sweep_blocks")
    return None if s is None else s["block_us"]
