"""Kernel 7/8's scan CTA's own part of a block, in µs, in its stamped
sweep (the traced window's first): CTA 0 from having seen every group's
partials to having published the next block's last wave (``SWEEP_CHAIN``'s
scan segments, from the kernel's stamps); the rest of ``sweep.block_us``
is the columns and the hand-offs."""

from pbcore import program


def read(run):
    s = program.stamps(run).get("sweep_blocks")
    return None if s is None else s["scan_us"]
