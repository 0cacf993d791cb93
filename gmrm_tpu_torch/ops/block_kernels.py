"""The sweep's two per-block passes over the bed: the residual dot products
(kernel 2) and the residual update (kernel 4), alone or fused.

Port of ``block_cdot_pallas`` and ``block_eps_update_pallas``
(gmrm_tpu/ops/pallas_kernels.py:335, :396).  Both read the block's marker
rows through the index ``rows = blk*B + win`` (processing order), so the
bed is never permuted or copied.  CPU tensors take the plain versions;
CUDA tensors launch the column-slice kernels of csrc/block_passes.cuh
(csrc/block_cdot.cu, csrc/eps_update.cu, and csrc/update_cdot.cu for block
b's update fused with block b+1's c-dot).

``pass_plan`` sizes a launch on the host: the byte columns a CTA owns (a
power of two from 16 to 256, so that the grid fills the card), the grid,
the c-dot's scratch (counters and partials) and the shared memory of the
fused pass, which is the largest; a shape whose 16-column slices do not fit
in shared memory is refused.

``BlockPasses`` runs the kernels over a sweep's blocks from the sweep's
whole processing-order arrays: the operands are checked once, the c-dot's
scratch is allocated once (its counters start at zero and every launch
leaves them at zero), and a block step passes addresses, so the host does
no tensor work per block.  The one-block wrappers and the class share the
checks (``_check_blocks``) and each kernel's launch.

Float64 (a ``--dtype float64`` run, kernel B): float64 eps, mave, msig and
d take the float64 passes of csrc/passes_f64.cu instead (a c-dot CTA per
marker row, an update CTA per 32 byte columns; T <= 8), the counterparts
of the JAX package's float64 einsums (gmrm_tpu/ops/blockops.py:131,
:141-148).  There is no fused float64 pass: ``update_cdot_`` launches the
update and then the c-dot.  Any other dtype raises ``ValueError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gmrm_tpu_torch.ops import _build
from gmrm_tpu_torch.ops.decode import decode_planes

MAX_T = 8            # traits a kernel thread carries in registers (csrc MAX_T)
THREADS = 256        # threads a CTA (csrc THREADS)
GROUP = 16           # slices per group of the c-dot's tree (csrc GROUP)
LINE = 32            # 32-bit words per counter (csrc LINE)
SLICE_TARGET = 264   # slices that fill the H100's 132 SMs twice
SLICE_MAX = 256      # byte columns a CTA at most
SMEM_BYTES = 232448  # dynamic shared memory of one CTA on the H100
UPDATE, CDOT = 1, 2  # pass bits (csrc UPDATE, CDOT); both: the fused pass
F64_COLS = 32        # byte columns of a float64 update CTA (csrc COLS)
F64_GROUPS = 8       # row groups of a float64 update CTA (csrc GROUPS)


def f64_update_smem(T: int, B: int) -> int:
    """Shared memory bytes of the float64 update (csrc
    gmrm_update_f64_smem): d and mave*d, and the row groups' partials."""
    return 8 * (2 * T * B + F64_GROUPS * T * 4 * F64_COLS)


def block_cdot_plain(bed, rows, eps, mave, msig):
    """c (T, B) = msig * (A_rows . eps - mave * (B_rows . eps)), in the
    dtype of eps."""
    a, b = decode_planes(bed[rows.long()], eps.dtype)      # (B, 4, mb)
    B = a.shape[0]
    a = a.reshape(B, -1)
    b = b.reshape(B, -1)
    e = eps.reshape(eps.shape[0], -1)                      # (T, 4mb)
    return msig * (e @ a.T - mave * (e @ b.T))


def block_eps_update_plain_(bed, rows, d, mave, na, eps):
    """eps += na * (d . A_rows - (mave*d) . B_rows), in place, in the
    dtype of eps."""
    a, b = decode_planes(bed[rows.long()], eps.dtype)      # (B, 4, mb)
    B = a.shape[0]
    T = eps.shape[0]
    a = a.reshape(B, -1)
    b = b.reshape(B, -1)
    deps = d @ a - (mave * d) @ b                          # (T, 4mb)
    eps += na * deps.reshape(T, 4, -1)
    return eps


def block_update_cdot_plain_(bed, rows, d, mave, na, eps, rows_next,
                             mave_next, msig_next):
    """Block b's update of eps IN PLACE, then block b+1's c-dot from the
    updated eps: ``block_eps_update_plain_`` followed by
    ``block_cdot_plain``.  Returns c_next (T, B)."""
    block_eps_update_plain_(bed, rows, d, mave, na, eps)
    return block_cdot_plain(bed, rows_next, eps, mave_next, msig_next)


def _al16(x: int) -> int:
    return (x + 15) & ~15


def pass_smem(T: int, B: int, S: int, mode: int) -> int:
    """Shared memory bytes of one CTA (csrc/block_passes.cuh pass_layout):
    the block's row indices, its bed slices (B rows of S bytes at an odd
    word stride), the slice of eps (and na), (d, mave*d) pairs for the update,
    and the larger of the two passes' reduction buffers."""
    upd, dot = bool(mode & UPDATE), bool(mode & CDOT)
    plane = T * 4 * S * 4
    tb = T * B * 4
    SP = S + 4 if (S // 4) % 2 == 0 else S
    R = THREADS // S if S < THREADS else 1
    P = THREADS // B if B < THREADS else 1
    parts = ((upd + dot) * B * 4, B * SP * upd, B * SP * dot, plane,
             plane * upd, 2 * tb * upd,
             max(R * plane * upd, P * 2 * tb * dot), 4)
    return sum(_al16(x) for x in parts)


def pass_scratch_words(nslices: int, T: int, B: int) -> int:
    """The c-dot's scratch in 32-bit words (csrc pass_scratch_words)."""
    ngroups = -(-nslices // GROUP)
    return (1 + ngroups) * LINE + (nslices + ngroups) * T * B


class PassPlan(NamedTuple):
    S: int              # byte columns a CTA owns
    grid: int           # CTAs (slices): ceil(mb / S)
    groups: int         # groups of GROUP slices in the c-dot's tree
    scratch_words: int  # the c-dot's scratch, int32 words
    smem: int           # shared memory bytes of the fused pass


def pass_plan(T: int, B: int, mb: int):
    """The launch shape of kernels 2 and 4 at (T, B, mb), or None when
    16-column slices do not fit in shared memory.  S is the widest power of
    two up to SLICE_MAX that still gives SLICE_TARGET slices, then halved
    while the fused pass does not fit."""
    if T > MAX_T:
        raise ValueError(f"{T} traits exceed the kernels' MAX_T={MAX_T}")
    S = 16
    while 2 * S <= SLICE_MAX and -(-mb // (2 * S)) >= SLICE_TARGET:
        S *= 2
    while S > 16 and pass_smem(T, B, S, UPDATE | CDOT) > SMEM_BYTES:
        S //= 2
    smem = pass_smem(T, B, S, UPDATE | CDOT)
    if smem > SMEM_BYTES:
        return None
    grid = -(-mb // S)
    return PassPlan(S, grid, -(-grid // GROUP),
                    pass_scratch_words(grid, T, B), smem)


def _check_blocks(bed, rows, mave, msig, na):
    """The limits and the operand checks of kernels 2 and 4, for one block
    (rows (B,), mave/msig (T, B)) or a sweep's blocks ((nb, B), (nb, T, B));
    ``msig`` is None for the update alone, ``na`` for the c-dot alone.
    Returns the launch plan of the float32 passes, None for the float64
    ones (the dtype of ``mave``)."""
    T, B = mave.shape[-2:]
    lead = tuple(mave.shape[:-2])
    dev = bed.device
    dtype = mave.dtype
    if dtype == torch.float32:
        plan = pass_plan(T, B, bed.shape[1])
        if plan is None:
            raise ValueError(f"T={T}, B={B} exceed the passes' {SMEM_BYTES} "
                             f"bytes of shared memory even at 16-byte "
                             f"slices")
    elif dtype == torch.float64:
        plan = None
        if T > MAX_T:
            raise ValueError(f"{T} traits exceed the kernels' MAX_T={MAX_T}")
        if f64_update_smem(T, B) > SMEM_BYTES:
            raise ValueError(f"T={T}, B={B} exceed the float64 update's "
                             f"{SMEM_BYTES} bytes of shared memory")
    else:
        raise ValueError(f"mave has dtype {dtype}: the passes take float32 "
                         f"or float64")
    _build.check(bed, "bed", torch.uint8, tuple(bed.shape), dev)
    _build.check(rows, "rows", torch.int32, lead + (B,), dev)
    _build.check(mave, "mave", dtype, lead + (T, B), dev)
    if msig is not None:
        _build.check(msig, "msig", dtype, lead + (T, B), dev)
    if na is not None:
        _build.check(na, "na", dtype, (T, 4, bed.shape[1]), dev)
    return plan


def _scratch(plan, device):
    return torch.zeros(plan.scratch_words, dtype=torch.int32, device=device)


# The events a launch records into a stamp buffer (grid, NST) of int64, in
# %globaltimer nanoseconds, by thread 0 of each CTA: the update's events
# in an update, the c-dot's in a c-dot, all in the fused pass; "group sum"
# only in the last CTA of each group, "top ticket" and "c written" only in
# the last group's.
PASS_STAMPS = ("start", "rows staged", "bed, eps, na, d staged",
               "update parts summed", "eps written", "c-dot parts summed",
               "partial and ticket", "group sum", "top ticket", "c written")
NST = len(PASS_STAMPS)


# The one launch of each kernel; an operand is a tensor or an address, and
# ``stamps`` a stamp buffer or None.
def _launch_cdot(bed, rows, eps, mave, msig, c, scratch, T, B, mb, S,
                 stamps=None):
    _build.launch("block_cdot", bed, rows, eps, mave, msig, c, scratch, T, B,
                  mb, S, stamps)


def _launch_update(bed, rows, d, mave, na, eps, T, B, mb, S, stamps=None):
    _build.launch("eps_update", bed, rows, d, mave, na, eps, T, B, mb, S,
                  stamps)


def _launch_update_cdot(bed, rows, rows_next, d, mave, mave_next, msig_next,
                        na, eps, c_next, scratch, T, B, mb, S, stamps=None):
    _build.launch("update_cdot", bed, rows, rows_next, d, mave, mave_next,
                  msig_next, na, eps, c_next, scratch, T, B, mb, S, stamps)


def _launch_cdot_f64(bed, rows, eps, mave, msig, c, T, B, mb):
    _build.launch("block_cdot_f64", bed, rows, eps, mave, msig, c, T, B, mb)


def _launch_update_f64(bed, rows, d, mave, na, eps, T, B, mb):
    _build.launch("eps_update_f64", bed, rows, d, mave, na, eps, T, B, mb)


def block_cdot(bed, rows, eps, mave, msig):
    """Kernel 2 (kernel B at float64): the block's residual dot products in
    processing order.

    bed (m_pad, mb) uint8 (the whole bed); rows (B,) int32 bed rows of the
    block in processing order; eps (T, 4, mb) float32; mave/msig (T, B)
    float32 in processing order (all float64 at float64).  Returns c (T, B)
    in their dtype.
    """
    if bed.device.type == "cpu":
        return block_cdot_plain(bed, rows, eps, mave, msig)
    T, B = mave.shape
    mb = bed.shape[1]
    plan = _check_blocks(bed, rows, mave, msig, None)
    _build.check(eps, "eps", mave.dtype, (T, 4, mb), bed.device)
    c = torch.empty((T, B), dtype=mave.dtype, device=bed.device)
    if plan is None:
        _launch_cdot_f64(bed, rows, eps, mave, msig, c, T, B, mb)
        return c
    _launch_cdot(bed, rows, eps, mave, msig, c, _scratch(plan, bed.device),
                 T, B, mb, plan.S)
    return c


def block_eps_update_(bed, rows, d, mave, na, eps):
    """Kernel 4 (kernel B at float64): ``eps += na * sum_i d_i (a_i -
    mave_i b_i)``, IN PLACE.

    d (T, B) = msig * dbeta and mave (T, B), both in processing order;
    na and eps (T, 4, mb) float32 (all float64 at float64).  Returns eps.
    """
    if bed.device.type == "cpu":
        return block_eps_update_plain_(bed, rows, d, mave, na, eps)
    T, B = mave.shape
    mb = bed.shape[1]
    plan = _check_blocks(bed, rows, mave, None, na)
    _build.check(d, "d", mave.dtype, (T, B), bed.device)
    _build.check(eps, "eps", mave.dtype, (T, 4, mb), bed.device)
    if plan is None:
        _launch_update_f64(bed, rows, d, mave, na, eps, T, B, mb)
    else:
        _launch_update(bed, rows, d, mave, na, eps, T, B, mb, plan.S)
    return eps


def block_update_cdot_(bed, rows, d, mave, na, eps, rows_next, mave_next,
                       msig_next):
    """Kernels 4 and 2 in one launch: block b's update of eps IN PLACE
    (rows, d, mave as for ``block_eps_update_``), then block b+1's residual
    dot products from the updated eps (rows_next, mave_next, msig_next as
    for ``block_cdot``).  Returns c_next (T, B)."""
    if bed.device.type == "cpu":
        return block_update_cdot_plain_(bed, rows, d, mave, na, eps,
                                        rows_next, mave_next, msig_next)
    if mave.dtype == torch.float64:
        block_eps_update_(bed, rows, d, mave, na, eps)
        return block_cdot(bed, rows_next, eps, mave_next, msig_next)
    T, B = mave.shape
    mb = bed.shape[1]
    dev = bed.device
    plan = _check_blocks(bed, rows, mave, None, na)
    _check_blocks(bed, rows_next, mave_next, msig_next, None)
    _build.check(d, "d", torch.float32, (T, B), dev)
    _build.check(eps, "eps", torch.float32, (T, 4, mb), dev)
    c = torch.empty((T, B), dtype=torch.float32, device=dev)
    _launch_update_cdot(bed, rows, rows_next, d, mave, mave_next, msig_next,
                        na, eps, c, _scratch(plan, dev), T, B, mb, plan.S)
    return c


class BlockPasses:
    """Kernels 2 and 4 over a sweep's blocks: the whole processing-order
    arrays, checked once, then a block index per call.

    bed (m_pad, mb) uint8; rows_all (nb, B) int32 bed rows of every block;
    mave_p/msig_p (nb, T, B) float32; na (T, 4, mb) float32 (float64 for
    the float64 passes, which take no stamps and no fused pass).  ``cdot``
    writes block ``b``'s residual dot products into ``c[b]`` (``c`` is
    (nb, T, B)); ``update_`` adds block ``b``'s residual update, from
    ``d_all[b]``, into ``target``; ``update_cdot_`` adds block ``b``'s
    update into ``eps`` itself and writes block ``b + 1``'s dot products,
    from the updated ``eps``, into ``c[b + 1]``, in one launch.  On CUDA
    tensors each takes an optional stamp buffer (``grid``, NST) int64 that
    the launch fills (``PASS_STAMPS``).
    """

    def __init__(self, bed, rows_all, mave_p, msig_p, na):
        nb, T, B = mave_p.shape
        dev = bed.device
        self.dims = (nb, T, B, bed.shape[1])
        self.ops = (bed, rows_all, mave_p, msig_p, na)
        self.dtype = mave_p.dtype
        self.es = mave_p.element_size()
        self.c = torch.empty((nb, T, B), dtype=self.dtype, device=dev)
        self.cuda = dev.type != "cpu"
        if self.cuda:
            self.plan = _check_blocks(bed, rows_all, mave_p, msig_p, na)
            self.scratch = (None if self.plan is None
                            else _scratch(self.plan, dev))
            self.ptr = [0 if x is None else x.data_ptr()
                        for x in (*self.ops, self.c, self.scratch)]
            self.seen = {}

    def _plane_ptr(self, x, name):
        """The address of a (T, 4, mb) residual-shaped operand."""
        _, T, _, mb = self.dims
        return _build.check_once(self.seen, x, name, self.dtype,
                                 (T, 4, mb), self.ops[0].device)

    def _d_ptr(self, d_all):
        nb, T, B, _ = self.dims
        return _build.check_once(self.seen, d_all, "d", self.dtype,
                                 (nb, T, B), self.ops[0].device)

    def _f64(self, stamps):
        """Whether the float64 passes launch (they record no stamps)."""
        if self.plan is not None:
            return False
        if stamps is not None:
            raise ValueError("the float64 passes record no stamps")
        return True

    def cdot(self, b, eps, stamps=None):
        bed, rows_all, mave_p, msig_p, _ = self.ops
        if not self.cuda:
            self.c[b] = block_cdot_plain(bed, rows_all[b], eps, mave_p[b],
                                         msig_p[b])
            return
        nb, T, B, mb = self.dims
        pbed, prow, pmave, pmsig, _, pc, pscr = self.ptr
        tb = b * T * B * self.es
        if self._f64(stamps):
            _launch_cdot_f64(pbed, prow + b * B * 4,
                             self._plane_ptr(eps, "eps"), pmave + tb,
                             pmsig + tb, pc + tb, T, B, mb)
            return
        _launch_cdot(pbed, prow + b * B * 4, self._plane_ptr(eps, "eps"),
                     pmave + tb, pmsig + tb, pc + tb, pscr, T, B, mb,
                     self.plan.S, stamps)

    def update_(self, b, d_all, target, stamps=None):
        bed, rows_all, mave_p, _, na = self.ops
        if not self.cuda:
            block_eps_update_plain_(bed, rows_all[b], d_all[b], mave_p[b],
                                    na, target)
            return
        nb, T, B, mb = self.dims
        pbed, prow, pmave, _, pna, _, _ = self.ptr
        tb = b * T * B * self.es
        if self._f64(stamps):
            _launch_update_f64(pbed, prow + b * B * 4,
                               self._d_ptr(d_all) + tb, pmave + tb, pna,
                               self._plane_ptr(target, "target"), T, B, mb)
            return
        _launch_update(pbed, prow + b * B * 4, self._d_ptr(d_all) + tb,
                       pmave + tb, pna, self._plane_ptr(target, "target"),
                       T, B, mb, self.plan.S, stamps)

    def update_cdot_(self, b, d_all, eps, stamps=None):
        """``update_(b, d_all, eps)`` then ``cdot(b + 1, eps)``, fused."""
        nb, T, B, mb = self.dims
        if not 0 <= b < nb - 1:
            raise ValueError(f"update_cdot_ of block {b} of {nb}: the last "
                             f"block has no next block to dot")
        if not self.cuda or self._f64(stamps):
            self.update_(b, d_all, eps)
            self.cdot(b + 1, eps)
            return
        pbed, prow, pmave, pmsig, pna, pc, pscr = self.ptr
        tb, tn = b * T * B * 4, (b + 1) * T * B * 4
        _launch_update_cdot(pbed, prow + b * B * 4, prow + (b + 1) * B * 4,
                            self._d_ptr(d_all) + tb, pmave + tb, pmave + tn,
                            pmsig + tn, pna, self._plane_ptr(eps, "eps"),
                            pc + tn, pscr, T, B, mb, self.plan.S, stamps)
