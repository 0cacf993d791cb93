"""The sweep's two per-block passes over the bed: the residual dot
products (kernel 2) and the residual update (kernel 4).

Port of ``block_cdot_pallas`` and ``block_eps_update_pallas``
(gmrm_tpu/ops/pallas_kernels.py:335, :396).  Both read the block's marker
rows through the index ``rows = blk*B + win`` (processing order), so the
bed is never permuted or copied.  CPU tensors take the plain versions;
CUDA tensors launch the kernels (csrc/block_cdot.cu, csrc/eps_update.cu).

``BlockPasses`` runs the two kernels over a sweep's blocks from the
sweep's whole processing-order arrays: the operands are checked once, and
a block step passes addresses, so the host does no tensor work per block.
The one-block wrappers and the class share each kernel's checks
(``_check_blocks``) and its launch.
"""

from __future__ import annotations

import torch

from gmrm_tpu_torch.ops import _build
from gmrm_tpu_torch.ops.decode import decode_planes

MAX_T = 8      # traits a kernel thread carries in registers (csrc MAX_T)


def block_cdot_plain(bed, rows, eps, mave, msig):
    """c (T, B) = msig * (A_rows . eps - mave * (B_rows . eps))."""
    a, b = decode_planes(bed[rows.long()])                 # (B, 4, mb)
    B = a.shape[0]
    a = a.reshape(B, -1)
    b = b.reshape(B, -1)
    e = eps.reshape(eps.shape[0], -1)                      # (T, 4mb)
    return msig * (e @ a.T - mave * (e @ b.T))


def block_eps_update_plain_(bed, rows, d, mave, na, eps):
    """eps += na * (d . A_rows - (mave*d) . B_rows), in place."""
    a, b = decode_planes(bed[rows.long()])                 # (B, 4, mb)
    B = a.shape[0]
    T = eps.shape[0]
    a = a.reshape(B, -1)
    b = b.reshape(B, -1)
    deps = d @ a - (mave * d) @ b                          # (T, 4mb)
    eps += na * deps.reshape(T, 4, -1)
    return eps


def _check_blocks(bed, rows, mave, msig, na):
    """The limits and the operand checks of kernels 2 and 4, for one block
    (rows (B,), mave/msig (T, B)) or a sweep's blocks ((nb, B), (nb, T, B));
    ``msig`` is None for the update alone, ``na`` for the c-dot alone."""
    T, B = mave.shape[-2:]
    lead = tuple(mave.shape[:-2])
    dev = bed.device
    f32 = torch.float32
    if T > MAX_T:
        raise ValueError(f"{T} traits exceed the kernels' MAX_T={MAX_T}")
    _build.check(bed, "bed", torch.uint8, tuple(bed.shape), dev)
    _build.check(rows, "rows", torch.int32, lead + (B,), dev)
    _build.check(mave, "mave", f32, lead + (T, B), dev)
    if msig is not None:
        _build.check(msig, "msig", f32, lead + (T, B), dev)
    if na is not None:
        if 2 * T * B * 4 + 4 * B > 48 * 1024:
            raise ValueError(f"T={T}, B={B} exceed the update kernel's "
                             f"48 KB of shared memory")
        _build.check(na, "na", f32, (T, 4, bed.shape[1]), dev)


# The one launch of each kernel; an operand is a tensor or an address.
def _launch_cdot(bed, rows, eps, mave, msig, c, T, B, mb):
    _build.launch("block_cdot", bed, rows, eps, mave, msig, c, T, B, mb)


def _launch_update(bed, rows, d, mave, na, eps, T, B, mb):
    _build.launch("eps_update", bed, rows, d, mave, na, eps, T, B, mb)


def block_cdot(bed, rows, eps, mave, msig):
    """Kernel 2: the block's residual dot products in processing order.

    bed (m_pad, mb) uint8 (the whole bed); rows (B,) int32 bed rows of the
    block in processing order; eps (T, 4, mb) float32; mave/msig (T, B)
    float32 in processing order.  Returns c (T, B) float32.
    """
    if bed.device.type == "cpu":
        return block_cdot_plain(bed, rows, eps, mave, msig)
    T, B = mave.shape
    mb = bed.shape[1]
    _check_blocks(bed, rows, mave, msig, None)
    _build.check(eps, "eps", torch.float32, (T, 4, mb), bed.device)
    c = torch.empty((T, B), dtype=torch.float32, device=bed.device)
    _launch_cdot(bed, rows, eps, mave, msig, c, T, B, mb)
    return c


def block_eps_update_(bed, rows, d, mave, na, eps):
    """Kernel 4: ``eps += na * sum_i d_i (a_i - mave_i b_i)``, IN PLACE.

    d (T, B) = msig * dbeta and mave (T, B), both in processing order;
    na and eps (T, 4, mb) float32.  Returns eps.
    """
    if bed.device.type == "cpu":
        return block_eps_update_plain_(bed, rows, d, mave, na, eps)
    T, B = mave.shape
    mb = bed.shape[1]
    _check_blocks(bed, rows, mave, None, na)
    _build.check(d, "d", torch.float32, (T, B), bed.device)
    _build.check(eps, "eps", torch.float32, (T, 4, mb), bed.device)
    _launch_update(bed, rows, d, mave, na, eps, T, B, mb)
    return eps


class BlockPasses:
    """Kernels 2 and 4 over a sweep's blocks: the whole processing-order
    arrays, checked once, then a block index per call.

    bed (m_pad, mb) uint8; rows_all (nb, B) int32 bed rows of every block;
    mave_p/msig_p (nb, T, B) float32; na (T, 4, mb) float32.  ``cdot``
    writes block ``b``'s residual dot products into ``c[b]`` (``c`` is
    (nb, T, B)); ``update_`` adds block ``b``'s residual update, from
    ``d_all[b]``, into ``target``.
    """

    def __init__(self, bed, rows_all, mave_p, msig_p, na):
        nb, T, B = mave_p.shape
        dev = bed.device
        self.dims = (nb, T, B, bed.shape[1])
        self.ops = (bed, rows_all, mave_p, msig_p, na)
        self.c = torch.empty((nb, T, B), dtype=torch.float32, device=dev)
        self.cuda = dev.type != "cpu"
        if self.cuda:
            _check_blocks(bed, rows_all, mave_p, msig_p, na)
            self.ptr = [x.data_ptr() for x in (*self.ops, self.c)]
            self.seen = {}

    def _plane_ptr(self, x, name):
        """The address of a (T, 4, mb) residual-shaped operand."""
        _, T, _, mb = self.dims
        return _build.check_once(self.seen, x, name, torch.float32,
                                 (T, 4, mb), self.ops[0].device)

    def cdot(self, b, eps):
        bed, rows_all, mave_p, msig_p, _ = self.ops
        if not self.cuda:
            self.c[b] = block_cdot_plain(bed, rows_all[b], eps, mave_p[b],
                                         msig_p[b])
            return
        nb, T, B, mb = self.dims
        pbed, prow, pmave, pmsig, _, pc = self.ptr
        tb = b * T * B * 4
        _launch_cdot(pbed, prow + b * B * 4, self._plane_ptr(eps, "eps"),
                     pmave + tb, pmsig + tb, pc + tb, T, B, mb)

    def update_(self, b, d_all, target):
        bed, rows_all, mave_p, _, na = self.ops
        if not self.cuda:
            block_eps_update_plain_(bed, rows_all[b], d_all[b], mave_p[b],
                                    na, target)
            return
        nb, T, B, mb = self.dims
        pd = _build.check_once(self.seen, d_all, "d", torch.float32,
                               (nb, T, B), bed.device)
        pbed, prow, pmave, _, pna, _ = self.ptr
        tb = b * T * B * 4
        _launch_update(pbed, prow + b * B * 4, pd + tb, pmave + tb, pna,
                       self._plane_ptr(target, "target"), T, B, mb)
