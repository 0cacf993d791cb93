"""The sweep's two per-block passes over the bed: the residual dot
products (kernel 2) and the residual update (kernel 4).

Port of ``block_cdot_pallas`` and ``block_eps_update_pallas``
(gmrm_tpu/ops/pallas_kernels.py:335, :396).  Both read the block's marker
rows through the index ``rows = blk*B + win`` (processing order), so the
bed is never permuted or copied.  CPU tensors take the plain versions;
CUDA tensors launch the kernels (csrc/block_cdot.cu, csrc/eps_update.cu).
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


def _check_block(bed, rows, T, B, device):
    if T > MAX_T:
        raise ValueError(f"{T} traits exceed the kernels' MAX_T={MAX_T}")
    _build.check(bed, "bed", torch.uint8, tuple(bed.shape), device)
    _build.check(rows, "rows", torch.int32, (B,), device)


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
    dev = bed.device
    _check_block(bed, rows, T, B, dev)
    _build.check(eps, "eps", torch.float32, (T, 4, mb), dev)
    _build.check(mave, "mave", torch.float32, (T, B), dev)
    _build.check(msig, "msig", torch.float32, (T, B), dev)
    c = torch.empty((T, B), dtype=torch.float32, device=dev)
    _build.launch("block_cdot", bed, rows, eps, mave, msig, c, T, B, mb)
    return c


def block_eps_update_(bed, rows, d, mave, na, eps):
    """Kernel 4: ``eps += na * sum_i d_i (a_i - mave_i b_i)``, IN PLACE.

    d (T, B) = msig * dbeta and mave (T, B), both in processing order;
    na and eps (T, 4, mb) float32.  Returns eps.
    """
    if bed.device.type == "cpu":
        return block_eps_update_plain_(bed, rows, d, mave, na, eps)
    T, B = d.shape
    mb = bed.shape[1]
    dev = bed.device
    _check_block(bed, rows, T, B, dev)
    if 2 * T * B * 4 + 4 * B > 48 * 1024:
        raise ValueError(f"T={T}, B={B} exceed the update kernel's 48 KB "
                         f"of shared memory")
    _build.check(d, "d", torch.float32, (T, B), dev)
    _build.check(mave, "mave", torch.float32, (T, B), dev)
    _build.check(na, "na", torch.float32, (T, 4, mb), dev)
    _build.check(eps, "eps", torch.float32, (T, 4, mb), dev)
    _build.launch("eps_update", bed, rows, d, mave, na, eps, T, B, mb)
    return eps
