"""The scaled Grams of the exact-serial (W=1) sweep's blocks (kernel 5).

Port of ``block_gram_scaled_pallas`` (gmrm_tpu/ops/pallas_kernels.py:238).
The uniform W=1 shuffle changes block membership every iteration, so the
Gram of a block's markers is recomputed every sweep instead of gathered
from the cache.  It does not depend on the residual, so it is not built
inside the serial block loop: ``blocks_gram_scaled`` builds the scaled
Grams of a whole run of blocks from one launch of the tensor-core kernel
and one of its scaling pass (csrc/block_gram.cu, csrc/gram_mma.cuh), and
the loop only takes ``gs[b]``.  The blocks' rows come through the index
``rows_all``, so the bed is never permuted or copied.

Memory: a run of ``nb`` blocks holds ``nb * T * B^2`` float32 of scaled
Grams and ``nb * NT * 3 * B^2`` int32 of raw quadrants (scratch, freed
when the call returns).  ``gram_run_blocks`` cuts a sweep's blocks into
runs whose Grams and scratch together stay under ``GRAM_RUN_BYTES``; a
run is never shorter than one block.

``block_gram_scaled`` (one block: c and gs) is the public counterpart of
the TPU wrapper: the case ``nb = 1`` plus the c-dot kernel (kernel 2).
CPU tensors take the plain versions; CUDA tensors launch the kernels.
Limits on CUDA tensors: T <= 8 (the c-dot), nb, T, NT <= 65535 per launch,
raw counts below 2^24 (N < 4.19 million individuals); anything else of
the wrong device, dtype, shape or layout raises ``ValueError``.
"""

from __future__ import annotations

import torch

from gmrm_tpu_torch.ops import _build
from gmrm_tpu_torch.ops.block_kernels import block_cdot, block_cdot_plain
from gmrm_tpu_torch.ops.sweep_kernel import raw_gram_plain

GRAM_RUN_BYTES = 128 * 2 ** 20   # scaled Grams + raw scratch of one run


def gram_run_blocks(T: int, B: int, nt: int, nblocks: int) -> int:
    """Blocks per run of ``blocks_gram_scaled`` under ``GRAM_RUN_BYTES``
    (at least 1, at most ``nblocks``)."""
    per_block = (T + 3 * nt) * B * B * 4
    return max(1, min(nblocks, GRAM_RUN_BYTES // per_block))


def scale_gram(gf, mave, msig):
    """The scaled Gram (..., T, B, B) from raw quadrants gf (..., NT, 2B, 2B)
    of ``[A; B]`` in processing order, mave/msig (..., T, B); NT = 1
    broadcasts over traits, and leading dimensions (a run of blocks) are
    taken element by element.

    The scaling expression of gmrm_tpu/sampler/gibbs.py:279-293 and of the
    TPU Gram kernel, rounded in the same order, so kernel and plain
    version agree bit for bit.
    """
    B = mave.shape[-1]
    g1 = gf[..., :B, :B]
    g2 = gf[..., B:, :B]
    g2t = gf[..., :B, B:]
    g3 = gf[..., B:, B:]
    mr = mave[..., None, :]                                # (..., T, 1, B)
    mc = mave[..., :, None]                                # (..., T, B, 1)
    sr = msig[..., None, :]
    sc = msig[..., :, None]
    graw = g1 - mr * g2t - mc * g2 + (mc * mr) * g3
    return ((sc * sr) * graw).contiguous()


def block_gram_scaled_plain(bed, rows, eps, na_in, mave, msig):
    """Plain PyTorch version of kernel 5 on one block: (c (T, B),
    gs (T, B, B))."""
    gf = raw_gram_plain(bed[rows.long()], na_in)           # (NT, 2B, 2B)
    c = block_cdot_plain(bed, rows, eps, mave, msig)
    return c, scale_gram(gf, mave, msig)


def blocks_gram_scaled_plain(bed, rows_all, na_in, mave_p, msig_p):
    """Plain PyTorch version of kernel 5 on a run of blocks:
    gs (nb, T, B, B), block by block."""
    return torch.stack([
        scale_gram(raw_gram_plain(bed[rows_all[n].long()], na_in),
                   mave_p[n], msig_p[n])
        for n in range(rows_all.shape[0])])


def blocks_gram_scaled(bed, rows_all, na_in, mave_p, msig_p):
    """Kernel 5: the scaled Grams of a run of blocks in processing order.

    bed (m_pad, mb) uint8 (the whole bed); rows_all (nb, B) int32 bed rows
    of every block in processing order; na_in (NT, 4, mb) float32 0/1 NA
    masks, NT = 1 when no phenotype has NAs, else T; mave_p/msig_p
    (nb, T, B) float32 in processing order.  Returns gs (nb, T, B, B)
    float32, bit-equal to the plain version.
    """
    if bed.device.type == "cpu":
        return blocks_gram_scaled_plain(bed, rows_all, na_in, mave_p, msig_p)
    nb, T, B = mave_p.shape
    nt = na_in.shape[0]
    mb = bed.shape[1]
    dev = bed.device
    if nt not in (1, T):
        raise ValueError(f"na_in has {nt} masks; expected 1 or T={T}")
    if max(nb, T) > 65535:
        raise ValueError(f"nb={nb}, T={T} exceed the grid's 65535")
    _build.check(bed, "bed", torch.uint8, tuple(bed.shape), dev)
    _build.check(rows_all, "rows_all", torch.int32, (nb, B), dev)
    _build.check(na_in, "na_in", torch.float32, (nt, 4, mb), dev)
    _build.check(mave_p, "mave_p", torch.float32, (nb, T, B), dev)
    _build.check(msig_p, "msig_p", torch.float32, (nb, T, B), dev)
    raw = torch.empty((nb, nt, 3, B, B), dtype=torch.int32, device=dev)
    gs = torch.empty((nb, T, B, B), dtype=torch.float32, device=dev)
    _build.launch("block_gram", bed, rows_all, na_in, mave_p, msig_p, raw,
                  gs, nb, T, B, mb, nt)
    return gs


def block_gram_scaled(bed, rows, eps, na_in, mave, msig):
    """Kernel 5 on one block, with its residual dot products: the block's
    c and scaled Gram in processing order.

    bed (m_pad, mb) uint8 (the whole bed); rows (B,) int32 bed rows of the
    block in processing order; eps (T, 4, mb) float32; na_in (NT, 4, mb)
    float32 NA masks, NT = 1 when no phenotype has NAs, else T;
    mave/msig (T, B) float32 in processing order.
    Returns c (T, B) and gs (T, B, B), both float32.
    """
    if bed.device.type == "cpu":
        return block_gram_scaled_plain(bed, rows, eps, na_in, mave, msig)
    c = block_cdot(bed, rows, eps, mave, msig)
    gs = blocks_gram_scaled(bed, rows[None], na_in, mave[None], msig[None])
    return c, gs[0]
