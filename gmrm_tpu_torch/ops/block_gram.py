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

Memory: a run of ``nb`` blocks holds ``nb * T * B^2`` float32 (float64
on a float64 run) of scaled Grams and ``nb * NT * 3 * B^2`` int32 of raw quadrants (scratch, freed
when the call returns).  ``gram_run_blocks`` cuts a sweep's blocks into
runs whose Grams and scratch together stay under ``GRAM_RUN_BYTES``; a
run is never shorter than one block.

``block_gram_scaled`` (one block: c and gs) is the public counterpart of
the TPU wrapper: the case ``nb = 1`` plus the c-dot kernel (kernel 2).
CPU tensors take the plain versions; CUDA tensors launch the kernels.

Float64 (a ``--dtype float64`` run, kernel A): mave/msig float64 give gs
float64, from the same raw stage (the NA mask stays float32 0/1) and the
float64 scaling pass of csrc/block_gram.cu, bit-equal to the plain
version; the counterpart of the JAX package's float64 route,
``_block_gram_wide`` (gmrm_tpu/ops/blockops.py:131).
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


def gram_run_blocks(T: int, B: int, nt: int, nblocks: int,
                    elem: int = 4) -> int:
    """Blocks per run of ``blocks_gram_scaled`` under ``GRAM_RUN_BYTES``
    (at least 1, at most ``nblocks``), for T Grams of ``elem``-byte
    entries a block (4: float32, 8: float64) and NT int32 raw scratch."""
    per_block = (T * elem + 3 * nt * 4) * B * B
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


def _raw(bed_rows, na_in, dtype):
    """The raw quadrants in ``dtype`` (exact integers in either)."""
    return raw_gram_plain(bed_rows, na_in.to(torch.float32)).to(dtype)


def block_gram_scaled_plain(bed, rows, eps, na_in, mave, msig):
    """Plain PyTorch version of kernel 5 (of kernel A at float64) on one
    block: (c (T, B), gs (T, B, B))."""
    gf = _raw(bed[rows.long()], na_in, mave.dtype)         # (NT, 2B, 2B)
    c = block_cdot_plain(bed, rows, eps, mave, msig)
    return c, scale_gram(gf, mave, msig)


def blocks_gram_scaled_plain(bed, rows_all, na_in, mave_p, msig_p):
    """Plain PyTorch version of kernel 5 (of kernel A at float64) on a run
    of blocks: gs (nb, T, B, B), block by block."""
    return torch.stack([
        scale_gram(_raw(bed[rows_all[n].long()], na_in, mave_p.dtype),
                   mave_p[n], msig_p[n])
        for n in range(rows_all.shape[0])])


def blocks_gram_scaled(bed, rows_all, na_in, mave_p, msig_p):
    """Kernel 5 (kernel A at float64): the scaled Grams of a run of blocks
    in processing order.

    bed (m_pad, mb) uint8 (the whole bed); rows_all (nb, B) int32 bed rows
    of every block in processing order; na_in (NT, 4, mb) float32 0/1 NA
    masks, NT = 1 when no phenotype has NAs, else T; mave_p/msig_p
    (nb, T, B) float32, or float64, in processing order.  Returns gs
    (nb, T, B, B) in the dtype of mave_p, bit-equal to the plain version.
    """
    if bed.device.type == "cpu":
        return blocks_gram_scaled_plain(bed, rows_all, na_in, mave_p, msig_p)
    nb, T, B = mave_p.shape
    nt = na_in.shape[0]
    mb = bed.shape[1]
    dev = bed.device
    dtype = mave_p.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"mave_p has dtype {dtype}: the block Gram takes "
                         f"float32 or float64")
    if nt not in (1, T):
        raise ValueError(f"na_in has {nt} masks; expected 1 or T={T}")
    if max(nb, T) > 65535:
        raise ValueError(f"nb={nb}, T={T} exceed the grid's 65535")
    _build.check(bed, "bed", torch.uint8, tuple(bed.shape), dev)
    _build.check(rows_all, "rows_all", torch.int32, (nb, B), dev)
    _build.check(na_in, "na_in", torch.float32, (nt, 4, mb), dev)
    _build.check(mave_p, "mave_p", dtype, (nb, T, B), dev)
    _build.check(msig_p, "msig_p", dtype, (nb, T, B), dev)
    raw = torch.empty((nb, nt, 3, B, B), dtype=torch.int32, device=dev)
    gs = torch.empty((nb, T, B, B), dtype=dtype, device=dev)
    _build.launch("block_gram" if dtype == torch.float32
                  else "block_gram_f64", bed, rows_all, na_in, mave_p,
                  msig_p, raw, gs, nb, T, B, mb, nt)
    return gs


def block_gram_scaled(bed, rows, eps, na_in, mave, msig):
    """Kernel 5 on one block, with its residual dot products: the block's
    c and scaled Gram in processing order.

    bed (m_pad, mb) uint8 (the whole bed); rows (B,) int32 bed rows of the
    block in processing order; eps (T, 4, mb) float32; na_in (NT, 4, mb)
    float32 NA masks, NT = 1 when no phenotype has NAs, else T;
    mave/msig (T, B) float32 in processing order (eps, mave and msig
    float64 at float64).  Returns c (T, B) and gs (T, B, B) in their dtype.
    """
    if bed.device.type == "cpu":
        return block_gram_scaled_plain(bed, rows, eps, na_in, mave, msig)
    c = block_cdot(bed, rows, eps, mave, msig)
    gs = blocks_gram_scaled(bed, rows[None], na_in, mave[None], msig[None])
    return c, gs[0]
