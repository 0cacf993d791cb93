"""The per-block residual dot products and scaled Gram of the exact-serial
(W=1) sweep (kernel 5).

Port of ``block_gram_scaled_pallas`` (gmrm_tpu/ops/pallas_kernels.py:238).
The uniform W=1 shuffle changes block membership every iteration, so the
Gram of the block's markers is recomputed per block instead of gathered
from the cache.  The block's rows come through the index ``rows``, so the
bed is never permuted or copied.  CPU tensors take the plain version; CUDA
tensors launch csrc/block_gram.cu.
"""

from __future__ import annotations

import torch

from gmrm_tpu_torch.ops import _build
from gmrm_tpu_torch.ops.block_kernels import (
    _check_block, block_cdot_plain,
)
from gmrm_tpu_torch.ops.sweep_kernel import raw_gram_plain


def scale_gram(gf, mave, msig):
    """The scaled Gram (T, B, B) from raw quadrants gf (NT, 2B, 2B) of
    ``[A; B]`` in processing order; NT = 1 broadcasts over traits.

    The scaling expression of gmrm_tpu/sampler/gibbs.py:279-293 and of the
    TPU Gram kernel, rounded in the same order, so kernel and plain
    version agree bit for bit.
    """
    B = mave.shape[1]
    g1 = gf[:, :B, :B]
    g2 = gf[:, B:, :B]
    g2t = gf[:, :B, B:]
    g3 = gf[:, B:, B:]
    mr = mave[:, None, :]                                  # (T, 1, B)
    mc = mave[:, :, None]                                  # (T, B, 1)
    sr = msig[:, None, :]
    sc = msig[:, :, None]
    graw = g1 - mr * g2t - mc * g2 + (mc * mr) * g3
    return ((sc * sr) * graw).contiguous()


def block_gram_scaled_plain(bed, rows, eps, na_in, mave, msig):
    """Plain PyTorch version of kernel 5: (c (T, B), gs (T, B, B))."""
    gf = raw_gram_plain(bed[rows.long()], na_in)           # (NT, 2B, 2B)
    c = block_cdot_plain(bed, rows, eps, mave, msig)
    return c, scale_gram(gf, mave, msig)


def block_gram_scaled(bed, rows, eps, na_in, mave, msig):
    """Kernel 5: the block's c and scaled Gram in processing order.

    bed (m_pad, mb) uint8 (the whole bed); rows (B,) int32 bed rows of the
    block in processing order; eps (T, 4, mb) float32; na_in (NT, 4, mb)
    float32 NA masks, NT = 1 when no phenotype has NAs, else T;
    mave/msig (T, B) float32 in processing order.
    Returns c (T, B) and gs (T, B, B), both float32.
    """
    if bed.device.type == "cpu":
        return block_gram_scaled_plain(bed, rows, eps, na_in, mave, msig)
    T, B = mave.shape
    nt = na_in.shape[0]
    mb = bed.shape[1]
    dev = bed.device
    _check_block(bed, rows, T, B, dev)
    if nt not in (1, T):
        raise ValueError(f"na_in has {nt} masks; expected 1 or T={T}")
    _build.check(eps, "eps", torch.float32, (T, 4, mb), dev)
    _build.check(na_in, "na_in", torch.float32, (nt, 4, mb), dev)
    _build.check(mave, "mave", torch.float32, (T, B), dev)
    _build.check(msig, "msig", torch.float32, (T, B), dev)
    raw = torch.empty((nt, 2 * B, 2 * B), dtype=torch.int32, device=dev)
    c = torch.empty((T, B), dtype=torch.float32, device=dev)
    gs = torch.empty((T, B, B), dtype=torch.float32, device=dev)
    _build.launch("block_gram", bed, rows, eps, na_in, mave, msig, raw, c,
                  gs, T, B, mb, nt)
    return c, gs
