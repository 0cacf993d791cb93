"""The one-time Gram cache (kernel 1) and the group-level scan tables.

Port of ``build_gram_cache`` (gmrm_tpu/ops/sweep_kernel.py:1259) and
``build_sweep_tables`` (:918).  The cache holds, per natural block of B
markers, the raw NA-masked Gram quadrants of ``[A; B]``; X never changes
and block membership is fixed under the block-preserving shuffle, so the
sweep only gathers and scales it (sampler/gibbs.py).
"""

from __future__ import annotations

import torch

from gmrm_tpu_torch.ops import _build
from gmrm_tpu_torch.ops.decode import decode_planes


def raw_gram_plain(bed_rows: torch.Tensor,
                   na_in: torch.Tensor) -> torch.Tensor:
    """Raw NA-masked Gram quadrants (NT, 2B, 2B) float32 of ``[A; B]`` for
    the marker rows ``bed_rows`` (B, mb).

    Every entry is an exact integer count below 2^24, so float32 products
    and sums give it exactly in any order (TF32 off).
    """
    a, b = decode_planes(bed_rows)                           # (B, 4, mb)
    B = a.shape[0]
    nt = na_in.shape[0]
    ab = torch.cat([a, b], dim=0).reshape(2 * B, -1)
    naf = na_in.to(torch.float32).reshape(nt, 1, -1)
    return (ab[None] * naf) @ ab.T


def gram_cache_plain(bed: torch.Tensor, na_in: torch.Tensor,
                     block_size: int) -> torch.Tensor:
    """Plain PyTorch version of kernel 1: (nblocks, NT, 2B, 2B) float32."""
    m_pad = bed.shape[0]
    B = block_size
    nt = na_in.shape[0]
    out = torch.empty((m_pad // B, nt, 2 * B, 2 * B), dtype=torch.float32,
                      device=bed.device)
    for blk in range(m_pad // B):
        out[blk] = raw_gram_plain(bed[blk * B:(blk + 1) * B], na_in)
    return out


def build_gram_cache(bed: torch.Tensor, na: torch.Tensor, *,
                     block_size: int, shared_na: bool) -> torch.Tensor:
    """Raw Gram quadrants of every natural block.

    bed (m_pad, mb_pad) uint8 in natural (storage) order; na (T, 4, mb_pad)
    0/1 float32.  NT = 1 when no phenotype has NAs (``shared_na``), else T.
    Returns (nblocks, NT, 2B, 2B) float32, bit-equal to the JAX builder.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    m_pad, mb = bed.shape
    B = block_size
    if m_pad % B:
        raise ValueError(f"m_pad={m_pad} is not a multiple of B={B}")
    na_in = (na[:1] if shared_na else na).contiguous()
    nt = na_in.shape[0]
    if bed.device.type == "cpu":
        return gram_cache_plain(bed, na_in, B)
    nblocks = m_pad // B
    if nblocks > 65535:
        raise ValueError(f"{nblocks} blocks exceed the kernel's grid "
                         f"limit of 65535")
    _build.check(bed, "bed", torch.uint8, (m_pad, mb), bed.device)
    _build.check(na_in, "na", torch.float32, (nt, 4, mb), bed.device)
    out = torch.empty((nblocks, nt, 2 * B, 2 * B), dtype=torch.float32,
                      device=bed.device)
    _build.launch("gram_cache", bed, na_in, out, nblocks, B, mb, nt)
    return out


def build_sweep_tables(sigmag, sigmae, pi_est, cva, cvai, nonas, n_total):
    """Group-level scan tables (K, T, G): lc, rd, sqb.

    The per-marker prep of scan_kernel_wave.py:204-239 depends on a marker
    only through its group, so it is computed per group once per sweep
    and gathered per block (exact copies).  ``logl_k = lc_k + q rd_k``
    with q = num^2/(2 sigmaE); ``sqb_k`` is the slab's posterior sd.
    """
    f32 = torch.float32
    T = sigmag.shape[0]
    G = cva.shape[0]
    sigmae_f = sigmae.to(f32)[:, None]                      # (T, 1)
    nonas_f = nonas.to(f32)[:, None]
    n_total_f = torch.as_tensor(n_total, dtype=f32, device=sigmag.device)

    sg = sigmag.to(f32)                                     # (T, G)
    adav = sg == 0.0
    sg_safe = torch.where(adav, torch.ones_like(sg), sg)
    sige_g = sigmae_f / sg_safe
    sigg_e = sg_safe / sigmae_f

    cvai_b = cvai.to(f32)[:, 1:]                            # (G, K-1)
    cva_b = cva.to(f32)[:, 1:]
    denom = (n_total_f - 1.0) + sige_g[:, :, None] * cvai_b[None]
    zeros0 = torch.zeros((T, G, 1), dtype=f32, device=sigmag.device)
    rd = torch.cat([zeros0, 1.0 / denom], dim=2)            # (T, G, K)
    sqb = torch.cat([zeros0, torch.sqrt(sigmae_f[:, :, None] / denom)],
                    dim=2)

    lc = torch.log(pi_est.to(f32))                          # (T, G, K)
    tail = -0.5 * torch.log(
        sigg_e[:, :, None] * (nonas_f[:, :, None] - 1.0) * cva_b[None]
        + 1.0)
    lc = torch.cat([lc[:, :, :1], lc[:, :, 1:] + tail], dim=2)

    def ktg(x):
        return x.permute(2, 0, 1).contiguous()
    return ktg(lc), ktg(rd), ktg(sqb)
