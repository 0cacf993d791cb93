"""The one-time Gram cache (kernel 1), the group-level scan tables and the
whole-sweep kernel of wave mode (kernels 7 and 8).

Port of ``build_gram_cache`` (gmrm_tpu/ops/sweep_kernel.py:1259),
``build_sweep_tables`` (:918) and ``sweep_blocks_pallas`` (:839).  The
cache holds, per natural block of B markers, the raw NA-masked Gram
quadrants of ``[A; B]``; X never changes and block membership is fixed
under the block-preserving shuffle, so the sweep only gathers and scales
it.  ``sweep_blocks`` runs one whole sweep per launch
(csrc/sweep_blocks.cu); one kernel serves both of the JAX package's
regimes, the resident ``_sweep_kernel`` and the N-tiled
``_sweep_kernel_tiled``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gmrm_tpu_torch.ops import _build
from gmrm_tpu_torch.ops.decode import decode_planes

MAX_T = 8      # traits a kernel thread carries in registers (csrc MAX_T)
MAX_K = 16     # mixture components the kernels keep in registers


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


def sweep_blocks_plain(bed, blkidx, win_p, m_local, gram_cache, eps, na,
                       mave, msig, beta_old, comp_old, acum_old, grp,
                       u_p, z_p, sigmag, lc, rd, sqb, i2se, nonas, *, wave):
    """Plain PyTorch version of the whole-sweep kernel, written from the
    natural-order operands and the group tables as ``_block_scan_phase``
    does (gmrm_tpu/ops/sweep_kernel.py:140-368); operands as in
    :func:`sweep_blocks`.  Per block it runs the plain versions of
    kernels 2, 3 and 4."""
    # Imported here: block_gram imports raw_gram_plain from this module.
    from gmrm_tpu_torch.ops.block_gram import scale_gram
    from gmrm_tpu_torch.ops.block_kernels import (
        block_cdot_plain, block_eps_update_plain_,
    )
    from gmrm_tpu_torch.ops.scan_kernel_wave import (
        scan_masks, wave_scan_plain,
    )
    nblocks, B = win_p.shape
    nm1 = nonas.to(torch.float32)[:, None] - 1.0
    grp = grp.long()
    beta_new = beta_old.clone()
    comp_new = comp_old.clone()
    acum_new = acum_old.clone()
    for b in range(nblocks):
        blk = blkidx[b:b + 1].long()                        # (1,)
        win = win_p[b].long()
        rows = blk * B + win                                # natural slots
        g = grp[rows]
        mave_b = mave[:, rows]
        msig_b = msig[:, rows]
        beta_b = beta_old[:, rows]
        live, zerob = scan_masks(g, rows < m_local, sigmag)
        c = block_cdot_plain(bed, rows, eps, mave_b, msig_b)
        win2 = torch.cat([win, win + B])
        gf = gram_cache.index_select(0, blk)[0]
        gs = scale_gram(gf.index_select(1, win2).index_select(2, win2),
                        mave_b, msig_b)
        dbeta, bn, cn, an = wave_scan_plain(
            c + beta_b * nm1, lc[:, :, g], rd[:, :, g], sqb[:, :, g], gs,
            beta_b, comp_old[:, rows], acum_old[:, rows], u_p[b], z_p[b],
            live, zerob, i2se, wave)
        block_eps_update_plain_(bed, rows, msig_b * dbeta, mave_b, na, eps)
        beta_new[:, rows] = bn
        comp_new[:, rows] = cn
        acum_new[:, rows] = an
    return eps, beta_new, comp_new, acum_new


@functools.lru_cache(maxsize=None)
def sweep_plan(T: int, B: int, mb: int, nt: int, K: int, wave: int) -> dict:
    """The grid and shared-memory residency the sweep kernel uses at these
    shapes on the current card (csrc/sweep_blocks.cu ``plan_sweep``): one
    CTA per SM, the first for the scans and the others with ``cols`` byte
    columns each; the scan's per-marker tables and scaled Gram, then eps,
    then na, then the bed slice stay in shared memory while they fit.
    Launches nothing."""
    out = (ctypes.c_int * 6)()
    err = _build.library().gmrm_sweep_blocks_plan(
        T, B, mb, nt, K, wave, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(
            f"the sweep kernel cannot run at T={T}, B={B}, mb={mb}, NT={nt}, "
            f"K={K}, W={wave}: {_build.error_string(err)}")
    grid, cols, flags, smem, eps_bytes, gs_floats = out
    return {"grid": grid, "cols": cols, "smem_bytes": smem,
            "eps_bytes_per_cta": eps_bytes, "gs_floats": gs_floats,
            "resident": [name for bit, name in (
                (8, "scan tables"), (16, "scaled Gram"), (1, "eps"),
                (2, "na"), (4, "bed slice")) if flags & bit]}


def sweep_blocks(bed, blkidx, win_p, m_local, gram_cache, eps, na,
                 mave, msig, beta_old, comp_old, acum_old, grp,
                 u_p, z_p, sigmag, lc, rd, sqb, i2se, nonas, *, wave):
    """Kernels 7 and 8: the whole wave-mode sweep in one launch.

    bed (nblocks*B, mb) uint8 in natural (storage) order; blkidx (nblocks,)
    int32, processing step b sweeps natural block blkidx[b]; win_p
    (nblocks, B) int32, processing position i of step b is row win_p[b, i]
    of that block; m_local the real marker count; gram_cache
    (nblocks, NT, 2B, 2B) float32 (``build_gram_cache``); eps (T, 4, mb)
    float32, updated IN PLACE; na (NT, 4, mb) float32, NT = 1 under a shared
    NA mask, else T; mave/msig/beta_old/acum_old (T, m_pad) float32,
    comp_old (T, m_pad) int32 and grp (m_pad,) in natural order; u_p/z_p
    (nblocks, T, B) float32 in processing order; sigmag (T, G); lc/rd/sqb
    (K, T, G) from ``build_sweep_tables``; i2se = 1/(2 sigmaE) and nonas
    (T,).  Returns (eps, beta_new, comp_new, acum_new), the marker state
    (T, m_pad) in natural order.  CPU tensors take the plain version; CUDA
    tensors launch the kernel.
    """
    nblocks, B = win_p.shape
    T, m_pad = beta_old.shape
    nt = gram_cache.shape[1]
    if wave < 2 or B % wave:
        raise ValueError(f"wave {wave} must be > 1 and divide B={B}")
    if nt not in (1, T) or na.shape[0] != nt:
        raise ValueError(f"gram_cache has {nt} masks and na {na.shape[0]}; "
                         f"expected both 1 or both T={T}")
    if bed.device.type == "cpu":
        return sweep_blocks_plain(
            bed, blkidx, win_p, m_local, gram_cache, eps, na, mave, msig,
            beta_old, comp_old, acum_old, grp, u_p, z_p, sigmag, lc, rd,
            sqb, i2se, nonas, wave=wave)
    dev = bed.device
    mb = bed.shape[1]
    K, _, G = lc.shape
    if T > MAX_T or K > MAX_K:
        raise ValueError(f"T={T}, K={K} exceed the kernel's MAX_T={MAX_T}, "
                         f"MAX_K={MAX_K}")
    if m_pad >= 2 ** 31:
        raise ValueError(f"{m_pad} marker slots exceed the kernel's int32 "
                         f"row index")
    f32, i32 = torch.float32, torch.int32
    grp = grp.to(i32)
    _build.check(bed, "bed", torch.uint8, (nblocks * B, mb), dev)
    _build.check(blkidx, "blkidx", i32, (nblocks,), dev)
    _build.check(win_p, "win_p", i32, (nblocks, B), dev)
    _build.check(gram_cache, "gram_cache", f32, (nblocks, nt, 2 * B, 2 * B),
                 dev)
    _build.check(eps, "eps", f32, (T, 4, mb), dev)
    _build.check(na, "na", f32, (nt, 4, mb), dev)
    for name, x in (("mave", mave), ("msig", msig), ("beta_old", beta_old),
                    ("acum_old", acum_old)):
        _build.check(x, name, f32, (T, m_pad), dev)
    _build.check(comp_old, "comp_old", i32, (T, m_pad), dev)
    _build.check(grp, "grp", i32, (m_pad,), dev)
    for name, x in (("u_p", u_p), ("z_p", z_p)):
        _build.check(x, name, f32, (nblocks, T, B), dev)
    _build.check(sigmag, "sigmag", f32, (T, G), dev)
    for name, x in (("lc", lc), ("rd", rd), ("sqb", sqb)):
        _build.check(x, name, f32, (K, T, G), dev)
    _build.check(i2se, "i2se", f32, (T,), dev)
    _build.check(nonas, "nonas", f32, (T,), dev)
    plan = sweep_plan(T, B, mb, nt, K, wave)
    beta_new = torch.empty_like(beta_old)
    comp_new = torch.empty_like(comp_old)
    acum_new = torch.empty_like(acum_old)
    part = torch.empty((plan["grid"] - 1, 2 * T, B), dtype=f32, device=dev)
    red = torch.empty((2 * T, B), dtype=f32, device=dev)
    gsbuf = torch.empty((2, T, max(plan["gs_floats"], 1)), dtype=f32,
                        device=dev)
    dbuf = torch.empty((T, B), dtype=f32, device=dev)
    _build.launch("sweep_blocks", bed, blkidx, win_p, gram_cache, eps, na,
                  mave, msig, beta_old, comp_old, acum_old, grp, u_p, z_p,
                  sigmag, lc, rd, sqb, i2se, nonas, beta_new, comp_new,
                  acum_new, part, red, gsbuf, dbuf, nblocks, T, B, mb, nt, K,
                  wave, G, int(m_local))
    return eps, beta_new, comp_new, acum_new
