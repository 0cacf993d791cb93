"""The within-block scan in waves of W markers (kernel 3).

Port of ``make_block_scan_wave`` (gmrm_tpu/ops/scan_kernel_wave.py:196):
the block's markers are drawn in B/W serial waves; markers of one wave
draw against the residual as of the wave start, and the wave's rank-W
Gram correction is folded before the next wave.  This is the relaxation
the reference makes across W co-scheduled MPI ranks (bayes.cpp:375-553).

``wave_scan`` takes the per-marker tables and launches csrc/wave_scan.cu
(or runs ``wave_scan_plain`` on CPU tensors); the per-marker prep of
scan_kernel_wave.py:204-239 is in
``gmrm_tpu_torch.sampler.scan.block_scan_wave``.
"""

from __future__ import annotations

import torch

from gmrm_tpu_torch.ops import _build

MAX_K = 16     # mixture components the kernel keeps in registers


def wave_scan_plain(base, lc, rd, sqb, gs, beta_old, comp_old, acum_old,
                    u, z, live, zerob, i2se, wave):
    """Plain PyTorch version of kernel 3, operation for operation.

    Each add and product is rounded on its own, and the sums over K run in
    index order, as in the kernel, so only the fold's sum order differs.
    """
    B = base.shape[1]
    K = lc.shape[0]
    W = wave
    livb = live != 0
    zerb = zerob != 0
    corr = torch.zeros_like(base)
    dbeta = torch.empty_like(base)
    beta_new = torch.empty_like(base)
    comp_new = torch.empty_like(comp_old)
    acum_new = torch.empty_like(base)
    i2se_c = i2se[:, None]
    for w0 in range(0, B, W):
        s = slice(w0, w0 + W)
        num = base[:, s] + corr[:, s]
        q = num * num * i2se_c
        L = [lc[k][:, s] + q * rd[k][:, s] for k in range(K)]
        lmax = L[0]
        for k in range(1, K):
            lmax = torch.maximum(lmax, L[k])
        e = [torch.exp(L[k] - lmax) for k in range(K)]
        ssum = e[0]
        for k in range(1, K):
            ssum = ssum + e[k]
        inv_s = 1.0 / ssum
        cdf = [None] * K
        smax = smin = L[K - 1]
        for i in range(K - 1, -1, -1):
            smax = torch.maximum(L[i], smax)
            smin = torch.minimum(L[i], smin)
            over = ((smax - L[i]) > 700.0) | ((L[i] - smin) > 700.0)
            cdf[i] = torch.where(over, torch.zeros_like(e[i]), e[i] * inv_s)
        for i in range(1, K):
            cdf[i] = cdf[i - 1] + cdf[i]
        cdf = torch.stack(cdf)                                 # (K, T, W)
        uu = u[:, s]
        hit = (uu[None] <= cdf).to(torch.int32)
        comp = torch.where(hit.any(0), hit.argmax(0),
                           torch.full_like(hit[0], K - 1)).to(torch.int32)
        sel = comp.long()[None]
        acum_sel = cdf.gather(0, sel)[0]
        rd_sel = rd[:, :, s].gather(0, sel)[0]
        sqb_sel = sqb[:, :, s].gather(0, sel)[0]
        samp = torch.where(comp == 0, torch.zeros_like(num),
                           num * rd_sel + sqb_sel * z[:, s])
        lv, zb, bo = livb[:, s], zerb[:, s], beta_old[:, s]
        db = torch.where(lv, bo - samp, torch.zeros_like(bo))
        dbeta[:, s] = db
        beta_new[:, s] = torch.where(
            lv, samp, torch.where(zb, torch.zeros_like(bo), bo))
        comp_new[:, s] = torch.where(lv, comp, comp_old[:, s])
        acum_new[:, s] = torch.where(
            lv, acum_sel,
            torch.where(zb, torch.ones_like(bo), acum_old[:, s]))
        corr = corr + torch.einsum("tj,tji->ti", db, gs[:, s, :])
    return dbeta, beta_new, comp_new, acum_new


def wave_scan(base, lc, rd, sqb, gs, beta_old, comp_old, acum_old, u, z,
              live, zerob, i2se, *, wave):
    """Kernel 3 on one block.

    base/beta_old/acum_old/u/z (T, B) float32; lc/rd/sqb (K, T, B) float32
    per-marker tables; gs (T, B, B) float32 scaled Gram in processing
    order; comp_old/live/zerob (T, B) int32; i2se (T,) = 1/(2 sigmaE).
    Returns (dbeta, beta_new, comp_new, acum_new), each (T, B).
    """
    if base.device.type == "cpu":
        return wave_scan_plain(base, lc, rd, sqb, gs, beta_old, comp_old,
                               acum_old, u, z, live, zerob, i2se, wave)
    T, B = base.shape
    K = lc.shape[0]
    if K > MAX_K:
        raise ValueError(f"K={K} mixture components exceed MAX_K={MAX_K}")
    if B % wave or T * wave > 256:
        raise ValueError(f"wave {wave} must divide B={B} with T*W <= 256")
    dev = base.device
    f32, i32 = torch.float32, torch.int32
    for name, x in (("base", base), ("beta_old", beta_old),
                    ("acum_old", acum_old), ("u", u), ("z", z)):
        _build.check(x, name, f32, (T, B), dev)
    for name, x in (("lc", lc), ("rd", rd), ("sqb", sqb)):
        _build.check(x, name, f32, (K, T, B), dev)
    for name, x in (("comp_old", comp_old), ("live", live),
                    ("zerob", zerob)):
        _build.check(x, name, i32, (T, B), dev)
    _build.check(gs, "gs", f32, (T, B, B), dev)
    _build.check(i2se, "i2se", f32, (T,), dev)
    dbeta = torch.empty((T, B), dtype=f32, device=dev)
    beta_new = torch.empty_like(dbeta)
    acum_new = torch.empty_like(dbeta)
    comp_new = torch.empty((T, B), dtype=i32, device=dev)
    _build.launch("wave_scan", base, lc, rd, sqb, gs, beta_old, comp_old,
                  acum_old, u, z, live, zerob, i2se, dbeta, beta_new,
                  comp_new, acum_new, T, B, K, wave)
    return dbeta, beta_new, comp_new, acum_new


def scan_masks(grp, valid, sigmag):
    """live (valid, group variance > 0) and zerob (valid, adaV-zeroed)
    masks, (T, B) int32."""
    adav = sigmag[:, grp] == 0.0
    live = valid[None, :] & ~adav
    zerob = valid[None, :] & adav
    return live.to(torch.int32), zerob.to(torch.int32)
