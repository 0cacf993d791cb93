"""The exact serial within-block scan (kernel 6).

Port of the kernel of ``block_scan_pallas`` (gmrm_tpu/ops/scan_kernel.py:61):
the block's B markers are drawn one after the other, each against the
residual as left by every earlier marker of the block, through the
running correction ``corr[t, i] += gs[t, j, i] * dbeta[t, j]``.  This is
the reference's exact recursion (bayes.cpp:391-492), the W=1 case of the
sweep.  ``serial_scan`` launches csrc/serial_scan.cu on CUDA tensors and
runs ``serial_scan_plain`` on CPU tensors; the per-marker prep is in
``gmrm_tpu_torch.sampler.scan.block_scan``.
"""

from __future__ import annotations

import torch

from gmrm_tpu_torch.ops import _build

MAX_K = 16     # mixture components the kernel keeps in registers
MAX_T = 32     # traits (csrc MAX_T)


def _fits(T: int, B: int) -> bool:
    """One CTA of at most 16 warps holds every (trait, marker) slot: each
    warp holds ceil(B / 16) markers of T traits in at most 8 slots of 32
    lanes (csrc serial_scan.cu)."""
    return T <= MAX_T and -(-B // 16) * T <= 8 * 32


def serial_scan_plain(base, lc, rd, sqb, gs, beta_old, comp_old, acum_old,
                      u, z, live, zerob, i2se):
    """Plain PyTorch version of kernel 6, operation for operation.

    Each add and product is rounded on its own; the sums over k and the
    CDF's prefix sum run in index order, as in the kernel.  Vectorised over
    the traits and, for the K partial normalisers, over (i, k).
    """
    T, B = base.shape
    K = lc.shape[0]
    livb = live != 0
    zerb = zerob != 0
    kk = torch.arange(K, device=base.device)
    upper = (kk[None, :] >= kk[:, None])[:, :, None]       # (i, k, 1): k >= i
    corr = torch.zeros_like(base)
    dbeta = torch.empty_like(base)
    beta_new = torch.empty_like(base)
    comp_new = torch.empty_like(comp_old)
    acum_new = torch.empty_like(base)
    zero = torch.zeros_like(base[:, 0])
    for j in range(B):
        num = base[:, j] + corr[:, j]                      # (T,)
        muk = num * rd[:, :, j]                            # (K, T)
        logl = lc[:, :, j] + muk * (num * i2se)
        d = logl[None, :, :] - logl[:, None, :]            # (i, k, T)
        guard = ((d.abs() > 700.0) & upper).any(dim=1)     # (i, T)
        e = torch.exp(d)
        esum = e[:, 0]
        for k in range(1, K):
            esum = esum + e[:, k]
        s = torch.where(guard, torch.zeros_like(esum), 1.0 / esum)
        cdf = [s[0]]
        for i in range(1, K):
            cdf.append(cdf[-1] + s[i])
        cdf = torch.stack(cdf)                             # (K, T)
        hit = (u[:, j][None] <= cdf).to(torch.int32)
        comp = torch.where(hit.any(0), hit.argmax(0),
                           torch.full_like(hit[0], K - 1)).to(torch.int32)
        sel = comp.long()[None]
        acum = cdf.gather(0, sel)[0]
        samp = torch.where(comp == 0, zero,
                           muk.gather(0, sel)[0]
                           + sqb[:, :, j].gather(0, sel)[0] * z[:, j])
        lv, zb, bo = livb[:, j], zerb[:, j], beta_old[:, j]
        db = torch.where(lv, bo - samp, zero)
        dbeta[:, j] = db
        beta_new[:, j] = torch.where(lv, samp, torch.where(zb, zero, bo))
        comp_new[:, j] = torch.where(lv, comp, comp_old[:, j])
        acum_new[:, j] = torch.where(
            lv, acum, torch.where(zb, torch.ones_like(bo), acum_old[:, j]))
        # Every step adds gs * dbeta, zero or not, as the kernel does (the
        # TPU kernel skips a step whose dbeta is all zero: the same values).
        corr = corr + gs[:, j, :] * db[:, None]
    return dbeta, beta_new, comp_new, acum_new


def serial_scan(base, lc, rd, sqb, gs, beta_old, comp_old, acum_old, u, z,
                live, zerob, i2se):
    """Kernel 6 on one block.

    base/beta_old/acum_old/u/z (T, B) float32; lc/rd/sqb (K, T, B) float32
    per-marker tables; gs (T, B, B) float32 scaled Gram in processing
    order; comp_old/live/zerob (T, B) int32; i2se (T,) = 1/(2 sigmaE).
    Returns (dbeta, beta_new, comp_new, acum_new), each (T, B).
    """
    if base.device.type == "cpu":
        return serial_scan_plain(base, lc, rd, sqb, gs, beta_old, comp_old,
                                 acum_old, u, z, live, zerob, i2se)
    T, B = base.shape
    K = lc.shape[0]
    if K > MAX_K:
        raise ValueError(f"K={K} mixture components exceed MAX_K={MAX_K}")
    if not _fits(T, B):
        raise ValueError(f"T={T}, B={B} exceed the serial scan's one CTA "
                         f"(T <= {MAX_T}, about T*B <= 4096)")
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
    _build.launch("serial_scan", base, lc, rd, sqb, gs, beta_old, comp_old,
                  acum_old, u, z, live, zerob, i2se, dbeta, beta_new,
                  comp_new, acum_new, T, B, K)
    return dbeta, beta_new, comp_new, acum_new
