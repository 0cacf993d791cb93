"""The within-block scan in waves of W markers (kernel 3, and kernel E at
float64).

Port of ``make_block_scan_wave`` (gmrm_tpu/ops/scan_kernel_wave.py:196):
the block's markers are drawn in B/W serial waves; markers of one wave
draw against the residual as of the wave start, and the wave's rank-W
Gram correction is folded before the next wave.  This is the relaxation
the reference makes across W co-scheduled MPI ranks (bayes.cpp:375-553).

Two interfaces, one kernel (csrc/wave_scan.cu), as kernel 6 has:

- ``wave_scan(base, ...)`` on one block's tensors, the public counterpart
  of the TPU kernel; the per-marker prep of scan_kernel_wave.py:204-239 is
  in ``gmrm_tpu_torch.sampler.scan.block_scan_wave``;
- ``WaveScanSweep``: the sweep's whole processing-order arrays
  ``(nb, ..., B)``, checked once, and a block index per step; the kernel
  forms ``base = c + beta_old * (nonas - 1)`` itself and also writes
  ``d = msig * dbeta``, the operand of the residual update (the composed
  W > 1 sweep, sampler/gibbs.py).

Float32 operands launch kernel 3 (``gmrm_wave_scan``), float64 operands
kernel E (``gmrm_wave_scan_f64``, the double instance of the same
template: a ``--dtype float64 --wave-size W`` run scans in double, where
the JAX package's wave kernel narrows to float32).  CUDA tensors launch
the kernel; CPU tensors run ``wave_scan_plain`` at either dtype.  Any
number K of mixture components (past 16 the kernel's draw keeps no array
of them and reads the tables K-fold, from shared memory while they fit
beside the state); W must divide B.  A launch is a grid of trait
groups, TG traits a CTA (``launch_plan``), so any T runs while one trait's
state fits.  Kernel 3 takes every trait in one CTA while the block's
state (10 T B values) fits in its shared memory (``wave_plan``: about
T B <= 5,700); kernel E spreads the traits over CTAs so that each stages
the tables and every wave's Gram rows (``f64_traits_a_cta``).  Anything
else of the wrong device, dtype, shape or layout raises ``ValueError``.
"""

from __future__ import annotations

import torch

from gmrm_tpu_torch.ops import _build
from gmrm_tpu_torch.ops.scan_kernel import ScanSweep
from gmrm_tpu_torch.ops.trait_chunks import even_width, most_that_fit

NSTATE = 10    # staged (T, B) arrays (csrc NSTATE)
NBAR = 3       # mbarriers (csrc NBAR)
SMEM_BYTES = 232448   # dynamic shared memory of one CTA on the H100


def _al4(x: int) -> int:
    return (x + 3) & ~3


def row_stride(rest: int, es: int = 4) -> int:
    """A packed Gram row's stride in shared memory (csrc), in values of es
    bytes: ``rest`` floats padded to 8 past a multiple of 32, ``rest``
    doubles to 2 past a multiple of 16.  The fold's lanes read up to 8
    rows at neighbouring columns; a double takes two banks and a warp's
    8-byte loads go by half-warps, so at float64 the 8 rows of 2 columns
    of a half-warp fall on 16 distinct bank pairs."""
    if es == 8:
        return rest + (18 - rest % 16) % 16
    return rest + (40 - rest % 32) % 32


def _layout_words(T, B, K, W, tab, gsw, es=4) -> int:
    """Shared memory of csrc/wave_scan.cu make_layout in values of es bytes
    (4: float, 8: double): the mbarriers, the state, i2se and nm1, two
    waves' dbeta, the waves' offsets, the tables, the packed rows."""
    rows = sum(W * row_stride(B - (v + 1) * W, es) for v in range(gsw))
    return (_al4(2 * NBAR) + NSTATE * _al4(T * B) + 2 * _al4(T)
            + _al4(2 * T * W) + _al4(B // W + 1) + 3 * tab * _al4(K * T * B)
            + _al4(T * rows))


def wave_plan(T: int, B: int, K: int, W: int, es: int = 4):
    """(tab, gsw) of the kernel's shared memory at values of es bytes, or
    None when the block's state does not fit: tab 1 stages the per-marker
    tables, and the packed Gram rows of waves 0 .. gsw - 1 are staged (in
    wave order, as many as fit beside the rest); the later waves' rows are
    read from global memory, where the Gram sits in L2.  The last wave has
    no rows to fold."""
    if B % W:
        raise ValueError(f"wave {W} must divide B={B}")
    cap = SMEM_BYTES // es
    if _layout_words(T, B, K, W, 0, 0, es) > cap:
        return None
    tab = int(_layout_words(T, B, K, W, 1, 0, es) <= cap)
    gsw = 0
    while (gsw < B // W - 1
           and _layout_words(T, B, K, W, tab, gsw + 1, es) <= cap):
        gsw += 1
    return tab, gsw


def wave_stamp_names(nw: int) -> tuple:
    """The events of a launch's stamp buffer (``stamps=``), in order."""
    waves = [f"wave {w} {e}" for w in range(nw) for e in ("drawn", "folded")]
    return ("start", "operands staged", *waves)


def _plan_or_raise(T, B, K, W):
    """The plan of one CTA of all T traits, or ``ValueError``."""
    plan = wave_plan(T, B, K, W)
    if plan is None:
        raise ValueError(f"T={T}, B={B} exceed the wave scan's shared "
                         f"memory (about T*B <= 5,700)")
    return plan


def launch_plan(T, B, K, W, es=4):
    """(tab, gsw, TG) of a launch at T traits and es-byte values; TG, the
    traits a CTA, gives a grid of ceil(T / TG) CTAs and the plan is that of
    a CTA of TG traits.  At 4-byte values (kernel 3): one CTA of all of
    them (TG = T) where ``wave_plan`` holds them, else TG the width of the
    most even split of T into groups of at most the most traits it holds.
    At 8-byte values (kernel E): ``f64_traits_a_cta``."""
    if es == 8:
        TG = f64_traits_a_cta(T, B, K, W)
        return (*wave_plan(TG, B, K, W, 8), TG)
    plan = wave_plan(T, B, K, W, es)
    if plan is not None:
        return (*plan, T)
    cap = most_that_fit(T, lambda t: wave_plan(t, B, K, W, es) is not None)
    if cap == 0:
        raise ValueError(f"B={B}: one trait's block state exceeds the wave "
                         f"scan's shared memory")
    TG = even_width(T, cap)
    return (*wave_plan(TG, B, K, W, es), TG)


# Kernel E's traits a CTA where that many stage everything: the most even
# split of T into groups of at most this many (on the H100 one trait a CTA
# ran faster than two or three at the anchor and at T=16;
# chip_smoke.py --wave64-pairs).
F64_TG = 1


def f64_traits_a_cta(T, B, K, W):
    """Kernel E's traits a CTA: a trait's chain needs no other trait's, so
    the traits are spread over CTAs until each CTA stages the tables and
    every wave's packed Gram rows (no fold reads L2 or device memory), at
    most ``F64_TG`` traits a CTA; where one trait cannot hold every wave,
    the most traits a CTA that stage as much as one trait does (the tables
    first, then waves in wave order), fewer CTAs on a tie."""
    one = wave_plan(1, B, K, W, 8)
    if one is None:
        raise ValueError(f"B={B}: one trait's block state exceeds the wave "
                         f"scan's shared memory")
    cap = most_that_fit(T, lambda t: wave_plan(t, B, K, W, 8) == one)
    if one == (1, B // W - 1):
        cap = min(cap, F64_TG)
    return even_width(T, cap)


def wave_scan_plain(base, lc, rd, sqb, gs, beta_old, comp_old, acum_old,
                    u, z, live, zerob, i2se, wave):
    """Plain PyTorch version of kernels 3 and E, operation for operation,
    in the dtype of the operands.

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
    """Kernel 3 (kernel E on float64 operands) on one block (the sweep
    interface's nb = 1 case, with base given and no d).

    base/beta_old/acum_old/u/z (T, B) float32; lc/rd/sqb (K, T, B) float32
    per-marker tables; gs (T, B, B) float32 scaled Gram in processing
    order; comp_old/live/zerob (T, B) int32; i2se (T,) = 1/(2 sigmaE).
    Every float operand float64 at float64.  Returns (dbeta, beta_new,
    comp_new, acum_new), each (T, B).
    """
    if base.device.type == "cpu":
        return wave_scan_plain(base, lc, rd, sqb, gs, beta_old, comp_old,
                               acum_old, u, z, live, zerob, i2se, wave)
    T, B = base.shape
    K = lc.shape[0]
    dty, i32 = base.dtype, torch.int32
    if dty not in _build.SUFFIX:
        raise ValueError(f"base has dtype {dty}: the wave scan takes "
                         f"float32 or float64")
    plan = launch_plan(T, B, K, wave, base.element_size())
    dev = base.device
    for name, x in (("base", base), ("beta_old", beta_old),
                    ("acum_old", acum_old), ("u", u), ("z", z)):
        _build.check(x, name, dty, (T, B), dev)
    for name, x in (("lc", lc), ("rd", rd), ("sqb", sqb)):
        _build.check(x, name, dty, (K, T, B), dev)
    for name, x in (("comp_old", comp_old), ("live", live),
                    ("zerob", zerob)):
        _build.check(x, name, i32, (T, B), dev)
    _build.check(gs, "gs", dty, (T, B, B), dev)
    _build.check(i2se, "i2se", dty, (T,), dev)
    dbeta = torch.empty((T, B), dtype=dty, device=dev)
    beta_new = torch.empty_like(dbeta)
    acum_new = torch.empty_like(dbeta)
    comp_new = torch.empty((T, B), dtype=i32, device=dev)
    _build.launch("wave_scan" + _build.SUFFIX[dty], base, None, lc, rd,
                  sqb, gs, beta_old, comp_old, acum_old, u, z, live, zerob,
                  None, i2se, dbeta, None, beta_new, comp_new, acum_new,
                  None, 0, 0, 0, T, B, K, wave, *plan)
    return dbeta, beta_new, comp_new, acum_new


class WaveScanSweep(ScanSweep):
    """Kernel 3 over a sweep's blocks (``ScanSweep``), kernel E on float64
    operands: the operands as for ``SerialScanSweep``, and the wave width.
    On CUDA tensors ``step`` takes an optional stamp buffer (2 + 2 B/W,)
    int64 that the launch fills (``wave_stamp_names``)."""

    def __init__(self, *operands, wave):
        self.wave = wave
        super().__init__(*operands)

    def _plan(self, T, B, K):
        if self.dtype not in _build.SUFFIX:
            raise ValueError(f"beta_p has dtype {self.dtype}: the wave scan "
                             f"takes float32 or float64")
        return launch_plan(T, B, K, self.wave, self.dtype.itemsize)

    def _plain(self, *args):
        return wave_scan_plain(*args, self.wave)

    def _launch(self, pc, pgs, b, bc, bg, stamps=None):
        nb, T, B, K = self.shape
        _build.launch("wave_scan" + _build.SUFFIX[self.dtype], pc,
                      *self.head, pgs, *self.tail, stamps, b, bc, bg, T, B,
                      K, self.wave, *self.plan)


def scan_masks(grp, valid, sigmag):
    """live (valid, group variance > 0) and zerob (valid, adaV-zeroed)
    masks, (T, B) int32."""
    adav = sigmag[:, grp] == 0.0
    live = valid[None, :] & ~adav
    zerob = valid[None, :] & adav
    return live.to(torch.int32), zerob.to(torch.int32)
