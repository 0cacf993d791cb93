"""The exact serial within-block scan (kernel 6; kernel C at float64).

Port of the kernel of ``block_scan_pallas`` (gmrm_tpu/ops/scan_kernel.py:61):
the block's B markers are drawn one after the other, each against the
residual as left by every earlier marker of the block, through the
running correction ``corr[t, i] += gs[t, j, i] * dbeta[t, j]``.  This is
the reference's exact recursion (bayes.cpp:391-492), the W=1 case of the
sweep.

Two interfaces, one kernel (csrc/serial_scan.cu):

- ``serial_scan(base, ...)`` on one block's tensors, the public
  counterpart of the TPU kernel; the per-marker prep is in
  ``gmrm_tpu_torch.sampler.scan.block_scan``;
- ``SerialScanSweep``: the sweep's whole processing-order arrays
  ``(nb, ..., B)``, checked once, and a block index per step.  The kernel
  forms ``base = c + beta_old * (nonas - 1)`` itself, writes the block's
  results in place into ``(nb, T, B)`` arrays that the sweep scatters once,
  and also writes ``d = msig * dbeta``, the operand of the residual update.

CUDA tensors launch the kernel; CPU tensors run ``serial_scan_plain``.

Float64 (a ``--dtype float64`` run, kernel C): float64 operands launch the
same kernel's double instance, through the same two interfaces, the
counterpart of the JAX package's XLA ``block_scan``
(gmrm_tpu/sampler/scan.py:33).  ``serial_scan_plain`` is written for
either dtype.

Any number K of mixture components on CUDA tensors: a trait takes 4, 8
or 16 lanes of the scanning warp for K <= 4, 8, 16, and all 32 for any
larger K (``lanes_of``), whose draw keeps L and s of a step in a scratch
of 2 K values of shared memory.  ``scan_plan`` fits a CTA's traits into
the 227 KB of shared memory, in values of the dtype's size: the running
correction (T B values), the steps' raw results (4 T B), the packed
inputs of eight steps (8 KB in float, 16 in double), a ring of Gram rows
(a power of two of groups of 8, 4, 2 or 1 rows), that scratch past 16
components, and, while they fit beside a ring of 16 rows, the block's
state (9 T B) and tables (3 K T B); larger blocks, and tables of many
components, stay in global memory (the large-block branch, slower).
Float32: one CTA takes every trait while it holds them (T <= 32 and about
T B <= 6,000); 32 // lanes traits are drawn at once and more take further
passes over the warp.  Where one CTA cannot hold them, past 16
components (one trait a pass: its traits' chains then run side by side)
while B <= 512, and always at float64 (``f64_plan``), the launch is a grid
of trait groups (``group_plan``; ``launch_plan`` chooses): T <= 65,535 and
B <= 512; a CTA takes at most one pass of traits, as many as fit (about
T B <= 6,000 in float, 3,000 in double), and the grid the rest, so every
such block runs.  Any operand of the wrong device, dtype, shape or layout
raises ``ValueError``.
"""

from __future__ import annotations

import torch

from gmrm_tpu_torch.ops import _build

LANE_K = 16    # components of the instances of a lane a component
               # (csrc GMRM_MAX_K); past it a trait takes all 32 lanes
MAX_T = 32     # traits of a CTA (csrc MAX_T)
MAX_NG = 32    # ring groups (csrc MAX_NG)
NSTATE = 9     # staged (T, B) arrays (csrc NSTATE)
REC_SLOTS = 8  # steps of packed inputs in flight (csrc REC_SLOTS)
SMEM_BYTES = 232448   # dynamic shared memory of one CTA on the H100
F64_MAX_B = 512       # markers of a block in a launch of trait groups
F64_MAX_T = 65535     # traits of such a launch, over its CTAs (csrc; every
                      # float64 launch is one)
# A stamped launch's buffer (stamps=, int64): %globaltimer at the chain's
# start and end, its SM cycles, the cycles of each phase of a step summed
# over the block's steps (SCAN_PHASES), then the steps whose scan waited
# for its helper warp and those waits' cycles, and the same for the Gram
# ring's groups.
SCAN_PHASES = ("inputs", "L", "exp", "rcp", "comp", "dbeta", "handoff")
SCAN_STAMPS = ("start_ns", "end_ns", "cycles", *SCAN_PHASES, "helper_waits",
               "helper_wait_cycles", "ring_waits", "ring_wait_cycles")


def scan_stamp_summary(stamps, steps: int) -> dict:
    """A stamped sweep's launches, from their (launches, len(SCAN_STAMPS))
    int64 stamps on the host, ``steps`` steps (markers) a launch, summed
    over the launches: ``chain_ns`` (end_ns - start_ns), ``cycles`` and
    ``steps``, ``cycles_per_step``, ``phases`` (each of ``SCAN_PHASES``'
    cycles), and the helper and ring waits and their cycles."""
    rows = stamps.reshape(-1, len(SCAN_STAMPS))
    v = dict(zip(SCAN_STAMPS, rows.sum(dim=0).tolist()))
    n = rows.shape[0] * steps
    return {"chain_ns": v["end_ns"] - v["start_ns"], "cycles": v["cycles"],
            "steps": n, "cycles_per_step": v["cycles"] / n,
            "phases": {k: v[k] for k in SCAN_PHASES},
            **{k: v[k] for k in SCAN_STAMPS[3 + len(SCAN_PHASES):]}}


def _al4(x: int) -> int:
    return (x + 3) & ~3


def _layout_words(T, B, K, mode, GR, NG, es=4) -> int:
    """Shared memory of csrc/serial_scan.cu scan_words (its make_layout,
    and past 16 components the draw's scratch), in values of es bytes (4:
    float, 8: double)."""
    o = ((8 * (2 + 2 * MAX_NG) + 15) // 16 * (16 // es) + 2 * MAX_T * 4 // es
         + 2 * MAX_T + REC_SLOTS * 32 * 8 + T * _al4(B) + 4 * T * B)
    if mode >= 1:
        o += NSTATE * _al4(T * B)
    if mode >= 2:
        o += 3 * _al4(K * T * B)
    if K > LANE_K:
        o += 2 * _al4(K)
    return o + NG * GR * T * _al4(B)


def scan_plan(T: int, B: int, K: int, es: int = 4):
    """(mode, GR, NG) of one CTA's shared memory for T traits at values of
    es bytes, or None when the block does not fit.  mode 2 stages state
    and tables, 1 the state, 0 neither; the Gram streams through a ring of
    NG groups of GR rows, both powers of two.  Staging is taken while a
    ring of at least 16 rows (or all B - 1) fits beside it."""
    rows = max(B - 1, 1)
    for mode in (2, 1, 0):
        for GR in (8, 4, 2, 1):
            rest = (SMEM_BYTES // es
                    - _layout_words(T, B, K, mode, GR, 0, es))
            fit = min(MAX_NG, rest // (GR * T * _al4(B)))
            if fit < 1:
                continue
            need = 1 << (-(-rows // GR) - 1).bit_length()   # holds all rows
            NG = need if need <= fit else 1 << (fit.bit_length() - 1)
            held = NG * GR
            # The scan holds rows j-2 .. j while the next group loads.
            if held >= rows or (NG >= (2 if GR > 1 else 4)
                                and (mode == 0 or held >= 16)):
                return mode, GR, NG
    return None


def lanes_of(K: int) -> int:
    """Lanes of the scanning warp a trait takes (csrc MAXK): one a
    component up to 16 components, and every lane past that."""
    return 4 if K <= 4 else 8 if K <= 8 else 16 if K <= LANE_K else 32


def group_plan(T: int, B: int, K: int, es: int = 4):
    """(mode, GR, NG, TG) of a grid of trait groups at ``es``-byte values:
    TG traits a CTA, at most one pass over the lanes (32 // lanes_of(K),
    and no more than T), the most among those whose block a CTA stages
    furthest (``scan_plan``'s mode: the CTAs run side by side, and a staged
    block keeps the helpers' reads in shared memory); ceil(T / TG) CTAs.
    None when not even one trait fits."""
    plans = [(*plan, tg) for tg in range(1, min(T, 32 // lanes_of(K)) + 1)
             if (plan := scan_plan(tg, B, K, es)) is not None]
    return max(plans, key=lambda p: (p[0], p[3]), default=None)


def launch_plan(T: int, B: int, K: int, es: int = 4):
    """(mode, GR, NG, TG) of a launch at T traits and ``es``-byte values:
    at float32 one CTA of all of them (TG = T) where it holds them (T <=
    MAX_T and ``scan_plan``), else, and always at float64, a grid of trait
    groups (``group_plan``).  Past 16 components, where a trait takes a
    pass of the warp, the grid of one trait a CTA whenever it runs (B <=
    512), so that the traits' chains run side by side.  None when not even
    one trait fits."""
    wide = lanes_of(K) == 32 and B <= F64_MAX_B
    if es == 4 and T <= MAX_T and not wide:
        plan = scan_plan(T, B, K)
        if plan is not None:
            return (*plan, T)
    return group_plan(T, B, K, es)


def f64_plan(T: int, B: int, K: int):
    """The float64 kernel's plan: always a grid of trait groups
    (``group_plan`` at 8-byte values)."""
    return group_plan(T, B, K, 8)


def _plan_f64_or_raise(T, B, K):
    if B > F64_MAX_B:
        raise ValueError(f"B={B} exceeds the float64 serial scan's "
                         f"{F64_MAX_B} markers a block")
    if T > F64_MAX_T:
        raise ValueError(f"T={T} traits exceed the float64 serial scan's "
                         f"{F64_MAX_T}")
    plan = f64_plan(T, B, K)
    if plan is None:
        raise ValueError(f"B={B}, K={K}: one trait exceeds the float64 "
                         f"serial scan's shared memory")
    return plan


def _plan_or_raise(T, B, K):
    """The plan of one float32 CTA of all T traits, or ``ValueError``."""
    if T > MAX_T:
        raise ValueError(f"T={T} traits exceed MAX_T={MAX_T}")
    plan = scan_plan(T, B, K)
    if plan is None:
        raise ValueError(f"T={T}, B={B} exceed the serial scan's shared "
                         f"memory (about T*B <= 6,000)")
    return plan


def _plan_f32_or_raise(T, B, K):
    """``launch_plan`` of a float32 launch, or ``ValueError``."""
    plan = launch_plan(T, B, K)
    if plan is not None and plan[3] == T:
        return plan
    if B > F64_MAX_B or T > F64_MAX_T:
        raise ValueError(f"T={T}, B={B}: one CTA cannot hold the traits, "
                         f"and a grid of trait groups takes B <= "
                         f"{F64_MAX_B} and T <= {F64_MAX_T}")
    if plan is None:
        raise ValueError(f"B={B}, K={K}: one trait exceeds the serial "
                         f"scan's shared memory")
    return plan


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
    """Kernel 6 (kernel C at float64) on one block.

    base/beta_old/acum_old/u/z (T, B) float32; lc/rd/sqb (K, T, B) float32
    per-marker tables; gs (T, B, B) float32 scaled Gram in processing
    order; comp_old/live/zerob (T, B) int32; i2se (T,) = 1/(2 sigmaE).
    Every float operand float64 at float64.  Returns (dbeta, beta_new,
    comp_new, acum_new), each (T, B).
    """
    if base.device.type == "cpu":
        return serial_scan_plain(base, lc, rd, sqb, gs, beta_old, comp_old,
                                 acum_old, u, z, live, zerob, i2se)
    T, B = base.shape
    K = lc.shape[0]
    dty, i32 = base.dtype, torch.int32
    f64 = dty == torch.float64
    if dty not in (torch.float32, torch.float64):
        raise ValueError(f"base has dtype {dty}: the serial scan takes "
                         f"float32 or float64")
    plan = (_plan_f64_or_raise if f64 else _plan_f32_or_raise)(T, B, K)
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
    _build.launch("serial_scan_f64" if f64 else "serial_scan", base, None,
                  lc, rd, sqb, gs, beta_old, comp_old, acum_old, u, z, live,
                  zerob, None, i2se, dbeta, None, beta_new, comp_new,
                  acum_new, None, 0, 0, 0, T, B, K, *plan)
    return dbeta, beta_new, comp_new, acum_new


class ScanSweep:
    """A scan kernel over a sweep's blocks: the processing-order operands of
    all ``nb`` blocks, checked once, then one launch per block step.

    nm1 (T,) = nonas - 1; lc_p/rd_p/sqb_p (nb, K, T, B) per-marker tables;
    beta_p/acum_p/u_all/z_all/msig_p (nb, T, B) float32; comp_p/live_p/
    zerob_p (nb, T, B) int32; i2se (T,) = 1/(2 sigmaE); every float
    operand in the dtype of beta_p (float32, or float64 for the float64
    kernel where the subclass has one).  The results of
    block ``b`` land in ``dbeta[b]``, ``d[b]`` (= msig * dbeta),
    ``beta_new[b]``, ``comp_new[b]`` and ``acum_new[b]``.  A subclass names
    its kernel's plan (``_plan``), plain version (``_plain``) and launch
    (``_launch``).
    """

    def __init__(self, nm1, lc_p, rd_p, sqb_p, beta_p, comp_p, acum_p,
                 u_all, z_all, live_p, zerob_p, msig_p, i2se):
        nb, K, T, B = lc_p.shape
        dev = beta_p.device
        dty, i32 = beta_p.dtype, torch.int32
        self.dtype = dty
        self.shape = (nb, T, B, K)
        self.cuda = dev.type != "cpu"
        if self.cuda:
            self.plan = self._plan(T, B, K)
            for name, x in (("beta_p", beta_p), ("acum_p", acum_p),
                            ("u_all", u_all), ("z_all", z_all),
                            ("msig_p", msig_p)):
                _build.check(x, name, dty, (nb, T, B), dev)
            for name, x in (("lc_p", lc_p), ("rd_p", rd_p),
                            ("sqb_p", sqb_p)):
                _build.check(x, name, dty, (nb, K, T, B), dev)
            for name, x in (("comp_p", comp_p), ("live_p", live_p),
                            ("zerob_p", zerob_p)):
                _build.check(x, name, i32, (nb, T, B), dev)
            _build.check(nm1, "nm1", dty, (T,), dev)
            _build.check(i2se, "i2se", dty, (T,), dev)
        self.nm1, self.i2se = nm1, i2se
        self.tables = (lc_p, rd_p, sqb_p)
        self.state = (beta_p, comp_p, acum_p, u_all, z_all, live_p, zerob_p)
        self.msig_p = msig_p
        self.dbeta = torch.empty((nb, T, B), dtype=dty, device=dev)
        self.d = torch.empty_like(self.dbeta)
        self.beta_new = torch.empty_like(self.dbeta)
        self.acum_new = torch.empty_like(self.dbeta)
        self.comp_new = torch.empty((nb, T, B), dtype=i32, device=dev)
        if self.cuda:
            # The launch's arguments but c (first) and gs (sixth), as
            # addresses: a block step does no tensor work on the host.
            self.head = [x.data_ptr() for x in (nm1, lc_p, rd_p, sqb_p)]
            self.tail = [x.data_ptr() for x in (
                beta_p, comp_p, acum_p, u_all, z_all, live_p, zerob_p,
                msig_p, i2se, self.dbeta, self.d, self.beta_new,
                self.comp_new, self.acum_new)]
            self.seen = {}

    def step(self, b, c, gs, bg, bc=0, **launch_kw):
        """Scan block ``b`` with the residual dot products ``c[bc]`` (``c``
        is (nc, T, B)) against Gram ``bg`` of the run ``gs``
        (nr, T, B, B)."""
        nb, T, B, K = self.shape
        beta_p = self.state[0]
        if not self.cuda:
            base = c[bc] + beta_p[b] * self.nm1[:, None]
            out = self._plain(
                base, *(x[b] for x in self.tables), gs[bg],
                *(x[b] for x in self.state), self.i2se)
            self.dbeta[b], self.beta_new[b] = out[0], out[1]
            self.comp_new[b], self.acum_new[b] = out[2], out[3]
            self.d[b] = self.msig_p[b] * out[0]
            return
        if not (0 <= b < nb and 0 <= bg < gs.shape[0]
                and 0 <= bc < c.shape[0]):
            raise ValueError(f"block {b} of {nb}, Gram {bg} of "
                             f"{gs.shape[0]}, c {bc} of {c.shape[0]}")
        dev, dty = self.dbeta.device, self.dtype
        pc = _build.check_once(self.seen, c, "c", dty, (c.shape[0], T, B),
                               dev)
        pgs = _build.check_once(self.seen, gs, "gs", dty,
                                (gs.shape[0], T, B, B), dev)
        self._launch(pc, pgs, b, bc, bg, **launch_kw)


class SerialScanSweep(ScanSweep):
    """Kernel 6 over a sweep's blocks (``ScanSweep``); kernel C on float64
    operands."""

    def _plan(self, T, B, K):
        if self.dtype == torch.float64:
            return _plan_f64_or_raise(T, B, K)
        if self.dtype != torch.float32:
            raise ValueError(f"beta_p has dtype {self.dtype}: the serial "
                             f"scan takes float32 or float64")
        return _plan_f32_or_raise(T, B, K)

    @staticmethod
    def _plain(*args):
        return serial_scan_plain(*args)

    def stampable(self) -> bool:
        """Whether the launches take ``stamps``: on the card, at K = 4 and
        one pass over the lanes of a CTA."""
        return self.cuda and self.shape[3] == 4 and self.plan[3] * 4 <= 32

    def _launch(self, pc, pgs, b, bc, bg, stamps=None):
        """``stamps``: an int64 (len(SCAN_STAMPS),) buffer, or its address,
        that one launch fills (``stampable`` only; CTA 0's chain)."""
        nb, T, B, K = self.shape
        kernel = ("serial_scan_f64" if self.dtype == torch.float64
                  else "serial_scan")
        _build.launch(kernel, pc, *self.head, pgs, *self.tail, stamps, b, bc,
                      bg, T, B, K, *self.plan)
