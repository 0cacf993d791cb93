"""The exact serial within-block scan (kernel 6).

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

Float64 (a ``--dtype float64`` run, kernel C): float64 operands launch
csrc/serial_scan_f64.cu instead, through the same two interfaces (one warp
per trait; K <= 16, B <= 512), the counterpart of the JAX package's XLA
``block_scan`` (gmrm_tpu/sampler/scan.py:33).  ``serial_scan_plain`` is
written for either dtype.

Limits on CUDA tensors: K <= 16 mixture components (4, 8 or 16 lanes a
trait), T <= 32 traits; 32 // lanes traits are drawn at once and more take
further passes over the warp.  ``scan_plan`` fits the block into the
227 KB of shared memory: the running correction (T B floats), the steps'
raw results (4 T B), the packed inputs of eight steps (8 KB), a ring of
Gram rows (a power of two of groups of 8, 4, 2 or 1 rows), and, while they
fit beside a ring of 16 rows, the block's state (9 T B words) and tables
(3 K T B); larger blocks leave the tables, or tables and state, in global
memory (the large-block branch, slower).  A block whose correction,
results and a few Gram rows exceed shared memory (about T B > 6,000)
raises ``ValueError``, as does any operand of the wrong device, dtype,
shape or layout.
"""

from __future__ import annotations

import torch

from gmrm_tpu_torch.ops import _build

MAX_K = 16     # mixture components (lanes of a trait)
MAX_T = 32     # traits (csrc MAX_T)
MAX_NG = 32    # ring groups (csrc MAX_NG)
NSTATE = 9     # staged (T, B) arrays (csrc NSTATE)
REC_SLOTS = 8  # steps of packed inputs in flight (csrc REC_SLOTS)
SMEM_BYTES = 232448   # dynamic shared memory of one CTA on the H100
F64_MAX_B = 512       # markers of a block in the float64 kernel (csrc)


def _al4(x: int) -> int:
    return (x + 3) & ~3


def _layout_words(T, B, K, mode, GR, NG) -> int:
    """Shared memory words of csrc/serial_scan.cu make_layout."""
    o = ((8 * (2 + 2 * MAX_NG) + 15) // 16 * 4 + 4 * MAX_T
         + REC_SLOTS * 32 * 8 + T * _al4(B) + 4 * T * B)
    if mode >= 1:
        o += NSTATE * _al4(T * B)
    if mode >= 2:
        o += 3 * _al4(K * T * B)
    return o + NG * GR * T * _al4(B)


def scan_plan(T: int, B: int, K: int):
    """(mode, GR, NG) of the kernel's shared memory, or None when the block
    does not fit.  mode 2 stages state and tables, 1 the state, 0 neither;
    the Gram streams through a ring of NG groups of GR rows, both powers of
    two.  Staging is taken while a ring of at least 16 rows (or all B - 1)
    fits beside it."""
    rows = max(B - 1, 1)
    for mode in (2, 1, 0):
        for GR in (8, 4, 2, 1):
            rest = SMEM_BYTES // 4 - _layout_words(T, B, K, mode, GR, 0)
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


def _plan_f64_or_raise(T, B, K):
    """The float64 kernel has no shared memory plan: its limits only."""
    if K > MAX_K:
        raise ValueError(f"K={K} mixture components exceed MAX_K={MAX_K}")
    if B > F64_MAX_B:
        raise ValueError(f"B={B} exceeds the float64 serial scan's "
                         f"{F64_MAX_B} markers a block")
    return ()


def _plan_or_raise(T, B, K):
    if K > MAX_K:
        raise ValueError(f"K={K} mixture components exceed MAX_K={MAX_K}")
    if T > MAX_T:
        raise ValueError(f"T={T} traits exceed MAX_T={MAX_T}")
    plan = scan_plan(T, B, K)
    if plan is None:
        raise ValueError(f"T={T}, B={B} exceed the serial scan's shared "
                         f"memory (about T*B <= 6,000)")
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
    plan = (_plan_f64_or_raise if f64 else _plan_or_raise)(T, B, K)
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
                  acum_new, 0, 0, 0, T, B, K, *plan)
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
        return _plan_or_raise(T, B, K)

    @staticmethod
    def _plain(*args):
        return serial_scan_plain(*args)

    def _launch(self, pc, pgs, b, bc, bg):
        nb, T, B, K = self.shape
        kernel = ("serial_scan_f64" if self.dtype == torch.float64
                  else "serial_scan")
        _build.launch(kernel, pc, *self.head, pgs, *self.tail, b, bc, bg, T,
                      B, K, *self.plan)
