"""The one-time Gram cache (kernel 1), the group-level scan tables, the
whole-sweep kernel of wave mode (kernels 7 and 8) and the block-step
kernel of the marker-sharded sweep (kernel 9).

Port of ``build_gram_cache`` (gmrm_tpu/ops/sweep_kernel.py:1259),
``build_sweep_tables`` (:918), ``sweep_blocks_pallas`` (:839) and
``block_sweep_pallas`` (:1104).  The
cache holds, per natural block of B markers, the raw NA-masked Gram
quadrants of ``[A; B]``; X never changes and block membership is fixed
under the block-preserving shuffle, so the sweep only gathers and scales
it.  ``sweep_blocks`` runs one whole sweep per launch
(csrc/sweep_blocks.cu); one kernel serves both of the JAX package's
regimes, the resident ``_sweep_kernel`` and the N-tiled
``_sweep_kernel_tiled``.  ``ShardedBlockSweep`` runs one block step of all
of a process's shards per launch (csrc/block_sweep.cu), every shard against
the one residual, and sums their deltas in shard order: into the residual
itself, or into an output that the caller sums over processes;
``block_sweep`` is its one-shard, one-block case with the delta as the
output.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
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


GMMA_TILE = 128   # markers per side of a tensor-core Gram tile (csrc)
GRID_MAX = 65535  # grid.y and grid.z of a launch


def gram_cache_grid(B: int, nblocks: int, nt: int) -> tuple:
    """The launch grid of kernel 1: one CTA per 128 x 128 tile of each of
    the three quadrants g1, g2t, g3, per mask and per block.  Raises
    ``ValueError`` past the grid's 65535 blocks or masks."""
    if nblocks > GRID_MAX or nt > GRID_MAX:
        raise ValueError(f"{nblocks} blocks or {nt} masks exceed the "
                         f"kernel's grid limit of {GRID_MAX}")
    ntile = -(-B // GMMA_TILE)
    return (3 * ntile * ntile, nt, nblocks)


def build_gram_cache(bed: torch.Tensor, na: torch.Tensor, *,
                     block_size: int, shared_na: bool) -> torch.Tensor:
    """Raw Gram quadrants of every natural block.

    bed (m_pad, mb_pad) uint8 in natural (storage) order; na (T, 4, mb_pad)
    0/1 float32.  NT = 1 when no phenotype has NAs (``shared_na``), else T.
    Returns (nblocks, NT, 2B, 2B) float32, bit-equal to the JAX builder.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (csrc/gram_cache.cu: the int8 tensor cores, three quadrants a block
    and mask, ``gram_cache_grid``).
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
    gram_cache_grid(B, nblocks, nt)
    _build.check(bed, "bed", torch.uint8, (m_pad, mb), bed.device)
    _build.check(na_in, "na", torch.float32, (nt, 4, mb), bed.device)
    out = torch.empty((nblocks, nt, 2 * B, 2 * B), dtype=torch.float32,
                      device=bed.device)
    _build.launch("gram_cache", bed, na_in, out, nblocks, B, mb, nt)
    return out


def build_sweep_tables(sigmag, sigmae, pi_est, cva, cvai, nonas, n_total,
                       dtype=torch.float32):
    """Group-level scan tables (K, T, G): lc, rd, sqb, in ``dtype``
    (float64 on a float64 run's W = 1 sweep).

    The per-marker prep of scan_kernel_wave.py:204-239 depends on a marker
    only through its group, so it is computed per group once per sweep
    and gathered per block (exact copies).  ``logl_k = lc_k + q rd_k``
    with q = num^2/(2 sigmaE); ``sqb_k`` is the slab's posterior sd.
    """
    dty = dtype
    T = sigmag.shape[0]
    G = cva.shape[0]
    sigmae_f = sigmae.to(dty)[:, None]                      # (T, 1)
    nonas_f = nonas.to(dty)[:, None]
    n_total_f = torch.as_tensor(n_total, dtype=dty, device=sigmag.device)

    sg = sigmag.to(dty)                                     # (T, G)
    adav = sg == 0.0
    sg_safe = torch.where(adav, torch.ones_like(sg), sg)
    sige_g = sigmae_f / sg_safe
    sigg_e = sg_safe / sigmae_f

    cvai_b = cvai.to(dty)[:, 1:]                            # (G, K-1)
    cva_b = cva.to(dty)[:, 1:]
    denom = (n_total_f - 1.0) + sige_g[:, :, None] * cvai_b[None]
    zeros0 = torch.zeros((T, G, 1), dtype=dty, device=sigmag.device)
    rd = torch.cat([zeros0, 1.0 / denom], dim=2)            # (T, G, K)
    sqb = torch.cat([zeros0, torch.sqrt(sigmae_f[:, :, None] / denom)],
                    dim=2)

    lc = torch.log(pi_est.to(dty))                          # (T, G, K)
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
    """The grid, shared-memory residency and scratch the sweep kernel uses
    at these shapes on the current card (csrc/sweep_blocks.cu
    ``plan_sweep``): one CTA per SM, the first for the scans and the others
    with ``cols`` byte columns each; the scan's per-marker tables and scaled
    Gram, then eps, then na, then the bed slice stay in shared memory while
    they fit.  Launches nothing."""
    out = (ctypes.c_int * 7)()
    err = _build.library().gmrm_sweep_blocks_plan(
        T, B, mb, nt, K, wave, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(
            f"the sweep kernel cannot run at T={T}, B={B}, mb={mb}, NT={nt}, "
            f"K={K}, W={wave}: {_build.error_string(err)}")
    grid, cols, flags, smem, eps_bytes, gs_floats, scratch = out
    return {"grid": grid, "cols": cols, "smem_bytes": smem,
            "eps_bytes_per_cta": eps_bytes, "gs_floats": gs_floats,
            "scratch_bytes": scratch,
            "resident": [name for bit, name in (
                (8, "scan tables"), (16, "scaled Gram"), (1, "eps"),
                (2, "na"), (4, "bed slice")) if flags & bit]}


# The %globaltimer events the sweep kernel records per CTA and block when
# it is given a stamp buffer, as the names of the intervals between them:
# CTA 0 (the scans) and the column CTAs.
SWEEP_STAMPS = {
    "scan": ("wait for the partials", "sum of the groups' partials, c and "
             "base", "wave 1: draw", "wave 1: fold", "the later waves",
             "next block's operands"),
    "column": ("update of the block before, all waves but the last "
               "(overlaps the scan)", "update of its last wave, wait "
               "included", "A: partial sums", "A: partials combined and "
               "published", "group sum (the last CTA of its group)",
               "stage and Gram of the next block"),
}
# The chain from one scan to the next as events of SWEEP_STAMPS: (role,
# block offset, event, what has happened by then); a column event is taken
# at the last column CTA to reach it.  A column CTA's step b + 1 updates
# eps with block b and publishes the partials of block b + 1.
SWEEP_CHAIN = (("scan", 0, 5, "CTA 0 has published the last wave"),
               ("column", 1, 2, "every column CTA has updated eps"),
               ("column", 1, 4, "every column CTA has published partials"),
               ("column", 1, 5, "every group's sum is published"),
               ("scan", 1, 1, "CTA 0 has seen them all"),
               ("scan", 1, 2, "c and base"),
               ("scan", 1, 5, "CTA 0 has published the next last wave"))
NST = 8


class SweepBlocks:
    """Kernels 7 and 8 as a callable with the arguments of
    :func:`sweep_blocks`, for a caller that sweeps again and again with the
    same tensors: each operand is checked when it is first seen under its
    name (``_build.check_once``) and the kernel's scratch is kept, so that
    a call costs the host one launch.  CPU tensors take the plain
    version."""

    def __init__(self):
        self.seen = {}
        self.scratch = None

    def __call__(self, bed, blkidx, win_p, m_local, gram_cache, eps, na,
                 mave, msig, beta_old, comp_old, acum_old, grp, u_p, z_p,
                 sigmag, lc, rd, sqb, i2se, nonas, *, wave, out=None,
                 stamps=None):
        nblocks, B = win_p.shape
        T, m_pad = beta_old.shape
        nt = gram_cache.shape[1]
        if wave < 2 or B % wave:
            raise ValueError(f"wave {wave} must be > 1 and divide B={B}")
        if nt not in (1, T) or na.shape[0] != nt:
            raise ValueError(f"gram_cache has {nt} masks and na "
                             f"{na.shape[0]}; expected both 1 or both T={T}")
        if bed.device.type == "cpu":
            res = sweep_blocks_plain(
                bed, blkidx, win_p, m_local, gram_cache, eps, na, mave, msig,
                beta_old, comp_old, acum_old, grp, u_p, z_p, sigmag, lc, rd,
                sqb, i2se, nonas, wave=wave)
            if out is None:
                return res
            for o, x in zip(out, res[1:]):
                o.copy_(x)
            return (res[0], *out)
        dev = bed.device
        mb = bed.shape[1]
        K, _, G = lc.shape
        if T > MAX_T or K > MAX_K:
            raise ValueError(f"T={T}, K={K} exceed the kernel's "
                             f"MAX_T={MAX_T}, MAX_K={MAX_K}")
        if m_pad >= 2 ** 31:
            raise ValueError(f"{m_pad} marker slots exceed the kernel's "
                             f"int32 row index")
        f32, i32 = torch.float32, torch.int32
        if out is None:
            out = (torch.empty_like(beta_old), torch.empty_like(comp_old),
                   torch.empty_like(acum_old))
        tb = (T, m_pad)
        seen = self.seen
        grp = grp.to(i32)          # kept alive until the launch is queued

        def ptr(x, name, dtype, shape):
            return _build.check_once(seen, x, name, dtype, shape, dev)

        ptrs = [
            ptr(bed, "bed", torch.uint8, (nblocks * B, mb)),
            ptr(blkidx, "blkidx", i32, (nblocks,)),
            ptr(win_p, "win_p", i32, (nblocks, B)),
            ptr(gram_cache, "gram_cache", f32, (nblocks, nt, 2 * B, 2 * B)),
            ptr(eps, "eps", f32, (T, 4, mb)),
            ptr(na, "na", f32, (nt, 4, mb)),
            ptr(mave, "mave", f32, tb), ptr(msig, "msig", f32, tb),
            ptr(beta_old, "beta_old", f32, tb),
            ptr(comp_old, "comp_old", i32, tb),
            ptr(acum_old, "acum_old", f32, tb),
            ptr(grp, "grp", i32, (m_pad,)),
            ptr(u_p, "u_p", f32, (nblocks, T, B)),
            ptr(z_p, "z_p", f32, (nblocks, T, B)),
            ptr(sigmag, "sigmag", f32, (T, G)),
            ptr(lc, "lc", f32, (K, T, G)), ptr(rd, "rd", f32, (K, T, G)),
            ptr(sqb, "sqb", f32, (K, T, G)),
            ptr(i2se, "i2se", f32, (T,)), ptr(nonas, "nonas", f32, (T,)),
            ptr(out[0], "beta_new", f32, tb),
            ptr(out[1], "comp_new", i32, tb),
            ptr(out[2], "acum_new", f32, tb)]
        plan = sweep_plan(T, B, mb, nt, K, wave)
        words = plan["scratch_bytes"] // 4
        if (self.scratch is None or self.scratch.device != dev
                or self.scratch.numel() < words):
            self.scratch = torch.empty((words,), dtype=f32, device=dev)
        if stamps is not None:
            _build.check(stamps, "stamps", torch.int64,
                         (plan["grid"], nblocks + 1, NST), dev)
        _build.launch("sweep_blocks", *ptrs, self.scratch,
                      0 if stamps is None else stamps, nblocks, T, B, mb, nt,
                      K, wave, G, int(m_local))
        return (eps, *out)


def sweep_blocks(bed, blkidx, win_p, m_local, gram_cache, eps, na,
                 mave, msig, beta_old, comp_old, acum_old, grp,
                 u_p, z_p, sigmag, lc, rd, sqb, i2se, nonas, *, wave,
                 out=None, stamps=None):
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
    (T, m_pad) in natural order, new tensors or, with ``out``, the three
    tensors of ``out``, which may be beta_old, comp_old and acum_old
    themselves.  CPU tensors take the plain version; CUDA tensors launch
    the kernel.

    ``stamps``, for measurement only: an int64 tensor (grid, nblocks + 1,
    NST) into which every CTA records the global timer (ns) at the events
    of ``SWEEP_STAMPS``, row b + 1 for block b.
    """
    return SweepBlocks()(bed, blkidx, win_p, m_local, gram_cache, eps, na,
                         mave, msig, beta_old, comp_old, acum_old, grp, u_p,
                         z_p, sigmag, lc, rd, sqb, i2se, nonas, wave=wave,
                         out=out, stamps=stamps)


def _block_scalar(x, device):
    """A block id or marker count as a (1,) int32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([int(x)], dtype=torch.int32, device=device)


def block_sweep_plain(blk_b, m_local, bed_blk, win_blk, gfull_blk, eps, na,
                      mave_blk, msig_blk, beta_blk, comp_blk, acum_blk,
                      grp_blk, u_blk, z_blk, sigmag, lc_tab, rd_tab, sqb_tab,
                      i2se, nonas, *, wave):
    """Plain PyTorch version of kernel 9; operands as in
    :func:`block_sweep`.  It runs the plain versions of kernels 2, 3 and 4
    on the block, the update into a zero delta."""
    from gmrm_tpu_torch.ops.block_gram import scale_gram
    from gmrm_tpu_torch.ops.block_kernels import (
        block_cdot_plain, block_eps_update_plain_,
    )
    from gmrm_tpu_torch.ops.scan_kernel_wave import (
        scan_masks, wave_scan_plain,
    )
    B = win_blk.shape[-1]
    T = eps.shape[0]
    nb = bed_blk.shape[0] // B
    nt = gfull_blk.shape[1]
    dev = eps.device
    blk = _block_scalar(blk_b, dev).long()                  # (1,)
    m_loc = _block_scalar(m_local, dev).long()
    win = win_blk.reshape(B).long()
    rows = win + (blk * B if nb > 1 else 0)                 # operand slots
    g = grp_blk.long()[rows]
    mave_b = mave_blk[:, rows]
    msig_b = msig_blk[:, rows]
    beta_b = beta_blk[:, rows]
    live, zerob = scan_masks(g, blk * B + win < m_loc, sigmag)
    c = block_cdot_plain(bed_blk, rows, eps, mave_b, msig_b)
    win2 = torch.cat([win, win + B])
    gf = gfull_blk.index_select(0, blk if nb > 1 else blk * 0)[0]
    gs = scale_gram(gf.index_select(1, win2).index_select(2, win2),
                    mave_b, msig_b)
    nm1 = nonas.to(torch.float32).reshape(T, 1) - 1.0
    dbeta, bn, cn, an = wave_scan_plain(
        c + beta_b * nm1, lc_tab[:, :, g], rd_tab[:, :, g], sqb_tab[:, :, g],
        gs, beta_b, comp_blk[:, rows], acum_blk[:, rows],
        u_blk.reshape(T, B), z_blk.reshape(T, B), live, zerob,
        i2se.reshape(T), wave)
    deps = block_eps_update_plain_(bed_blk, rows, msig_b * dbeta, mave_b,
                                   na[:nt], torch.zeros_like(eps))
    for out, new in zip((beta_blk, comp_blk, acum_blk), (bn, cn, an)):
        out[:, rows] = new
    return deps, beta_blk, comp_blk, acum_blk


class ShardOperands(NamedTuple):
    """One shard's operands of kernel 9 for a whole sweep.  The per-marker
    arrays are in natural order over the nb*B marker slots of the operands
    (nb >= 1; with nb = 1 they are one block's own slices and the kernel
    takes block 0 of them, with nb > 1 block ``blk[b]``)."""
    blk: torch.Tensor       # (nblocks,) int32 natural block of each step
    win: torch.Tensor       # (nblocks, B) int32 row order of each step
    m_local: object         # the real marker count: an int, or a (1,)
                            # int32 tensor read on the device
    bed: torch.Tensor       # (nb*B, mb) uint8
    gram: torch.Tensor      # (nb, NT, 2B, 2B) float32
    mave: torch.Tensor      # (T, nb*B) float32, as msig
    msig: torch.Tensor
    beta: torch.Tensor      # (T, nb*B) float32, updated IN PLACE, as comp
    comp: torch.Tensor      # (int32) and acum
    acum: torch.Tensor
    grp: torch.Tensor       # (nb*B,) int32
    u: torch.Tensor         # (nblocks, T, B) float32 processing order
    z: torch.Tensor


def block_sweep_shards_plain(b, shards, eps, na, sigmag, lc_tab, rd_tab,
                             sqb_tab, i2se, nonas, *, wave, prev=None,
                             out=None):
    """Plain PyTorch version of one launch of kernel 9: block step ``b`` of
    every shard of ``shards`` (:class:`ShardOperands`) against ``eps``,
    each by :func:`block_sweep_plain`, the shards' deltas summed in shard
    order, onto ``prev`` when it is given (the sum of the shards before
    them).  ``out`` None adds the sum into ``eps`` IN PLACE and returns
    eps; otherwise the sum is written into ``out``, which is returned."""
    total = prev
    for s in shards:
        d = block_sweep_plain(
            s.blk[b:b + 1], s.m_local, s.bed, s.win[b], s.gram, eps, na,
            s.mave, s.msig, s.beta, s.comp, s.acum, s.grp, s.u[b], s.z[b],
            sigmag, lc_tab, rd_tab, sqb_tab, i2se, nonas, wave=wave)[0]
        total = d if total is None else total + d
    if out is None:
        eps += total
        return eps
    out.copy_(total)
    return out


MAX_SHARDS = 16   # shards one launch takes at most (csrc MAX_SHARDS)
ACCUMULATE, IN_PLACE = 1, 2   # launch modes (csrc)


@functools.lru_cache(maxsize=None)
def block_sweep_plan(T: int, B: int, mb: int, nt: int, K: int, wave: int,
                     shards: int = 1) -> dict:
    """How kernel 9 runs a block step of ``shards`` shards at these shapes
    on the current card (csrc/block_sweep.cu ``plan_step``): the shards a
    launch takes (``cap``, at least 1 at any width), the byte columns a
    column CTA owns (``span``) and stages at a time (``cols``; ``tiles``
    of them make a span, more than one only on a wide panel), the grid of
    a full launch (one scan CTA per shard and the column CTAs), its shared
    memory and the scratch words per shard.  Launches nothing."""
    out = (ctypes.c_int * 9)()
    err = _build.library().gmrm_block_sweep_plan(
        T, B, mb, nt, K, wave, shards, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(
            f"the sharded block-step kernel cannot run at T={T}, B={B}, "
            f"mb={mb}, NT={nt}, K={K}, W={wave}: "
            f"{_build.error_string(err)}")
    cap, cols, ncol, flags, smem, groups, gs_tot, slot, span = out
    if cap == 0:
        raise RuntimeError(
            f"the sharded block-step kernel finds no resident grid for "
            f"{shards} shards at T={T}, B={B}, mb={mb}, NT={nt}, K={K}, "
            f"W={wave}")
    return {"cap": cap, "cols": cols, "span": span,
            "tiles": -(-span // cols), "column_ctas": ncol,
            "grid": ncol + cap, "smem_bytes": smem, "groups": groups,
            "gs_tot": gs_tot, "slot_words": slot,
            "resident": [name for bit, name in ((1, "scaled Gram"),
                                                (2, "scan tables"))
                         if flags & bit]}


# The %globaltimer events kernel 9 records per CTA when it is given a stamp
# buffer, as the names of the intervals between them: the scan CTAs (one
# per shard, the first CTAs of the grid) and the column CTAs.
BLOCK_STEP_STAMPS = {
    "scan": ("marker state and draws",
             "a dry run of a wave, then the wait for the groups' sums",
             "c and base", "wave 1 drawn",
             "the later waves, the wait for the scaled Gram and its copy "
             "included"),
    "column": ("staged", "c-dot partials and tickets",
               "share of the scaled Grams, a dry pass, then the first wave "
               "of every shard, waits included",
               "the later waves, waits included",
               "the shards summed and written"),
}
BS_NST = 6


class ShardedBlockSweep:
    """Kernel 9 over a process's local shards: :meth:`sweep` takes the
    shards' operands once per sweep, checks each (``_build.check_once``:
    the operands that stay from sweep to sweep are checked once) and builds
    the table of their addresses; :meth:`step` runs one block step of all
    of them, one launch when the shards fit one grid (``MAX_SHARDS`` and
    ``block_sweep_plan``'s ``cap``), else launches of consecutive shards,
    each after the first adding onto the sum of those before.  The scratch
    (counters and the tree's partials, zeroed once; every launch leaves it
    zeroed) is kept from sweep to sweep of one object.  CPU tensors take
    the plain version, launch for launch."""

    def __init__(self):
        self.seen = {}
        self.scratch = None
        self.key = None
        self.shards = None

    def sweep(self, shards, eps, na, sigmag, lc_tab, rd_tab, sqb_tab, i2se,
              nonas, *, wave):
        """The sweep's operands: ``shards`` a list of
        :class:`ShardOperands`, one per local shard in shard order, every
        shard with the same nblocks; eps (T, 4, mb) float32; na (NT, 4, mb)
        with NT the Gram cache's masks; sigmag (T, G); lc/rd/sqb_tab
        (K, T, G) from ``build_sweep_tables``; i2se and nonas (T,).
        Returns self."""
        T, _, mb = eps.shape
        nblocks, B = shards[0].win.shape
        nt = shards[0].gram.shape[1]
        if wave < 2 or B % wave:
            raise ValueError(f"wave {wave} must be > 1 and divide B={B}")
        if nt not in (1, T) or na.shape[0] != nt:
            raise ValueError(f"the Gram cache has {nt} masks and na "
                             f"{na.shape[0]}; expected both 1 or both T={T}")
        self.shards, self.eps, self.wave = list(shards), eps, wave
        self.common = (na, sigmag, lc_tab, rd_tab, sqb_tab, i2se, nonas)
        cap = MAX_SHARDS
        if eps.device.type == "cuda":
            K, _, G = lc_tab.shape
            if T > MAX_T or K > MAX_K:
                raise ValueError(f"T={T}, K={K} exceed the kernel's "
                                 f"MAX_T={MAX_T}, MAX_K={MAX_K}")
            # The plan, and with it the columns each CTA sums over, is the
            # one of all the step's shards, however many launches take
            # them: a split step gives the bits of one launch.
            want = len(shards)
            plan = block_sweep_plan(T, B, mb, nt, K, wave, want)
            cap = min(plan["cap"], MAX_SHARDS)
            self._set_up(plan, (T, B, mb, nt, K, wave, want, G), nblocks)
        n = len(self.shards)
        self.groups = [(s0, min(cap, n - s0)) for s0 in range(0, n, cap)]
        self.partial = (torch.empty_like(eps) if len(self.groups) > 1
                        else None)
        return self

    def _set_up(self, plan, key, nblocks):
        """The checks, the table of addresses and the scratch of a sweep on
        the card."""
        T, B, mb, nt, K, wave, want, G = key
        dev = self.eps.device
        f32, i32 = torch.float32, torch.int32

        def ptr(x, name, dtype, shape):
            return _build.check_once(self.seen, x, name, dtype, shape, dev)

        rows = []
        for q, s in enumerate(self.shards):
            m_in = s.bed.shape[0]
            if m_in % B or m_in >= 2 ** 31:
                raise ValueError(f"shard {q}: bed has {m_in} rows, not a "
                                 f"multiple of B={B} below 2^31")
            tb = (T, m_in)
            if isinstance(s.m_local, torch.Tensor) and s.m_local.is_cuda:
                m_ptr, m_int = ptr(s.m_local, f"m_local{q}", i32, (1,)), 0
            else:
                m_ptr, m_int = 0, int(s.m_local)
            nb = m_in // B
            rows.append([
                ptr(s.blk, f"blk{q}", i32, (nblocks,)),
                ptr(s.win, f"win{q}", i32, (nblocks, B)),
                ptr(s.bed, f"bed{q}", torch.uint8, (m_in, mb)),
                ptr(s.gram, f"gram{q}", f32, (nb, nt, 2 * B, 2 * B)),
                ptr(s.mave, f"mave{q}", f32, tb),
                ptr(s.msig, f"msig{q}", f32, tb),
                ptr(s.beta, f"beta{q}", f32, tb),
                ptr(s.comp, f"comp{q}", i32, tb),
                ptr(s.acum, f"acum{q}", f32, tb),
                ptr(s.grp, f"grp{q}", i32, (m_in,)),
                ptr(s.u, f"u{q}", f32, (nblocks, T, B)),
                ptr(s.z, f"z{q}", f32, (nblocks, T, B)),
                m_ptr, nb | (m_int << 32)])
        # ShardOps records (csrc/block_sweep.cu): 13 addresses, nb, m_local.
        self.table = np.array(rows, dtype=np.uint64)
        eps = self.eps
        na, sigmag, lc, rd, sqb, i2se, nonas = self.common
        common = [ptr(eps, "eps", f32, (T, 4, mb)),
                  ptr(na, "na", f32, (nt, 4, mb))]
        tail = [ptr(sigmag, "sigmag", f32, (T, G))]
        tail += [ptr(x, name, f32, (K, T, G))
                 for x, name in ((lc, "lc"), (rd, "rd"), (sqb, "sqb"))]
        tail += [ptr(i2se, "i2se", f32, (T,)), ptr(nonas, "nonas", f32, (T,))]
        if (self.key != key or self.scratch is None
                or self.scratch.device != dev):
            self.scratch = torch.zeros(
                (plan["cap"] * plan["slot_words"],), dtype=i32, device=dev)
            self.key = key
        self.args = (common, tail, (T, B, mb, nt, K, wave, G, want))

    def step(self, b: int, out=None, stamps=None):
        """Block step ``b`` of every shard: the sum of the shards' residual
        deltas is added into eps IN PLACE (``out`` None) or written into
        ``out`` (T, 4, mb) float32, every element.  Each shard's marker
        state is updated in place at the block's slots.  ``stamps``, for
        measurement only: an int64 tensor (grid, BS_NST) of one launch."""
        n_groups = len(self.groups)
        buf = out if out is not None else self.partial
        if self.eps.device.type == "cpu":
            for i, (s0, n) in enumerate(self.groups):
                final = i == n_groups - 1
                block_sweep_shards_plain(
                    b, self.shards[s0:s0 + n], self.eps, *self.common,
                    wave=self.wave, prev=buf if i else None,
                    out=None if final and out is None else buf)
            return self.eps if out is None else out
        common, tail, shapes = self.args
        if out is not None:
            _build.check_once(self.seen, out, "out", torch.float32,
                              tuple(self.eps.shape), self.eps.device)
        if stamps is not None and n_groups > 1:
            raise ValueError("stamps record one launch")
        table = self.table.ctypes.data
        for i, (s0, n) in enumerate(self.groups):
            final = i == n_groups - 1
            mode = (ACCUMULATE if i else 0) | (
                IN_PLACE if final and out is None else 0)
            _build.launch("block_sweep", table, s0, n, b, mode,
                          *common, 0 if buf is None else buf.data_ptr(),
                          *tail, self.scratch.data_ptr(),
                          0 if stamps is None else stamps.data_ptr(),
                          *shapes)
        return self.eps if out is None else out

    def finish(self):
        """Each shard's (beta, comp, acum), in shard order; the sweep's
        operands are let go."""
        states = [(s.beta, s.comp, s.acum) for s in self.shards]
        self.shards = self.eps = self.common = self.partial = None
        self.args = self.table = None
        return states


def block_sweep(blk_b, m_local, bed_blk, win_blk, gfull_blk, eps, na,
                mave_blk, msig_blk, beta_blk, comp_blk, acum_blk, grp_blk,
                u_blk, z_blk, sigmag, lc_tab, rd_tab, sqb_tab, i2se, nonas,
                *, wave):
    """Kernel 9 for one shard and one block, the residual read-only and
    the block's residual delta returned (arguments in the order of
    ``block_sweep_pallas``): the one-shard case of :class:`ShardedBlockSweep`
    in out mode.

    blk_b the natural block id and m_local the shard's real marker count,
    ints or one-element tensors (read on the device, never waited for);
    win_blk (B,) int32, processing position i is row win_blk[i] of the
    block; eps (T, 4, mb) float32, NOT modified; na (NT or T, 4, mb);
    u_blk/z_blk (T, B) in processing order; sigmag (T, G); lc/rd/sqb_tab
    (K, T, G) from ``build_sweep_tables``; i2se = 1/(2 sigmaE) and nonas
    (T,) or (T, 1).  The per-block operands are natural-order arrays over
    nb*B markers, nb >= 1: bed_blk (nb*B, mb) uint8, gfull_blk
    (nb, NT, 2B, 2B) float32, mave/msig/beta/acum_blk (T, nb*B) float32,
    comp_blk (T, nb*B) int32, grp_blk (nb*B,).  With nb = 1 they are the
    block's own slices; with nb > 1 they are the shard's whole arrays and
    the kernel takes block blk_b of them, so the caller never slices by a
    value that lives on the device.

    beta_blk, comp_blk and acum_blk are updated IN PLACE at the block's
    slots (the JAX function returns new arrays; here the caller's marker
    state is the output, so a block step is one launch and no scatter).
    Returns (deps, beta_blk, comp_blk, acum_blk), deps (T, 4, mb) float32
    with every element written.  CPU tensors take the plain version; CUDA
    tensors launch the kernel.
    """
    B = win_blk.shape[-1]
    T, _, mb = eps.shape
    nt = gfull_blk.shape[1]
    if wave < 2 or B % wave:
        raise ValueError(f"wave {wave} must be > 1 and divide B={B}")
    if nt not in (1, T) or na.shape[0] not in (nt, T):
        raise ValueError(f"gfull_blk has {nt} masks and na {na.shape[0]}; "
                         f"expected 1 or T={T}")
    if bed_blk.shape[0] % B:
        raise ValueError(f"bed_blk has {bed_blk.shape[0]} rows, not a "
                         f"multiple of B={B}")
    if bed_blk.device.type == "cpu":
        return block_sweep_plain(
            blk_b, m_local, bed_blk, win_blk, gfull_blk, eps, na, mave_blk,
            msig_blk, beta_blk, comp_blk, acum_blk, grp_blk, u_blk, z_blk,
            sigmag, lc_tab, rd_tab, sqb_tab, i2se, nonas, wave=wave)
    dev = bed_blk.device
    if isinstance(m_local, torch.Tensor) and m_local.is_cuda:
        m_local = m_local.reshape(1).to(torch.int32)
    else:
        m_local = int(m_local)
    shard = ShardOperands(
        _block_scalar(blk_b, dev), win_blk.reshape(1, B), m_local, bed_blk,
        gfull_blk, mave_blk, msig_blk, beta_blk, comp_blk, acum_blk,
        grp_blk.to(torch.int32), u_blk.reshape(1, T, B),
        z_blk.reshape(1, T, B))
    deps = torch.empty((T, 4, mb), dtype=torch.float32, device=dev)
    sweep = ShardedBlockSweep().sweep(
        [shard], eps, na[:nt], sigmag, lc_tab, rd_tab, sqb_tab,
        i2se.reshape(T), nonas.reshape(T), wave=wave)
    sweep.step(0, out=deps)
    sweep.finish()
    return deps, beta_blk, comp_blk, acum_blk
