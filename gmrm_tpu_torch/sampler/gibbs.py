"""One Gibbs iteration (port of gmrm_tpu/sampler/gibbs.py).

Structure, as in the reference outer loop (bayes.cpp:340-671):

1. the intercept step (gibbs.py:458-464),
2. the shuffle (gibbs.py:489-511): in wave mode (W > 1) block-preserving,
   a random block order and a random row order within each block; at
   W = 1 a uniform shuffle of the real markers with pad slots last,
3. the marker sweep over Gram blocks:
   - W > 1, the default (gibbs.py:184-239): the whole sweep in one launch
     of the sweep kernel (ops/sweep_kernel.sweep_blocks), from
     natural-order operands and group-level tables;
   - W > 1 with ``megakernel=False``, the composed path
     (gibbs.py:353-400, ``use_cache``), per block: the c-dot kernel, the
     cached Gram gathered to processing order and scaled in plain
     PyTorch, the wave-scan kernel, the residual-update kernel;
   - W = 1, the exact serial path, per block: the block-Gram kernel (c
     and the scaled Gram), the serial-scan kernel, the residual-update
     kernel,
4. the hyperparameter block (gibbs.py:529-568).

Nothing here waits on the device: the processing order reaches the kernels
as device-side row indices, so a chain of iterations is queued without a
host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gmrm_tpu_torch.config import V0E, S02E, V0G, S02G
from gmrm_tpu_torch.ops.block_gram import block_gram_scaled, scale_gram
from gmrm_tpu_torch.ops.block_kernels import block_cdot, block_eps_update_
from gmrm_tpu_torch.ops.scan_kernel import serial_scan
from gmrm_tpu_torch.ops.scan_kernel_wave import scan_masks, wave_scan
from gmrm_tpu_torch.ops.sweep_kernel import build_sweep_tables, sweep_blocks
from gmrm_tpu_torch.sampler.dists import (
    RngPlan, dirichlet_from_counts, inv_scaled_chisq,
)
from gmrm_tpu_torch.sampler.state import SamplerState, StaticInputs


class IterAux(NamedTuple):
    """Per-iteration observables (the .csv row ingredients)."""
    m0: torch.Tensor         # (T, G)
    e_sqn: torch.Tensor      # (T,)


def _natural_cass(comp, group_of, sigmag, m_local, K):
    """Per-(group, component) counts over live markers (valid and in a
    group with sigmaG != 0), from natural-order components (reference
    bayes.cpp:583-589)."""
    T, m_pad = comp.shape
    G = sigmag.shape[1]
    valid = torch.arange(m_pad, device=comp.device) < m_local
    live = valid[None, :] & (sigmag[:, group_of] != 0.0)
    idx = group_of[None, :] * K + comp.long()
    cass = torch.zeros((T, G * K), dtype=torch.int32, device=comp.device)
    cass.scatter_add_(1, idx, live.to(torch.int32))
    return cass.reshape(T, G, K)


def cached_gram_scaled(gram_cache, blk, win2, mave_blk, msig_blk):
    """The block's scaled Gram (T, B, B) in processing order.

    ``blk`` (1,) is the natural block and ``win2`` (2B,) = [win, win + B];
    one exact row and column gather of the cached raw quadrants, then the
    scaling of ops/block_gram.scale_gram (gibbs.py:279-293).
    """
    gf = gram_cache.index_select(0, blk)[0]                # (NT, 2B, 2B)
    gf = gf.index_select(1, win2).index_select(2, win2)
    return scale_gram(gf, mave_blk, msig_blk)


def marker_sweep(eps, betas, comp, acum, sigmag, sigmae, pi_est,
                 static: StaticInputs, blocks, u_all, z_all, *, wave,
                 megakernel=None):
    """The full marker sweep with all randomness injected.

    blocks (nblocks, B) the processing order, as in the JAX package: slot
    k of the sweep holds marker ``blocks.reshape(-1)[k]``.  With wave > 1
    every row must lie in one natural block (the block-preserving
    shuffle), whose Gram comes from ``static.gram_cache``; at wave = 1 any
    permutation goes.  u_all/z_all (nblocks, T, B) uniforms and standard
    normals.  ``eps`` is updated IN PLACE (the residual-update kernel adds
    each block's delta into it).  Returns (eps, betas, comp, acum, cass).

    ``megakernel``, as in the JAX package (gibbs.py:73, :184-200): None
    takes the whole-sweep kernel whenever wave > 1 and there is a Gram
    cache, which is every wave-mode run of the port; False takes the
    composed per-block path; True raises where the whole-sweep kernel
    cannot run.
    """
    nblocks, B = blocks.shape
    T, m_pad = betas.shape
    K = static.cva.shape[1]
    f32, i32 = torch.float32, torch.int32
    nonas = static.nonas

    mega = (megakernel is not False and wave > 1 and B % wave == 0
            and static.gram_cache is not None)
    if megakernel and not mega:
        raise ValueError(
            "megakernel=True requires wave_size>1 dividing block_size, a "
            "block-preserving shuffle and static.gram_cache "
            f"(got wave={wave}, B={B}, gram_cache="
            f"{'set' if static.gram_cache is not None else None})")

    lc_t, rd_t, sqb_t = build_sweep_tables(
        sigmag, sigmae, pi_est, static.cva, static.cvai, nonas,
        static.n_total)
    i2se = (1.0 / (2.0 * sigmae.to(f32))).contiguous()

    if mega:
        # Natural-order operands and group tables go to the kernel as they
        # are; the block and row order never touch the host.
        blk_idx = blocks[:, 0] // B
        win = blocks - blk_idx[:, None] * B
        nt = static.gram_cache.shape[1]
        eps, betas, comp, acum = sweep_blocks(
            static.bed, blk_idx.to(i32), win.to(i32).contiguous(),
            static.m_local, static.gram_cache, eps,
            (static.na[:1] if nt == 1 else static.na).contiguous(),
            static.mave, static.msig, betas, comp.to(i32), acum,
            static.group_of, u_all, z_all, sigmag.to(f32), lc_t, rd_t,
            sqb_t, i2se, nonas.to(f32), wave=wave)
        cass = _natural_cass(comp, static.group_of, sigmag, static.m_local,
                             K)
        return eps, betas, comp, acum, cass

    # Processing order: every per-marker operand is gathered once and split
    # into contiguous (nblocks, ..., B) blocks.
    perm = blocks.reshape(-1).long()                        # (m_pad,)
    rows = perm.to(i32).reshape(nblocks, B)
    if wave > 1:
        blk_idx = perm.reshape(nblocks, B)[:, :1] // B      # (nblocks, 1)
        win = perm.reshape(nblocks, B) - blk_idx * B
        win2 = torch.cat([win, win + B], dim=1)             # (nblocks, 2B)

        def scan(*args):
            return wave_scan(*args, wave=wave)
    else:
        na_gram = (static.na[:1] if static.shared_na
                   else static.na).contiguous()
        scan = serial_scan

    def split(y):        # (..., m_pad) processing order -> (nb, ..., B)
        y = y.reshape(*y.shape[:-1], nblocks, B)
        return y.movedim(-2, 0).contiguous()

    def gathered(x):     # (..., m_pad) storage order -> (nb, ..., B)
        return split(x[..., perm])

    grp_p = static.group_of[perm]
    mave_p = gathered(static.mave)
    msig_p = gathered(static.msig)
    beta_p = gathered(betas)
    comp_p = gathered(comp.to(i32))
    acum_p = gathered(acum)
    lc_p = split(lc_t[:, :, grp_p])                         # (nb, K, T, B)
    rd_p = split(rd_t[:, :, grp_p])
    sqb_p = split(sqb_t[:, :, grp_p])
    live, zerob = scan_masks(grp_p, perm < static.m_local, sigmag)
    live_p = split(live)
    zerob_p = split(zerob)
    nm1 = nonas.to(f32)[:, None] - 1.0

    outs = []
    for b in range(nblocks):
        if wave > 1:
            c = block_cdot(static.bed, rows[b], eps, mave_p[b], msig_p[b])
            gs = cached_gram_scaled(static.gram_cache, blk_idx[b], win2[b],
                                    mave_p[b], msig_p[b])
        else:
            c, gs = block_gram_scaled(static.bed, rows[b], eps, na_gram,
                                      mave_p[b], msig_p[b])
        dbeta, beta_new, comp_new, acum_new = scan(
            c + beta_p[b] * nm1, lc_p[b], rd_p[b], sqb_p[b], gs, beta_p[b],
            comp_p[b], acum_p[b], u_all[b], z_all[b], live_p[b],
            zerob_p[b], i2se)
        block_eps_update_(static.bed, rows[b], msig_p[b] * dbeta,
                          mave_p[b], static.na, eps)
        outs.append((beta_new, comp_new, acum_new))

    def natural(k, like):                 # (nb, T, B) -> (T, m_pad)
        y = torch.stack([o[k] for o in outs], dim=1).reshape(T, m_pad)
        out = torch.empty_like(like)
        out[:, perm] = y
        return out

    betas = natural(0, betas)
    comp = natural(1, comp.to(i32))
    acum = natural(2, acum)
    cass = _natural_cass(comp, static.group_of, sigmag, static.m_local, K)
    return eps, betas, comp, acum, cass


def hyper_block(betas, cass, eps, sigmag, pi_est, static: StaticInputs,
                gen):
    """Hyperparameters after the sweep (gibbs.py:529-568).

    ``gen(name)`` gives the generator of draw ``name`` in ("sigmag", "pi",
    "sigmae").  Returns (sigmag, sigmae, pi_est, m0, e_sqn).
    """
    f32 = torch.float32
    T = betas.shape[0]
    G = static.cva.shape[0]
    beta_sqn = torch.zeros((T, G), dtype=f32, device=betas.device)
    beta_sqn.index_add_(1, static.group_of, betas * betas)
    mtot = static.mtotgrp
    m0 = torch.where(mtot > 0, mtot - cass[:, :, 0].long(),
                     torch.zeros_like(mtot))                # (T, G)
    m0f = m0.to(f32)
    active = (mtot[None, :] > 0) & (m0 > 0) & (cass.sum(dim=2) > 0)

    a_g = V0G + m0f
    b_g = (beta_sqn * m0f + V0G * S02G) / torch.clamp(a_g, min=1e-30)
    sg_draw = inv_scaled_chisq(gen("sigmag"), a_g,
                               torch.clamp(b_g, min=1e-30))
    sigmag_new = torch.where(
        mtot[None, :] > 0,
        torch.where(active, sg_draw, torch.zeros_like(sg_draw)), sigmag)

    pi_draw = dirichlet_from_counts(gen("pi"), cass.to(f32) + 1.0)
    pi_new = torch.where(active[:, :, None], pi_draw, pi_est)

    e_sqn = (eps * eps).sum(dim=(1, 2))
    sigmae_new = inv_scaled_chisq(
        gen("sigmae"), torch.full_like(e_sqn, V0E + static.n_total),
        (e_sqn + V0E * S02E) / (V0E + static.n_total))
    return sigmag_new, sigmae_new, pi_new, m0, e_sqn


def block_order(rng: RngPlan, it: int, nblocks: int, B: int, *,
                shuffle: bool, wave: int, m_local: int):
    """The sweep's processing order (nblocks, B) (gibbs.py:489-511).

    wave > 1: the block-preserving shuffle, a random block order pi_b and
    a random row order win within each block, slot order pi_b*B + win.
    wave = 1: a uniform shuffle of the m_local real markers, pad slots
    pinned to the end.  Without shuffle, the natural order.
    """
    dev = rng.device
    m_pad = nblocks * B
    if not shuffle:
        return torch.arange(m_pad, device=dev).reshape(nblocks, B)
    if wave > 1:
        pi_b = torch.randperm(nblocks, generator=rng.gen(it, "block_order"),
                              device=dev)
        r = torch.rand((nblocks, B), generator=rng.gen(it, "row_order"),
                       device=dev)
        return pi_b[:, None] * B + torch.argsort(r, dim=1)
    r = torch.rand((m_pad,), generator=rng.gen(it, "marker_order"),
                   device=dev)
    r = torch.where(torch.arange(m_pad, device=dev) < m_local, r, 2.0)
    return torch.argsort(r, stable=True).reshape(nblocks, B)


def gibbs_iteration(state: SamplerState, static: StaticInputs, it: int,
                    rng: RngPlan, *, block_size: int, wave: int,
                    shuffle: bool = True, megakernel=None):
    """One iteration; ``it`` is 1-based (runner.py:517).  The residual
    buffer of ``state`` is updated in place and carried into the result.
    ``megakernel`` as in :func:`marker_sweep`."""
    T = state.eps.shape[0]
    m_pad = state.betas.shape[1]
    B = block_size
    if m_pad % B:
        raise ValueError("pad markers to a multiple of block_size")
    nblocks = m_pad // B
    dev = state.eps.device
    na = static.na
    nonas = static.nonas

    # --- 1. intercept step (gibbs.py:458-464) ---------------------------
    eps = state.eps
    eps += state.mu[:, None, None] * na
    if it == 1:
        sigmae = 0.5 * (eps * eps).sum(dim=(1, 2)) / nonas
    else:
        sigmae = state.sigmae
    z_mu = torch.randn((T,), generator=rng.gen(it, "mu"), device=dev)
    # Mean epssum/nonas = 0: the reference never updates epssum.
    mu_new = state.epssum / nonas + torch.sqrt(sigmae / nonas) * z_mu
    eps -= mu_new[:, None, None] * na

    # --- 2. the shuffle and the sweep's draws ----------------------------
    blocks = block_order(rng, it, nblocks, B, shuffle=shuffle, wave=wave,
                         m_local=static.m_local)
    u_all = torch.rand((nblocks, T, B), generator=rng.gen(it, "u"),
                       device=dev)
    z_all = torch.randn((nblocks, T, B), generator=rng.gen(it, "z"),
                        device=dev)

    # --- 3. marker sweep --------------------------------------------------
    eps, betas, comp, acum, cass = marker_sweep(
        eps, state.betas, state.comp, state.acum, state.sigmag, sigmae,
        state.pi_est, static, blocks, u_all, z_all, wave=wave,
        megakernel=megakernel)

    # --- 4. hyperparameter block ----------------------------------------
    sigmag, sigmae_new, pi_est, m0, e_sqn = hyper_block(
        betas, cass, eps, state.sigmag, state.pi_est, static,
        lambda name: rng.gen(it, name))
    new_state = state.replace(
        eps=eps, betas=betas, comp=comp, acum=acum, cass=cass,
        sigmag=sigmag, sigmae=sigmae_new, pi_est=pi_est, mu=mu_new)
    return new_state, IterAux(m0=m0, e_sqn=e_sqn)

