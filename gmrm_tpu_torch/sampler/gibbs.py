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
     kernel;
   - marker-sharded (gibbs.py:295-351, ``marker_sweep_sharded``): every
     shard sweeps its own markers against the one residual, and per block
     step the shards' residual deltas are summed, over the process's local
     shards and then over processes, before the residual moves.  At W > 1
     a shard's block step is one launch of the fused per-block kernel
     (ops/sweep_kernel.block_sweep); at W = 1, or with
     ``megakernel=False``, it is the composed kernels with the update
     added into a zeroed delta instead of into the residual,
4. the hyperparameter block (gibbs.py:529-568); on a sharded run the
   per-group sums of beta^2 and the component counts are summed over
   shards and processes first, and the draws are the same on every shard.

Nothing here waits on the device: the processing order reaches the kernels
as device-side row indices, so a chain of iterations is queued without a
host sync.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from gmrm_tpu_torch.config import V0E, S02E, V0G, S02G
from gmrm_tpu_torch.ops.block_gram import block_gram_scaled, scale_gram
from gmrm_tpu_torch.ops.block_kernels import block_cdot, block_eps_update_
from gmrm_tpu_torch.ops.scan_kernel import serial_scan
from gmrm_tpu_torch.ops.scan_kernel_wave import scan_masks, wave_scan
from gmrm_tpu_torch.ops.sweep_kernel import (
    block_sweep, build_sweep_tables, sweep_blocks,
)
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

    sweep = _ComposedSweep(betas, comp, acum, sigmag, static, blocks, u_all,
                           z_all, (lc_t, rd_t, sqb_t), i2se, wave)
    for b in range(nblocks):
        sweep.step(b, eps, eps)
    betas, comp, acum = sweep.finish()
    cass = _natural_cass(comp, static.group_of, sigmag, static.m_local, K)
    return eps, betas, comp, acum, cass


class _ComposedSweep:
    """One sweep of one shard on the composed per-block path, a block step
    at a time: kernels 2, 3 and 4 at wave > 1 (the Gram gathered from the
    cache), kernels 5, 6 and 4 at wave = 1.

    Every per-marker operand is gathered to processing order once and
    split into contiguous (nblocks, ..., B) blocks.
    """

    def __init__(self, betas, comp, acum, sigmag, static, blocks, u_all,
                 z_all, tables, i2se, wave):
        nblocks, B = blocks.shape
        f32, i32 = torch.float32, torch.int32
        lc_t, rd_t, sqb_t = tables
        self.static, self.wave, self.i2se = static, wave, i2se
        self.u_all, self.z_all = u_all, z_all
        self.like = (betas, comp.to(i32), acum)
        perm = blocks.reshape(-1).long()                    # (m_pad,)
        self.perm = perm
        self.rows = perm.to(i32).reshape(nblocks, B)
        if wave > 1:
            self.blk_idx = perm.reshape(nblocks, B)[:, :1] // B
            win = perm.reshape(nblocks, B) - self.blk_idx * B
            self.win2 = torch.cat([win, win + B], dim=1)    # (nblocks, 2B)
            self.scan = functools.partial(wave_scan, wave=wave)
        else:
            self.na_gram = (static.na[:1] if static.shared_na
                            else static.na).contiguous()
            self.scan = serial_scan

        def split(y):    # (..., m_pad) processing order -> (nb, ..., B)
            y = y.reshape(*y.shape[:-1], nblocks, B)
            return y.movedim(-2, 0).contiguous()

        def gathered(x):  # (..., m_pad) storage order -> (nb, ..., B)
            return split(x[..., perm])

        grp_p = static.group_of[perm]
        self.mave_p = gathered(static.mave)
        self.msig_p = gathered(static.msig)
        self.beta_p = gathered(betas)
        self.comp_p = gathered(comp.to(i32))
        self.acum_p = gathered(acum)
        self.lc_p = split(lc_t[:, :, grp_p])                # (nb, K, T, B)
        self.rd_p = split(rd_t[:, :, grp_p])
        self.sqb_p = split(sqb_t[:, :, grp_p])
        live, zerob = scan_masks(grp_p, perm < static.m_local, sigmag)
        self.live_p = split(live)
        self.zerob_p = split(zerob)
        self.nm1 = static.nonas.to(f32)[:, None] - 1.0
        self.outs = []

    def step(self, b, eps, target):
        """Block step ``b`` against the residual ``eps``; the block's
        residual update is added into ``target``: ``eps`` itself on one
        device, a zeroed delta on a sharded run."""
        static = self.static
        mave_b, msig_b = self.mave_p[b], self.msig_p[b]
        if self.wave > 1:
            c = block_cdot(static.bed, self.rows[b], eps, mave_b, msig_b)
            gs = cached_gram_scaled(static.gram_cache, self.blk_idx[b],
                                    self.win2[b], mave_b, msig_b)
        else:
            c, gs = block_gram_scaled(static.bed, self.rows[b], eps,
                                      self.na_gram, mave_b, msig_b)
        dbeta, beta_new, comp_new, acum_new = self.scan(
            c + self.beta_p[b] * self.nm1, self.lc_p[b], self.rd_p[b],
            self.sqb_p[b], gs, self.beta_p[b], self.comp_p[b],
            self.acum_p[b], self.u_all[b], self.z_all[b], self.live_p[b],
            self.zerob_p[b], self.i2se)
        block_eps_update_(static.bed, self.rows[b], msig_b * dbeta, mave_b,
                          static.na, target)
        self.outs.append((beta_new, comp_new, acum_new))

    def finish(self):
        """The new marker state (betas, comp, acum) in natural order."""
        def natural(k):                   # (nb, T, B) -> (T, m_pad)
            like = self.like[k]
            y = torch.stack([o[k] for o in self.outs], dim=1).reshape(
                like.shape)
            out = torch.empty_like(like)
            out[:, self.perm] = y
            return out
        return natural(0), natural(1), natural(2)


class _FusedSweep:
    """One sweep of one shard through the fused per-block kernel (kernel 9),
    a block step at a time.  The kernel takes block ``blk_idx[b]`` of the
    shard's natural-order arrays itself and updates copies of
    betas/comp/acum in place, so a step is one launch and nothing is sliced
    by a value that lives on the device."""

    def __init__(self, betas, comp, acum, sigmag, static, blocks, u_all,
                 z_all, tables, i2se, wave):
        B = blocks.shape[1]
        i32 = torch.int32
        self.static, self.wave, self.i2se = static, wave, i2se
        self.tables, self.sigmag = tables, sigmag.to(torch.float32)
        self.u_all, self.z_all = u_all, z_all
        blk_idx = blocks[:, 0] // B
        self.blk_idx = blk_idx.to(i32)
        self.win = (blocks - blk_idx[:, None] * B).to(i32).contiguous()
        self.m_local = torch.tensor([static.m_local], dtype=i32,
                                    device=betas.device)
        nt = static.gram_cache.shape[1]
        self.na_in = (static.na[:1] if nt == 1 else static.na).contiguous()
        self.grp = static.group_of.to(i32)
        self.nonas = static.nonas.to(torch.float32)
        self.state = (betas.clone(), comp.to(i32).clone(), acum.clone())

    def step(self, b, eps):
        """The residual delta (T, 4, mb) of block step ``b`` against
        ``eps``, which is not modified."""
        static = self.static
        betas, comp, acum = self.state
        return block_sweep(
            self.blk_idx[b:b + 1], self.m_local, static.bed, self.win[b],
            static.gram_cache, eps, self.na_in, static.mave, static.msig,
            betas, comp, acum, self.grp, self.u_all[b], self.z_all[b],
            self.sigmag, *self.tables, self.i2se, self.nonas,
            wave=self.wave)[0]

    def finish(self):
        return self.state


def marker_sweep_sharded(eps, marker_states, sigmag, sigmae, pi_est, statics,
                         blocks, u_all, z_all, *, wave, comm,
                         megakernel=None):
    """The marker sweep over this process's shards (gibbs.py:295-384 under
    ``axis_name``), with all randomness injected.

    ``marker_states``, ``statics``, ``blocks``, ``u_all`` and ``z_all`` are
    lists with one entry per local shard, in shard order: (betas, comp,
    acum) in the shard's natural order, its ``StaticInputs``, and its
    processing order and draws as in :func:`marker_sweep`.  Every shard
    has the same number of blocks.  Per block step every shard computes
    its residual delta against the one residual ``eps``; the deltas are
    summed in shard order, then over processes (``comm.all_reduce_sum``:
    every process enters every sum, and a block of pad slots contributes
    zeros), and only then added into ``eps``, IN PLACE: the reference's
    per-marker MPI_Allgatherv (bayes.cpp:500-553) at block cadence.

    wave > 1 takes the fused per-block kernel (``block_sweep``, one launch
    per shard and block step); wave = 1, and ``megakernel=False`` at any
    wave, take the composed kernels with the update added into a zeroed
    delta.  ``megakernel=True`` raises: the whole-sweep kernel holds the
    residual for a whole sweep and cannot merge deltas per block.

    Returns (eps, [(betas, comp, acum)], cass), cass (T, G, K) summed over
    the local shards only.
    """
    if megakernel:
        raise ValueError(
            "megakernel=True requires a single shard: the sharded sweep "
            "sums the residual delta across shards after every block")
    nblocks, B = blocks[0].shape
    K = statics[0].cva.shape[1]
    f32 = torch.float32
    fused = wave > 1 and megakernel is not False
    if fused and (B % wave or any(s.gram_cache is None for s in statics)):
        raise ValueError(f"the sharded wave sweep needs wave {wave} to "
                         f"divide B={B} and a Gram cache on every shard")
    tables = build_sweep_tables(sigmag, sigmae, pi_est, statics[0].cva,
                                statics[0].cvai, statics[0].nonas,
                                statics[0].n_total)
    i2se = (1.0 / (2.0 * sigmae.to(f32))).contiguous()
    make = _FusedSweep if fused else _ComposedSweep
    sweeps = [make(b, c, a, sigmag, st, blk, u, z, tables, i2se, wave)
              for (b, c, a), st, blk, u, z in zip(marker_states, statics,
                                                  blocks, u_all, z_all)]
    deltas = None if fused else [torch.empty_like(eps) for _ in sweeps]
    for k in range(nblocks):
        total = None
        for i, sweep in enumerate(sweeps):
            if fused:
                d = sweep.step(k, eps)
            else:
                d = deltas[i].zero_()
                sweep.step(k, eps, d)
            total = d if total is None else total.add_(d)
        comm.all_reduce_sum(total)
        eps += total
    new_states = [sweep.finish() for sweep in sweeps]
    cass = sum(_natural_cass(c, st.group_of, sigmag, st.m_local, K)
               for (_, c, _), st in zip(new_states, statics))
    return eps, new_states, cass


def group_beta_sqn(betas, group_of, n_groups):
    """Per-group sums of beta^2, (T, G) float32 (gibbs.py:530-532), as a
    product with the groups' one-hot matrix: ``index_add_`` sums with float
    atomics on the card, in an order that changes from run to run, and a
    chain must be reproducible from its seed."""
    onehot = (group_of[:, None]
              == torch.arange(n_groups, device=betas.device)[None, :])
    return (betas * betas) @ onehot.to(torch.float32)


def hyper_block(betas, cass, eps, sigmag, pi_est, static: StaticInputs,
                gen, beta_sqn=None):
    """Hyperparameters after the sweep (gibbs.py:529-568).

    ``gen(name)`` gives the generator of draw ``name`` in ("sigmag", "pi",
    "sigmae").  A sharded run passes ``beta_sqn`` (T, G) and ``cass``
    already summed over shards and processes, and no ``betas``.
    Returns (sigmag, sigmae, pi_est, m0, e_sqn).
    """
    f32 = torch.float32
    if beta_sqn is None:
        beta_sqn = group_beta_sqn(betas, static.group_of,
                                  static.cva.shape[0])
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


def _intercept_step(state, static, it, rng):
    """The intercept step (gibbs.py:458-464) on the residual of ``state``,
    IN PLACE.  Returns (eps, sigmae, mu_new)."""
    T = state.eps.shape[0]
    na = static.na
    nonas = static.nonas
    eps = state.eps
    eps += state.mu[:, None, None] * na
    if it == 1:
        sigmae = 0.5 * (eps * eps).sum(dim=(1, 2)) / nonas
    else:
        sigmae = state.sigmae
    z_mu = torch.randn((T,), generator=rng.gen(it, "mu"), device=eps.device)
    # Mean epssum/nonas = 0: the reference never updates epssum.
    mu_new = state.epssum / nonas + torch.sqrt(sigmae / nonas) * z_mu
    eps -= mu_new[:, None, None] * na
    return eps, sigmae, mu_new


def _sweep_draws(state, static, it, rng, block_size, wave, shuffle):
    """The shuffle and the sweep's draws of one shard: (blocks, u, z)."""
    T, m_pad = state.betas.shape
    B = block_size
    if m_pad % B:
        raise ValueError("pad markers to a multiple of block_size")
    nblocks = m_pad // B
    dev = state.eps.device
    blocks = block_order(rng, it, nblocks, B, shuffle=shuffle, wave=wave,
                         m_local=static.m_local)
    u_all = torch.rand((nblocks, T, B), generator=rng.gen(it, "u"),
                       device=dev)
    z_all = torch.randn((nblocks, T, B), generator=rng.gen(it, "z"),
                        device=dev)
    return blocks, u_all, z_all


def gibbs_iteration(state: SamplerState, static: StaticInputs, it: int,
                    rng: RngPlan, *, block_size: int, wave: int,
                    shuffle: bool = True, megakernel=None):
    """One iteration; ``it`` is 1-based (runner.py:517).  The residual
    buffer of ``state`` is updated in place and carried into the result.
    ``megakernel`` as in :func:`marker_sweep`."""
    eps, sigmae, mu_new = _intercept_step(state, static, it, rng)
    blocks, u_all, z_all = _sweep_draws(state, static, it, rng, block_size,
                                        wave, shuffle)

    eps, betas, comp, acum, cass = marker_sweep(
        eps, state.betas, state.comp, state.acum, state.sigmag, sigmae,
        state.pi_est, static, blocks, u_all, z_all, wave=wave,
        megakernel=megakernel)
    sigmag, sigmae_new, pi_est, m0, e_sqn = hyper_block(
        betas, cass, eps, state.sigmag, state.pi_est, static,
        lambda name: rng.gen(it, name))
    new_state = state.replace(
        eps=eps, betas=betas, comp=comp, acum=acum, cass=cass,
        sigmag=sigmag, sigmae=sigmae_new, pi_est=pi_est, mu=mu_new)
    return new_state, IterAux(m0=m0, e_sqn=e_sqn)


def gibbs_iteration_sharded(states, statics, it: int, rngs, *,
                            block_size: int, wave: int, comm,
                            shuffle: bool = True, megakernel=None):
    """One iteration over this process's shards (gibbs.py:420-568 under
    ``axis_name``).

    ``states``, ``statics`` and ``rngs`` have one entry per local shard, in
    shard order.  The states share their replicated leaves (eps, one
    buffer, updated IN PLACE; sigmag, sigmae, pi_est, mu, cass) and differ
    in betas/comp/acum; ``rngs[i]`` is keyed by the shard's global id, so
    the shuffle and the sweep's draws differ from shard to shard and the
    other draws are the same everywhere.  The sums of per-group beta^2 and
    of cass go over the local shards, then over processes, before the
    hyperparameter block (gibbs.py:530-535).  Returns (states, aux).
    """
    first, static0 = states[0], statics[0]
    G = static0.cva.shape[0]
    eps, sigmae, mu_new = _intercept_step(first, static0, it, rngs[0])
    draws = [_sweep_draws(st, sta, it, rng, block_size, wave, shuffle)
             for st, sta, rng in zip(states, statics, rngs)]
    eps, marker_states, cass = marker_sweep_sharded(
        eps, [(st.betas, st.comp, st.acum) for st in states], first.sigmag,
        sigmae, first.pi_est, statics, [d[0] for d in draws],
        [d[1] for d in draws], [d[2] for d in draws], wave=wave, comm=comm,
        megakernel=megakernel)
    beta_sqn = sum(group_beta_sqn(b, sta.group_of, G)
                   for (b, _, _), sta in zip(marker_states, statics))
    comm.all_reduce_sum(beta_sqn)
    comm.all_reduce_sum(cass)
    sigmag, sigmae_new, pi_est, m0, e_sqn = hyper_block(
        None, cass, eps, first.sigmag, first.pi_est, static0,
        lambda name: rngs[0].gen(it, name), beta_sqn=beta_sqn)
    new_states = [
        st.replace(eps=eps, betas=b, comp=c, acum=a, cass=cass,
                   sigmag=sigmag, sigmae=sigmae_new, pi_est=pi_est,
                   mu=mu_new)
        for st, (b, c, a) in zip(states, marker_states)]
    return new_states, IterAux(m0=m0, e_sqn=e_sqn)

