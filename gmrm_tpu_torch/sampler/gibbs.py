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
     (gibbs.py:353-400, ``use_cache``) and W = 1, the exact serial path,
     at one cadence: the scaled Grams of a run of blocks first (they do
     not depend on the residual; at W > 1 the cached raw Grams gathered to
     processing order and scaled in plain PyTorch, at W = 1 the
     block-Gram kernel, one launch per run), then the c-dot kernel of
     block 0 and per block the scan kernel (wave scan or serial scan) on
     the sweep's arrays and a block index and one launch of the residual
     update fused with the next block's c-dot (the update alone after the
     last block);
   - marker-sharded (gibbs.py:295-351, ``marker_sweep_sharded``): every
     shard sweeps its own markers against the one residual, and per block
     step the shards' residual deltas are summed, over the process's local
     shards and then over processes, before the residual moves.  At W > 1
     a block step of all local shards is one launch of the sharded
     block-step kernel (ops/sweep_kernel.ShardedBlockSweep), which sums
     the shards' deltas itself and, with no process group, adds the sum
     into the residual; at W = 1, or with ``megakernel=False``, each shard
     runs the composed kernels with the update added into a zeroed delta
     instead of into the residual,
4. the hyperparameter block (gibbs.py:529-568); on a sharded run the
   per-group sums of beta^2 and the component counts are summed over
   shards and processes first, and the draws are the same on every shard.

Nothing here waits on the device: the processing order reaches the kernels
as device-side row indices, so a chain of iterations is queued without a
host sync.

The run's dtype is the residual's (``eps``): float32, or float64 on a
``--dtype float64`` run, which plans W = 1.  At float64 the draws of the
intercept and the sweep (u, z) are float64, as the JAX package draws them
in the run's dtype (gibbs.py:514-515), and the W = 1 path's kernels take
their float64 routes (kernels A-C: ops/block_gram, ops/block_kernels,
ops/scan_kernel).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gmrm_tpu_torch.config import V0E, S02E, V0G, S02G
from gmrm_tpu_torch.ops.block_gram import (
    blocks_gram_scaled, gram_run_blocks, scale_gram,
)
from gmrm_tpu_torch.ops.block_kernels import BlockPasses
from gmrm_tpu_torch.ops.scan_kernel import SerialScanSweep
from gmrm_tpu_torch.ops.scan_kernel_wave import WaveScanSweep, scan_masks
from gmrm_tpu_torch.ops.sweep_kernel import (
    ShardOperands, ShardedBlockSweep, build_sweep_tables, sweep_blocks,
)
from gmrm_tpu_torch.sampler.dists import (
    RngPlan, dirichlet_from_counts, dirichlet_from_draws, gamma_draws,
    inv_scaled_chisq, inv_scaled_chisq_from_draws,
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


def cached_grams_scaled(gram_cache, blk, win2, mave_p, msig_p):
    """The scaled Grams (nr, T, B, B) of a run of nr blocks in processing
    order (gibbs.py:268-293, batched).

    ``blk`` (nr,) are the natural blocks and ``win2`` (nr, 2B) =
    [win, win + B] their row orders; exact gathers of the cached raw
    quadrants (the blocks, then each block's rows and columns), then the
    scaling of ops/block_gram.scale_gram element by element, so every
    block's Gram has the bits of a gather and scaling of that block alone.
    """
    gf = gram_cache.index_select(0, blk)                   # (nr, NT, 2B, 2B)
    idx = win2[:, None, :, None].expand(gf.shape)
    gf = gf.gather(2, idx).gather(3, idx.transpose(2, 3))
    return scale_gram(gf, mave_p, msig_p)


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
    dtype = eps.dtype

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
        static.n_total, dtype=dtype)
    i2se = (1.0 / (2.0 * sigmae.to(dtype))).contiguous()

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
    at a time: the c-dot and residual-update kernels (2 and 4, fused per
    step on one device, ``BlockPasses``) around the wave-scan kernel (3,
    ``WaveScanSweep``) at wave > 1 or the serial-scan kernel (6,
    ``SerialScanSweep``) at wave = 1.  The blocks' scaled Grams are made
    ahead of the block loop, a run of ``gram_run_blocks`` blocks at a
    time: at wave > 1 gathered from the cache and scaled in plain PyTorch
    (``cached_grams_scaled``), at wave = 1 by kernel 5 (one launch per
    run); the first run here, a further one when a step leaves the run it
    has.

    Every per-marker operand is gathered to processing order once and
    split into contiguous (nblocks, ..., B) blocks; the scan writes the
    new marker state into per-sweep arrays that ``finish`` scatters once.
    """

    def __init__(self, betas, comp, acum, sigmag, static, blocks, u_all,
                 z_all, tables, i2se, wave):
        nblocks, B = blocks.shape
        dty, i32 = betas.dtype, torch.int32
        lc_t, rd_t, sqb_t = tables
        self.like = (betas, comp.to(i32), acum)
        perm = blocks.reshape(-1).long()                    # (m_pad,)
        self.perm = perm
        self.rows = perm.to(i32).reshape(nblocks, B)

        def split(y):    # (..., m_pad) processing order -> (nb, ..., B)
            y = y.reshape(*y.shape[:-1], nblocks, B)
            return y.movedim(-2, 0).contiguous()

        def gathered(x):  # (..., m_pad) storage order -> (nb, ..., B)
            return split(x[..., perm])

        grp_p = static.group_of[perm]
        rows = self.rows
        mave_p = self.mave_p = gathered(static.mave)
        msig_p = self.msig_p = gathered(static.msig)
        live, zerob = scan_masks(grp_p, perm < static.m_local, sigmag)
        operands = (static.nonas.to(dty) - 1.0,
                    split(lc_t[:, :, grp_p]), split(rd_t[:, :, grp_p]),
                    split(sqb_t[:, :, grp_p]), gathered(betas),
                    gathered(comp.to(i32)), gathered(acum), u_all, z_all,
                    split(live), split(zerob), msig_p, i2se)
        self.passes = BlockPasses(static.bed, rows, mave_p, msig_p,
                                  static.na)
        # The Gram builders close over tensors only, not over self, so a
        # finished sweep is freed at once and not by the cycle collector.
        if wave > 1:
            self.scan = WaveScanSweep(*operands, wave=wave)
            blk = perm.reshape(nblocks, B)[:, 0] // B
            win = perm.reshape(nblocks, B) - blk[:, None] * B
            win2 = torch.cat([win, win + B], dim=1)         # (nblocks, 2B)
            cache = static.gram_cache
            nt = cache.shape[1]

            def grams(s):
                return cached_grams_scaled(cache, blk[s], win2[s], mave_p[s],
                                           msig_p[s])
        else:
            self.scan = SerialScanSweep(*operands)
            bed = static.bed
            # The raw Gram stage takes the 0/1 mask in float32 at any dtype.
            na_gram = (static.na[:1] if static.shared_na
                       else static.na).to(torch.float32).contiguous()
            nt = na_gram.shape[0]

            def grams(s):
                return blocks_gram_scaled(bed, rows[s], na_gram, mave_p[s],
                                          msig_p[s])
        self.grams = grams
        self.gram_run = gram_run_blocks(betas.shape[0], B, nt, nblocks,
                                        betas.element_size())
        self.gs, self.gs_start = None, 0
        self._build_grams(0)

    def _build_grams(self, start):
        """The scaled Grams of blocks start .. start + gram_run - 1."""
        self.gs = None                    # free the last run first
        self.gs = self.grams(slice(start, start + self.gram_run))
        self.gs_start = start

    def step(self, b, eps, target):
        """Block step ``b`` against the residual ``eps``; the block's
        residual update is added into ``target``: ``eps`` itself on one
        device, a zeroed delta on a sharded run.

        With ``target is eps`` (one device, block steps 0, 1, ... in order)
        block b's update and block b+1's c-dot are one launch
        (``BlockPasses.update_cdot_``): step 0 starts with the c-dot of
        block 0 and the last step ends with the update alone.  On a sharded
        run the next c-dot waits for the sum of the shards' deltas, so each
        step is c-dot, scan, update."""
        if not 0 <= b - self.gs_start < self.gs.shape[0]:
            self._build_grams(b - b % self.gram_run)
        fused = target is eps
        if b == 0 or not fused:
            self.passes.cdot(b, eps)
        self.scan.step(b, self.passes.c, self.gs, b - self.gs_start, bc=b)
        if fused and b + 1 < self.rows.shape[0]:
            self.passes.update_cdot_(b, self.scan.d, eps)
        else:
            self.passes.update_(b, self.scan.d, target)

    def finish(self):
        """The new marker state (betas, comp, acum) in natural order."""
        new = (self.scan.beta_new, self.scan.comp_new, self.scan.acum_new)

        def natural(k):                   # (nb, T, B) -> (T, m_pad)
            like = self.like[k]
            y = new[k].movedim(0, 1).reshape(like.shape)
            out = torch.empty_like(like)
            out[:, self.perm] = y
            return out
        return natural(0), natural(1), natural(2)


def _fused_operands(betas, comp, acum, static, blocks, u_all, z_all):
    """One shard's :class:`ShardOperands` of kernel 9 for a sweep: the
    block order and row order as int32, copies of its marker state, which
    the kernel updates in place, and its natural-order arrays as they
    are."""
    B = blocks.shape[1]
    i32 = torch.int32
    blk_idx = blocks[:, 0] // B
    return ShardOperands(
        blk_idx.to(i32), (blocks - blk_idx[:, None] * B).to(i32).contiguous(),
        static.m_local, static.bed, static.gram_cache, static.mave,
        static.msig, betas.clone(), comp.to(i32).clone(), acum.clone(),
        static.group_of.to(i32), u_all, z_all)


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

    wave > 1 takes kernel 9 (``ShardedBlockSweep``): one launch per block
    step for all local shards, which also sums their deltas in shard
    order.  With no sum across processes to make (``comm.sums()`` False)
    the launch adds that sum into ``eps`` itself, and the host issues
    nothing else per block step; otherwise it writes the local sum, which
    ``comm.all_reduce_sum`` sums over processes before ``eps += sum``.
    Both give the same bits.  wave = 1, and ``megakernel=False`` at any
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
    dty = eps.dtype
    fused = wave > 1 and megakernel is not False
    if fused and (B % wave or any(s.gram_cache is None for s in statics)):
        raise ValueError(f"the sharded wave sweep needs wave {wave} to "
                         f"divide B={B} and a Gram cache on every shard")
    tables = build_sweep_tables(sigmag, sigmae, pi_est, statics[0].cva,
                                statics[0].cvai, statics[0].nonas,
                                statics[0].n_total, dtype=dty)
    i2se = (1.0 / (2.0 * sigmae.to(dty))).contiguous()
    if fused:
        nt = statics[0].gram_cache.shape[1]
        na = statics[0].na
        sweep = ShardedBlockSweep().sweep(
            [_fused_operands(b, c, a, st, blk, u, z)
             for (b, c, a), st, blk, u, z in zip(marker_states, statics,
                                                 blocks, u_all, z_all)],
            eps, (na[:1] if nt == 1 else na).contiguous(), sigmag.to(dty),
            *tables, i2se, statics[0].nonas.to(dty), wave=wave)
        total = torch.empty_like(eps) if comm.sums() else None
        for k in range(nblocks):
            if total is None:
                sweep.step(k)
            else:
                comm.all_reduce_sum(sweep.step(k, out=total))
                eps += total
        new_states = sweep.finish()
    else:
        sweeps = [_ComposedSweep(b, c, a, sigmag, st, blk, u, z, tables,
                                 i2se, wave)
                  for (b, c, a), st, blk, u, z in zip(
                      marker_states, statics, blocks, u_all, z_all)]
        deltas = [torch.empty_like(eps) for _ in sweeps]
        for k in range(nblocks):
            total = None
            for d, sweep in zip(deltas, sweeps):
                sweep.step(k, eps, d.zero_())
                total = d if total is None else total.add_(d)
            comm.all_reduce_sum(total)
            eps += total
        new_states = [sweep.finish() for sweep in sweeps]
    cass = sum(_natural_cass(c, st.group_of, sigmag, st.m_local, K)
               for (_, c, _), st in zip(new_states, statics))
    return eps, new_states, cass


def group_beta_sqn(betas, group_of, n_groups):
    """Per-group sums of beta^2, (T, G) in the dtype of betas
    (gibbs.py:530-532), as a product with the groups' one-hot matrix:
    ``index_add_`` sums with float atomics on the card, in an order that
    changes from run to run, and a chain must be reproducible from its
    seed."""
    onehot = (group_of[:, None]
              == torch.arange(n_groups, device=betas.device)[None, :])
    return (betas * betas) @ onehot.to(betas.dtype)


def hyper_shapes(T, G, K):
    """The gamma variates of the hyperparameter block, by purpose."""
    return {"sigmag": (T, G), "pi": (T, G, K), "sigmae": (T,)}


def hyper_draws(gen, T, G, K, device, out=None):
    """The hyperparameter block's random numbers: for each purpose the
    :func:`dists.gamma_draws` of its variates (:func:`hyper_shapes`) from
    generator ``gen(name)``.  ``out``, a dict of
    :func:`dists.gamma_buffers`, receives them in place."""
    return {name: gamma_draws(gen(name), shape, device,
                              None if out is None else out[name])
            for name, shape in hyper_shapes(T, G, K).items()}


def hyper_block(betas, cass, eps, sigmag, pi_est, static: StaticInputs,
                gen, beta_sqn=None):
    """Hyperparameters after the sweep (gibbs.py:529-568).

    ``gen(name)`` gives the generator of draw ``name`` in ("sigmag", "pi",
    "sigmae").  A sharded run passes ``beta_sqn`` (T, G) and ``cass``
    already summed over shards and processes, and no ``betas``.
    Returns (sigmag, sigmae, pi_est, m0, e_sqn).
    """
    return _hyper(betas, cass, eps, sigmag, pi_est, static, beta_sqn,
                  lambda name, a, b: inv_scaled_chisq(gen(name), a, b),
                  lambda alpha: dirichlet_from_counts(gen("pi"), alpha))


def hyper_block_from_draws(betas, cass, eps, sigmag, pi_est,
                           static: StaticInputs, draws, beta_sqn=None):
    """:func:`hyper_block` on the draws of :func:`hyper_draws` instead of
    generators: the same numbers, with no draw and no wait on the device."""
    return _hyper(
        betas, cass, eps, sigmag, pi_est, static, beta_sqn,
        lambda name, a, b: inv_scaled_chisq_from_draws(a, b, draws[name]),
        lambda alpha: dirichlet_from_draws(alpha, draws["pi"]))


def _hyper(betas, cass, eps, sigmag, pi_est, static, beta_sqn, chisq,
           dirichlet):
    """The hyperparameter block's arithmetic; ``chisq(name, a, b)`` and
    ``dirichlet(alpha)`` give its scaled inverse chi-squared and Dirichlet
    variates, in the run's dtype (the residual's)."""
    dty = eps.dtype
    if beta_sqn is None:
        beta_sqn = group_beta_sqn(betas, static.group_of,
                                  static.cva.shape[0])
    mtot = static.mtotgrp
    m0 = torch.where(mtot > 0, mtot - cass[:, :, 0].long(),
                     torch.zeros_like(mtot))                # (T, G)
    m0f = m0.to(dty)
    active = (mtot[None, :] > 0) & (m0 > 0) & (cass.sum(dim=2) > 0)

    a_g = V0G + m0f
    b_g = (beta_sqn * m0f + V0G * S02G) / torch.clamp(a_g, min=1e-30)
    sg_draw = chisq("sigmag", a_g, torch.clamp(b_g, min=1e-30))
    sigmag_new = torch.where(
        mtot[None, :] > 0,
        torch.where(active, sg_draw, torch.zeros_like(sg_draw)), sigmag)

    pi_draw = dirichlet(cass.to(dty) + 1.0)
    pi_new = torch.where(active[:, :, None], pi_draw, pi_est)

    e_sqn = (eps * eps).sum(dim=(1, 2))
    sigmae_new = chisq(
        "sigmae", torch.full_like(e_sqn, V0E + static.n_total),
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
    z_mu = torch.randn((T,), generator=rng.gen(it, "mu"), device=eps.device,
                       dtype=eps.dtype)
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
    dtype = state.eps.dtype
    u_all = torch.rand((nblocks, T, B), generator=rng.gen(it, "u"),
                       device=dev, dtype=dtype)
    z_all = torch.randn((nblocks, T, B), generator=rng.gen(it, "z"),
                        device=dev, dtype=dtype)
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

