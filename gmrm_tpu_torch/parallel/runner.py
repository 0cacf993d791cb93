"""Marker-sharded training over one or more processes (port of
gmrm_tpu/parallel/runner.py).

The replacement for the reference's MPI protocol:

- marker block partition over shards  <- set_block_of_markers
  (bayes.cpp:903-925), remainder to low shards, a common padded per-shard
  length (the Mm idle-step scheme, bayes.cpp:375-382);
- one sum of the residual delta across shards per Gram block  <- the
  per-marker MPI_Allgatherv of (dbeta, mave, msig) and the raw bed column
  replay (bayes.cpp:500-553); block_size=1 reproduces the reference's
  per-marker cadence, larger blocks are the throughput mode;
- sums of the per-group beta^2 and cass once per iteration  <-
  MPI_Allreduce (bayes.cpp:575-589);
- hyperparameter draws keyed by seed and iteration only  <- the rank-0
  MPI_Bcast (bayes.cpp:626-650): every process draws the same values.

A shard belongs to a process, which owns a contiguous run of shard ids
(``distributed.local_shard_ids``) and runs all of them on its one device,
against one residual buffer.  With one process every shard is local; with
``init_distributed`` called first, each process reads only its own shards'
``.bed`` rows (the reference's per-rank load, bayes.cpp:867-900) and
writes only its own marker ranges of the thinned ``.bet``/``.cpn`` records
(the reference's positioned writes, xfiles.hpp:15-38); process 0 writes the
``.csv`` rows.  One shard per process on one card each is the production
layout.

Checkpoints are the topology-portable format v2 of the JAX package
(gmrm_tpu_torch/checkpoint.py): one file per process, marker state in
natural order with global ranges, so a chain saved under one shard or
process count resumes under any other; at the same shard count the resumed
chain is byte-equal to an uninterrupted one whenever the processes sum the
shards' deltas in the same grouping (every split of two shards; one process
against several at more shards sums in another order).  ``--cache-dir``
keeps one startup entry per shard (gmrm_tpu_torch/startup_cache.py).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from gmrm_tpu_torch import checkpoint
from gmrm_tpu_torch.config import Options, resolve_plan
from gmrm_tpu_torch.io.bed import bed_bytes_per_marker, read_bed
from gmrm_tpu_torch.io.grouping import read_dim, read_group_index
from gmrm_tpu_torch.io.phen import read_phen
from gmrm_tpu_torch.io.writers import (
    HistoryWriter, format_csv_record, write_csv_record,
)
from gmrm_tpu_torch.ops import _build
from gmrm_tpu_torch.ops.decode import to_phase_planes
from gmrm_tpu_torch.parallel.distributed import (
    Communicator, is_coordinator, local_shard_ids, process_count,
    process_index,
)
from gmrm_tpu_torch.parallel.mesh import marker_blocks
from gmrm_tpu_torch.runner import (
    LANE_PAD, RunResult, _guard_resume_without_checkpoint,
    check_finite_chain, initial_sigmag, interleave_order, open_outputs,
    replicated_inputs, resolve_device, resume_missing_bet, round_up, run_dtype,
    static_for_markers, stem,
)
from gmrm_tpu_torch.sampler.dists import RngPlan
from gmrm_tpu_torch.sampler.gibbs import gibbs_iteration_sharded
from gmrm_tpu_torch.sampler.state import (
    SamplerState, StaticInputs, init_state, pad_bed, pi_prior_from_cva,
)
from gmrm_tpu_torch.startup_cache import StartupCache


class ShardLayout:
    """Global marker layout: n_shards blocks, each padded to m_pad_shard."""

    def __init__(self, m_total: int, n_shards: int, m_pad_shard: int):
        self.m_total = m_total
        self.blocks = marker_blocks(m_total, n_shards)
        self.n_shards = n_shards
        self.m_pad_shard = m_pad_shard
        self.m_pad = n_shards * m_pad_shard


@dataclass
class ProcessData:
    """Host-side inputs for THIS process's marker shards."""
    n: int
    m_total: int
    mb_pad: int
    layout: ShardLayout
    local_ids: List[int]          # global shard indices on this process
    bed_local: List[np.ndarray]   # per local shard (m_pad_shard, mb_pad)
    group_local: List[np.ndarray]  # per local shard (m_pad_shard,)
    m_local: List[int]            # per local shard, real marker counts
    inv_orders: list              # per local shard: inv map or None
    phens: list
    eps0: np.ndarray              # (T, 4, mb_pad) replicated
    na: np.ndarray                # (T, 4, mb_pad)
    nonas: np.ndarray             # (T,)
    mtotgrp: np.ndarray           # (G,)
    out_basenames: List[str]


def load_data_process(opt: Options, n_shards: int,
                      local_ids: Optional[Sequence[int]] = None,
                      interleave: bool = False) -> ProcessData:
    """Read this process's shards only (reference per-rank load,
    bayes.cpp:867-900: each rank reads offset 3 + S*mbytes).

    ``local_ids`` defaults to all shards (single-process mode).  With
    ``interleave`` (wave mode) each shard's markers are stored
    block-interleaved (``runner.interleave_order``).
    """
    n, m_total = read_dim(opt.dim_file)
    if opt.trunc_markers:
        m_total = min(m_total, opt.trunc_markers)
    blocks = marker_blocks(m_total, n_shards)
    mm = max(ln for _, ln in blocks)
    m_pad_shard = round_up(max(mm, 1), opt.block_size)
    layout = ShardLayout(m_total, n_shards, m_pad_shard)
    local_ids = list(range(n_shards) if local_ids is None else local_ids)

    mb = bed_bytes_per_marker(n)
    mb_pad = round_up(mb, LANE_PAD)

    if opt.group_index_file:
        gidx_all = read_group_index(opt.group_index_file, opt.n_groups)
        if gidx_all.shape[0] < m_total:
            raise IOError(f"group index file has {gidx_all.shape[0]} "
                          f"entries < Mt = {m_total}")
        gidx_all = gidx_all[:m_total]
    else:
        gidx_all = np.zeros(m_total, dtype=np.int32)
    mtotgrp = np.bincount(gidx_all, minlength=opt.n_groups).astype(np.int32)

    bed_parts, grp_parts, mloc, inv_orders = [], [], [], []
    for i in local_ids:
        s, ln = blocks[i]
        bed_i = read_bed(opt.bed_file, n, m_total, s, ln)
        g = np.zeros(m_pad_shard, np.int32)
        g[:ln] = gidx_all[s:s + ln]
        if interleave and ln > 1:
            # Same-block markers end up >= nblocks apart in the genome.
            order, inv = interleave_order(ln, m_pad_shard // opt.block_size)
            bed_i = bed_i[order]
            g[:ln] = g[:ln][order]
            inv_orders.append(inv)
        else:
            inv_orders.append(None)
        bed_parts.append(pad_bed(bed_i, m_pad_shard, mb_pad))
        grp_parts.append(g)
        mloc.append(ln)

    phens = [read_phen(fp, n) for fp in opt.phen_files]
    t = len(phens)
    eps0 = np.zeros((t, 4, mb_pad))
    na = np.zeros((t, 4, mb_pad))
    for i, ph in enumerate(phens):
        eps0[i, :, :mb] = to_phase_planes(ph.epsilon_padded())
        na[i, :, :mb] = to_phase_planes(ph.na_vector_padded())

    return ProcessData(
        n=n, m_total=m_total, mb_pad=mb_pad, layout=layout,
        local_ids=local_ids, bed_local=bed_parts, group_local=grp_parts,
        m_local=mloc, inv_orders=inv_orders, phens=phens, eps0=eps0, na=na,
        nonas=np.array([ph.nonas for ph in phens], np.float64),
        mtotgrp=mtotgrp,
        out_basenames=[stem(fp) for fp in opt.phen_files],
    )


def shard_caches(data: ProcessData, opt: Options
                 ) -> List[Optional[StartupCache]]:
    """The ``--cache-dir`` entry of every local shard (Nones without the
    flag), keyed by its loaded rows, the phen files, its global id and the
    shard layout."""
    if not opt.cache_dir:
        return [None] * len(data.local_ids)
    wave_mode = opt.wave_size > 1
    shared_na = all(ph.nas == 0 for ph in data.phens)
    lay = data.layout
    return [StartupCache(opt.cache_dir, bed, opt.phen_files, dict(
        runner="sharded", n=data.n, m_total=data.m_total,
        n_shards=lay.n_shards, shard=i, marker_range=lay.blocks[i],
        m_pad_shard=lay.m_pad_shard, mb_pad=data.mb_pad,
        block_size=opt.block_size, interleave=wave_mode,
        shared_na=shared_na, gram=wave_mode, dtype=opt.dtype))
        for i, bed in zip(data.local_ids, data.bed_local)]


def build_static_sharded(data: ProcessData, opt: Options, device,
                         caches: Optional[Sequence] = None
                         ) -> List[StaticInputs]:
    """Per local shard: its bed rows, marker statistics (pad rows zeroed)
    and, in wave mode, its own Gram cache
    (gmrm_tpu/parallel/runner.py:670-720), from its ``caches`` entry
    (:func:`shard_caches`) when that holds them.  The replicated inputs are
    one set of tensors shared by every shard's copy."""
    rep = replicated_inputs(data.na, data.nonas, data.mtotgrp, data.n, opt,
                            device)
    shared_na = all(ph.nas == 0 for ph in data.phens)
    caches = caches or [None] * len(data.local_ids)
    return [static_for_markers(bed, grp, ln, rep, opt, shared_na, device,
                               cache)
            for bed, grp, ln, cache in zip(data.bed_local, data.group_local,
                                           data.m_local, caches)]


def init_states_sharded(data: ProcessData, opt: Options,
                        device) -> List[SamplerState]:
    """The start of the chain per local shard
    (gmrm_tpu/parallel/runner.py:747-774): zero marker state per shard, and
    one set of replicated leaves, equal on every process, shared by the
    shards' copies (the residual is one buffer)."""
    t = len(data.phens)
    g, k = opt.cva.shape
    first = init_state(t, data.layout.m_pad_shard, g, k, data.eps0,
                       pi_prior_from_cva(np.asarray(opt.cva)),
                       initial_sigmag(opt, t, data.mtotgrp), device,
                       run_dtype(opt))
    return [first] + [
        first.replace(betas=torch.zeros_like(first.betas),
                      comp=torch.zeros_like(first.comp),
                      acum=torch.zeros_like(first.acum))
        for _ in data.local_ids[1:]]


class ShardedOutputSet:
    """Per-trait .csv/.bet/.cpn writers for sharded runs: process 0 creates
    the files, every process writes its own marker ranges (the reference's
    per-rank positioned writes, xfiles.hpp:15-38).

    ``n_rec`` None: a fresh run; else a resume, and process 0 cuts the
    files back to the checkpoint's ``n_rec`` records
    (gmrm_tpu/parallel/runner.py:336-392).  Whatever may raise here raises
    on every process, before the barrier: raising on process 0 alone would
    leave the others waiting in it.
    """

    def __init__(self, opt: Options, data: ProcessData, comm: Communicator,
                 n_rec: Optional[int] = None):
        self.enabled = bool(opt.out_dir)
        self.csv_paths, self.bet, self.cpn = [], [], []
        if not self.enabled:
            return
        if n_rec is not None:
            resume_missing_bet(opt, data, n_rec)
        if is_coordinator():
            open_outputs(opt, data, n_rec)
        comm.barrier("outputs-create")
        for base in data.out_basenames:
            b = os.path.join(opt.out_dir, base)
            self.csv_paths.append(b + ".csv")
            self.bet.append(HistoryWriter.open_existing(
                b + ".bet", data.m_total, "f8"))
            self.cpn.append(HistoryWriter.open_existing(
                b + ".cpn", data.m_total, "i4"))

    def write_thinned(self, rec, it, host, m0_sum, slices):
        """``host`` holds sigmag/sigmae/pi_est; ``slices`` per local shard
        (global start, betas (T, len), comp (T, len)) in original marker
        order."""
        if not self.enabled:
            return
        for ti in range(len(self.bet)):
            if is_coordinator():
                row = format_csv_record(it, host["sigmag"][ti],
                                        float(host["sigmae"][ti]),
                                        int(m0_sum[ti]), host["pi_est"][ti])
                write_csv_record(self.csv_paths[ti], rec, row)
            for start, betas, comp in slices:
                self.bet[ti].write_record(it, betas[ti], start=start,
                                          rec=rec)
                self.cpn[ti].write_record(it, comp[ti].astype(np.int32),
                                          start=start, rec=rec)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def estimate_sync_seconds(comm: Communicator, nblocks: int, t_traits: int,
                          mb_pad: int, n_groups: int, n_mix: int,
                          timing_iters: int = 20,
                          dtype=torch.float32) -> float:
    """One iteration's collective (sync) cost, measured standalone.

    The sharded sweep's per-iteration communication is ``nblocks``
    dependent sums of the (T, 4, mb_pad) residual delta plus the two small
    sums of the hyperparameter block: the analog of the reference's
    per-marker Allgatherv and per-iteration Allreduce, whose cost it prints
    as "sync time" (bayes.cpp:549-551,653-655).  This runs that sequence of
    collectives alone (same shapes, each depending on the one before) and
    returns seconds per iteration.  An upper bound: a bare chain has no
    compute to overlap with.  Without a process group it is the cost of
    the local adds alone.
    """
    dev = comm.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    eps = torch.randn((t_traits, 4, mb_pad), generator=gen, device=dev,
                      dtype=dtype)

    def chain(eps):
        d = eps * (1.0 + 1e-9 * process_index())
        for _ in range(nblocks):
            s = comm.all_reduce_sum(d.clone())
            eps = eps + s * 1e-9
            d = d + eps * 1e-12
        small = eps.sum() * torch.ones((t_traits, n_groups, n_mix),
                                       device=dev)
        return eps + comm.all_reduce_sum(small)[0, 0, 0]

    out = chain(eps)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(timing_iters):
        out = chain(out * 0.5)
    _sync(dev)
    return (time.perf_counter() - t0) / timing_iters


def measure_sync_seconds(step, states, device, timing_iters: int = 10):
    """Differential in-step sync measurement (the reference's in-loop "sync
    time", bayes.cpp:549-551,653-655).

    ``step(states, it, sync)`` runs one sharded iteration; with ``sync``
    False the sums across processes are skipped (same kernels, same path;
    timing only, the results are wrong across processes).  Both variants
    run on clones of ``states`` and the difference is attributed to the
    collectives.  Returns (sync_seconds, with_seconds, without_seconds).
    """
    def clones():
        eps = states[0].eps.clone()
        return [st.replace(eps=eps) for st in states]

    def run(sync):
        s = step(clones(), 1, sync)
        _sync(device)
        t0 = time.perf_counter()
        for k in range(timing_iters):
            s = step(s, 2 + k, sync)
        _sync(device)
        return (time.perf_counter() - t0) / timing_iters

    t_with = run(True)
    t_without = run(False)
    return max(0.0, t_with - t_without), t_with, t_without


def _host_slices(states, data: ProcessData):
    """Per local shard (global start, betas, comp) of the real markers as
    NumPy arrays in original marker order."""
    out = []
    for st, i, ln, inv in zip(states, data.local_ids, data.m_local,
                              data.inv_orders):
        start = data.layout.blocks[i][0]
        betas = st.betas[:, :ln].cpu().numpy()
        comp = st.comp[:, :ln].cpu().numpy()
        if inv is not None:
            betas, comp = betas[:, inv], comp[:, inv]
        out.append((start, betas, comp))
    return out


def _sharded_checkpoint_plan(opt: Options, data: ProcessData,
                             comm: Communicator):
    """(this process's checkpoint path or None, the checkpoint files to
    resume from, empty for a fresh start), after the housekeeping of
    gmrm_tpu/parallel/runner.py:838-862.  The barriers' conditions are the
    same on every process (flags only), and every process reaches the same
    verdict from the shared out-dir."""
    ckpt = None
    if opt.out_dir and (opt.checkpoint_every or opt.resume):
        if is_coordinator():
            opt.ensure_out_dir()
        comm.barrier("ckpt-dir")
        ckpt = checkpoint.sharded_checkpoint_path(
            opt.out_dir, process_index(), process_count())
    if not opt.resume and opt.out_dir:
        if is_coordinator() and os.path.isdir(opt.out_dir):
            checkpoint._clear_ckpt_files(opt.out_dir)
        comm.barrier("ckpt-clear")
    srcs = (checkpoint._ckpt_files(opt.out_dir)
            if opt.resume and opt.out_dir else [])
    if opt.resume and opt.out_dir and not srcs:
        _guard_resume_without_checkpoint(opt, data)
    return ckpt, srcs


def run_training_sharded(opt: Options, n_devices: int = 0, device=None,
                         verbose: bool = True) -> RunResult:
    """The --process path over marker shards (None means CUDA).

    ``n_devices`` is the number of shards, 0 for one per process.  Works
    single-process (every shard local, all on the one device) and
    multi-process (call ``gmrm_tpu_torch.parallel.distributed
    .init_distributed`` first; each process loads, sweeps and writes only
    its own shards).  ``RunResult.state`` is the list of this process's
    per-shard states, and ``beta_mean`` covers its marker ranges only.
    """
    dev = resolve_device(device)
    comm = Communicator(dev)
    chatty = verbose and is_coordinator()
    launches0 = _build.launch_counts()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt.validate()
    if opt.cva is None:
        opt.load_group_mixtures()
    n_shards = n_devices or process_count()
    local_ids = local_shard_ids(n_shards)
    t_start = time.perf_counter()
    # The wave guard looks at the smallest shard, before the interleave
    # decision: the storage layout follows the resolved wave.
    _, m_pre = read_dim(opt.dim_file)
    if opt.trunc_markers:
        m_pre = min(m_pre, opt.trunc_markers)
    resolve_plan(opt, dev.type, m_pre // n_shards, verbose=chatty,
                 sharded=True)
    data = load_data_process(opt, n_shards, local_ids,
                             interleave=opt.wave_size > 1)
    if chatty:
        print(f"INFO   : time to load genotype + phenotype data = "
              f"{time.perf_counter() - t_start:.2f} seconds "
              f"({len(local_ids)} of {n_shards} shards on this process).")
    ckpt, srcs = _sharded_checkpoint_plan(opt, data, comm)
    caches = shard_caches(data, opt)
    statics = build_static_sharded(data, opt, dev, caches)
    t = len(data.phens)
    n_rec, start_it = 0, 1
    if srcs:
        states, last_it, beta_acc, n_rec = \
            checkpoint.load_sharded_checkpoint(
                srcs, data.layout, local_ids, data.inv_orders, dev, opt.seed,
                run_dtype(opt))
        start_it = last_it + 1
        if chatty:
            print(f"INFO   : resuming sharded run from iteration {last_it}")
    else:
        states = init_states_sharded(data, opt, dev)
        beta_acc = np.zeros((t, data.m_total), np.float64)
    if chatty and caches[0] is not None and all(c.warm for c in caches):
        print(f"INFO   : warm sharded startup from {caches[0].path}")
    rngs = [RngPlan(opt.seed, dev, shard=i) for i in local_ids]
    _sync(dev)
    result = RunResult(state=states,
                       startup_seconds=time.perf_counter() - t_start,
                       caches=[c for c in caches if c is not None])
    outputs = ShardedOutputSet(opt, data, comm, n_rec if srcs else None)

    def step(states, it, sync=True):
        c = comm if sync else Communicator(dev, enabled=False)
        return gibbs_iteration_sharded(
            states, statics, it, rngs, block_size=opt.block_size,
            wave=opt.wave_size, comm=c, shuffle=opt.shuffle_markers)[0]

    # The reference's per-iteration "with sync time = ..." observable
    # (bayes.cpp:653-655): at verbosity 1 the collectives alone, at
    # verbosity >= 2 the real step against the step without them.
    sync_est, sync_how = None, ""
    nblocks = data.layout.m_pad_shard // opt.block_size
    if verbose and opt.verbosity_level(2):
        sync_est, t_w, t_wo = measure_sync_seconds(step, states, dev)
        sync_how = "in-step differential"
        if chatty:
            print(f"INFO   : measured in-step sync cost = "
                  f"{sync_est * 1000:.3f} ms/iteration "
                  f"({t_w * 1000:.3f} with collectives, "
                  f"{t_wo * 1000:.3f} elided)")
    elif verbose and opt.verbosity_level(1):
        g, k = opt.cva.shape
        sync_est = estimate_sync_seconds(comm, nblocks, t, data.mb_pad, g, k,
                                         dtype=run_dtype(opt))
        sync_how = "standalone collective chain"
        if chatty:
            print(f"INFO   : measured collective sync cost = "
                  f"{sync_est * 1000:.3f} ms/iteration "
                  f"({nblocks} sums of {t}x4x{data.mb_pad} "
                  f"{'f64' if opt.dtype == 'float64' else 'f32'})")

    ranges = [data.layout.blocks[i] for i in local_ids]
    t_chain = time.perf_counter()
    for it in range(start_it, opt.iterations + 1):
        t0 = time.perf_counter()
        states, aux = gibbs_iteration_sharded(
            states, statics, it, rngs, block_size=opt.block_size,
            wave=opt.wave_size, comm=comm, shuffle=opt.shuffle_markers)
        if it % opt.output_thin_rate == 0:
            first = states[0]
            host = {k: getattr(first, k).cpu().numpy().astype(np.float64)
                    for k in ("sigmag", "sigmae", "pi_est")}
            check_finite_chain(host["sigmag"], host["sigmae"], it)
            slices = _host_slices(states, data)
            outputs.write_thinned(n_rec, it, host,
                                  aux.m0.cpu().numpy().sum(axis=1), slices)
            for start, betas, _ in slices:
                beta_acc[:, start:start + betas.shape[1]] += betas
            n_rec += 1
            if chatty:
                sg_sum = host["sigmag"].sum(axis=1)
                for ti in range(t):
                    print(f"RESULT : i:{it} p:{ti}  sum sigmaG = "
                          f"{sg_sum[ti]:20.15f}  sigmaE = "
                          f"{host['sigmae'][ti]:20.15f}")
        if verbose and opt.verbosity_level(1):
            _sync(dev)
            if chatty:
                print(f"RESULT : It {it}  total proc time = "
                      f"{time.perf_counter() - t0:7.3f} sec, with sync time "
                      f"= {sync_est:7.3f} sec (measured {sync_how})")
        result.iter_seconds.append(time.perf_counter() - t0)
        if ckpt and opt.checkpoint_every and it % opt.checkpoint_every == 0:
            checkpoint.save_sharded_checkpoint(
                ckpt, states, it, ranges, data.inv_orders, beta_acc, n_rec,
                opt.seed, checkpoint.layout_of(opt, data.m_total))

    check_finite_chain(states[0].sigmag.cpu().numpy(),
                       states[0].sigmae.cpu().numpy(), opt.iterations)
    result.chain_seconds = time.perf_counter() - t_chain
    result.iters_run = max(0, opt.iterations - start_it + 1)
    result.state = states
    result.kernel_launches = {k: v - launches0[k]
                              for k, v in _build.launch_counts().items()}
    if n_rec:
        # Only this process's marker ranges: complete on a single-process
        # run, per-process partial otherwise.
        result.beta_mean = beta_acc / n_rec
    return result

