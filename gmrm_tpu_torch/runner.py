"""End-to-end single-device training (port of gmrm_tpu/runner.py); the
marker-sharded runner, gmrm_tpu_torch/parallel/runner.py, builds on it.

Loads the inputs, builds the static inputs (marker statistics, and the
Gram cache in wave mode), runs the Gibbs chain and writes the reference's
``.csv`` / ``.bet`` / ``.cpn`` artifacts.  In wave mode (W > 1) an
iteration's sweep is one launch of the whole-sweep kernel
(ops/sweep_kernel.sweep_blocks) between two CUDA graphs of the host's
arithmetic (sampler/whole_sweep.py); at W = 1 it is the per-block exact
serial path.  Iterations are queued back to back; the host waits on the
device only at thin boundaries, at checkpoints and at the end of the chain.
``--dtype float64`` runs the W = 1 path with every float tensor of the
chain in float64 (``run_dtype``) on the float64 kernels.

``--checkpoint-every N`` saves the chain every N iterations
(gmrm_tpu_torch/checkpoint.py) and ``--resume`` continues it from the
checkpoint in the out-dir, byte-equal to an uninterrupted chain;
``--cache-dir`` keeps the startup's statistics and Gram cache between runs
(gmrm_tpu_torch/startup_cache.py).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from gmrm_tpu_torch import checkpoint
from gmrm_tpu_torch.config import Options, resolve_plan
from gmrm_tpu_torch.io.bed import bed_bytes_per_marker, read_bed
from gmrm_tpu_torch.io.grouping import read_dim, read_group_index
from gmrm_tpu_torch.io.phen import Phenotype, read_phen
from gmrm_tpu_torch.io.writers import (
    HistoryWriter, format_csv_record, truncate_csv_to, write_csv_record,
)
from gmrm_tpu_torch.ops import _build
from gmrm_tpu_torch.ops.blockops import marker_stats
from gmrm_tpu_torch.ops.decode import to_phase_planes
from gmrm_tpu_torch.ops.sweep_kernel import build_gram_cache
from gmrm_tpu_torch.sampler.dists import RngPlan, beta_11
from gmrm_tpu_torch.sampler.gibbs import gibbs_iteration
from gmrm_tpu_torch.sampler.state import (
    SamplerState, StaticInputs, init_state, pad_bed, pi_prior_from_cva,
)
from gmrm_tpu_torch.sampler.whole_sweep import WholeSweepIteration
from gmrm_tpu_torch.startup_cache import StartupCache


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def run_dtype(opt: Options) -> torch.dtype:
    """The chain's float dtype, from ``--dtype``."""
    return torch.float64 if opt.dtype == "float64" else torch.float32


def resolve_device(device=None) -> torch.device:
    """None means CUDA; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; gmrm_tpu_torch runs on "
                           "an NVIDIA GPU (pass device='cpu' to run the "
                           "plain PyTorch versions of its kernels)")
    return dev


@dataclass
class LoadedData:
    """Host-side preprocessed inputs."""
    n: int
    m_total: int
    m_local: int
    mb_pad: int
    m_pad: int
    bed: np.ndarray              # (m_pad, mb_pad) uint8
    phens: List[Phenotype]
    eps0: np.ndarray             # (T, 4, mb_pad)
    na: np.ndarray               # (T, 4, mb_pad)
    nonas: np.ndarray            # (T,)
    group_of: np.ndarray         # (m_pad,) int32
    mtotgrp: np.ndarray          # (G,) int32
    out_basenames: List[str]
    # Original-order values = stored[:, inv_order]: the inverse of the
    # block interleave in wave mode, the identity at W = 1.
    inv_order: np.ndarray


def interleave_order(m_local: int, nblocks: int):
    """Stride interleave of the markers across Gram blocks.

    Block membership is permanent under the block-preserving shuffle, so
    genomically adjacent (high-LD) markers sharing a block would share a
    wave, blind to each other's moves.  Storing marker j at the
    stable-sorted position of key (j mod nblocks) puts consecutive markers
    in consecutive blocks (gmrm_tpu/runner.py:66).
    Returns (order, inv): storage row i holds original marker order[i];
    original-order values = stored[inv].
    """
    order = np.argsort(np.arange(m_local) % max(nblocks, 1), kind="stable")
    inv = np.argsort(order, kind="stable")
    return order, inv


def stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


LANE_PAD = 512        # packed bytes per marker row, padded with 0x55


def load_data(opt: Options) -> LoadedData:
    """Read and preprocess all inputs (gmrm_tpu/runner.py:94, whole marker
    range of one device) for the resolved plan ``opt.wave_size``.  Storage
    is block-interleaved in wave mode (W > 1) only, as gmrm_tpu does
    (runner.py:446)."""
    n, m_total = read_dim(opt.dim_file)
    if opt.trunc_markers:
        m_total = min(m_total, opt.trunc_markers)
    n_markers = m_total
    mb = bed_bytes_per_marker(n)
    mb_pad = round_up(mb, LANE_PAD)
    m_pad = round_up(max(n_markers, 1), opt.block_size)

    bed = read_bed(opt.bed_file, n, m_total, 0, n_markers)
    if opt.wave_size > 1:
        order, inv_order = interleave_order(n_markers,
                                            m_pad // opt.block_size)
        bed = bed[order]
    else:
        order = inv_order = np.arange(n_markers)
    bed = pad_bed(bed, m_pad, mb_pad)

    phens = [read_phen(fp, n) for fp in opt.phen_files]
    t = len(phens)
    eps0 = np.zeros((t, 4, mb_pad))
    na = np.zeros((t, 4, mb_pad))
    for i, ph in enumerate(phens):
        eps0[i, :, :mb] = to_phase_planes(ph.epsilon_padded())
        na[i, :, :mb] = to_phase_planes(ph.na_vector_padded())
    nonas = np.array([ph.nonas for ph in phens], dtype=np.float64)

    if opt.group_index_file:
        gidx_all = read_group_index(opt.group_index_file, opt.n_groups)
        if gidx_all.shape[0] < m_total:
            raise IOError(f"group index file has {gidx_all.shape[0]} "
                          f"entries < Mt = {m_total}")
        gidx_all = gidx_all[:m_total]
    else:
        gidx_all = np.zeros(m_total, dtype=np.int32)
    group_of = np.zeros(m_pad, dtype=np.int32)
    group_of[:n_markers] = gidx_all[order]
    mtotgrp = np.bincount(gidx_all, minlength=opt.n_groups).astype(np.int32)

    return LoadedData(
        n=n, m_total=m_total, m_local=n_markers, mb_pad=mb_pad,
        m_pad=m_pad, bed=bed, phens=phens, eps0=eps0, na=na,
        nonas=nonas, group_of=group_of, mtotgrp=mtotgrp,
        out_basenames=[stem(fp) for fp in opt.phen_files],
        inv_order=inv_order,
    )


def shared_na_of(data: LoadedData) -> bool:
    """One NA mask serves every trait when no phenotype has NAs."""
    return all(ph.nas == 0 for ph in data.phens)


def replicated_inputs(na, nonas, mtotgrp, n: int, opt: Options,
                      device) -> dict:
    """The static inputs that are the same for every marker, and on a
    sharded run for every shard, as tensors on ``device`` in the run's
    dtype."""
    dty = run_dtype(opt)
    return dict(
        na=torch.as_tensor(na, dtype=dty, device=device).contiguous(),
        nonas=torch.as_tensor(nonas, dtype=dty, device=device),
        mtotgrp=torch.as_tensor(mtotgrp, dtype=torch.int64, device=device),
        cva=torch.as_tensor(opt.cva, dtype=dty, device=device),
        cvai=torch.as_tensor(opt.cvai, dtype=dty, device=device),
        n_total=float(n))


def static_for_markers(bed: np.ndarray, group_of: np.ndarray, m_local: int,
                       rep: dict, opt: Options, shared_na: bool,
                       device, cache: Optional[StartupCache] = None
                       ) -> StaticInputs:
    """The static inputs of one device's, or one shard's, markers: bed
    (m_pad, mb_pad) with ``m_local`` real rows, their statistics and, in
    wave mode, their Gram cache; ``rep`` from :func:`replicated_inputs`.
    With ``cache``, the statistics and the Gram cache come from its entry
    when it has one, and are saved to it when they are built."""
    bed = torch.as_tensor(bed, device=device)
    warm = None if cache is None else cache.load(device, rep["na"].dtype)
    if warm is not None:
        mave, msig, gram_cache = warm
    else:
        mave, msig = marker_stats(bed, rep["na"], rep["nonas"])
        # Zero the stats of pad rows (all-missing decode gives 0/0).
        valid = (torch.arange(bed.shape[0], device=device) < m_local)[None]
        mave = torch.where(valid, mave, 0.0).contiguous()
        msig = torch.where(valid, msig, 0.0).contiguous()
        gram_cache = None
        if opt.wave_size > 1:
            gram_cache = build_gram_cache(bed, rep["na"],
                                          block_size=opt.block_size,
                                          shared_na=shared_na)
        if cache is not None:
            cache.save(mave, msig, gram_cache)
    return StaticInputs(
        bed=bed, mave=mave, msig=msig,
        group_of=torch.as_tensor(group_of, dtype=torch.int64, device=device),
        m_local=int(m_local), gram_cache=gram_cache, shared_na=shared_na,
        **rep)


def startup_cache(data: LoadedData, opt: Options) -> Optional[StartupCache]:
    """The ``--cache-dir`` entry of a single-device run (None without the
    flag), keyed by the loaded rows, the phen files and the geometry, the
    dtype of the statistics included."""
    if not opt.cache_dir:
        return None
    wave_mode = opt.wave_size > 1
    return StartupCache(opt.cache_dir, data.bed, opt.phen_files, dict(
        runner="one device", n=data.n, m_total=data.m_total,
        m_pad=data.m_pad, mb_pad=data.mb_pad, block_size=opt.block_size,
        interleave=wave_mode, shared_na=shared_na_of(data),
        gram=wave_mode, dtype=opt.dtype))


def build_static(data: LoadedData, opt: Options, device,
                 cache: Optional[StartupCache] = None) -> StaticInputs:
    """Marker statistics, and in wave mode the one-time Gram cache, from
    ``cache`` (:func:`startup_cache`) when it holds them; W = 1 recomputes
    each block's Gram in the sweep (gmrm_tpu/runner.py:223-225)."""
    rep = replicated_inputs(data.na, data.nonas, data.mtotgrp, data.n, opt,
                            device)
    return static_for_markers(data.bed, data.group_of, data.m_local, rep,
                              opt, shared_na_of(data), device, cache)


def initial_sigmag(opt: Options, n_traits: int, mtotgrp) -> np.ndarray:
    """sigmaG ~ Beta(1,1) per group, 0 for empty groups (bayes.cpp:327);
    drawn on the CPU so the start does not depend on the device, nor, on a
    sharded run, on the process."""
    g = opt.cva.shape[0]
    sigmag0 = beta_11(RngPlan(opt.seed, "cpu").gen(0, "init"),
                      (n_traits, g)).numpy()
    return np.where(np.asarray(mtotgrp)[None, :] == 0, 0.0, sigmag0)


def init_sampler_state(data: LoadedData, opt: Options,
                       device) -> SamplerState:
    """The start of the chain: zero effects, the prior mixture
    probabilities and :func:`initial_sigmag`, in the run's dtype."""
    t = len(data.phens)
    g, k = opt.cva.shape
    return init_state(t, data.m_pad, g, k, data.eps0,
                      pi_prior_from_cva(np.asarray(opt.cva)),
                      initial_sigmag(opt, t, data.mtotgrp), device,
                      run_dtype(opt))


@dataclass
class RunResult:
    state: SamplerState
    iter_seconds: List[float] = field(default_factory=list)
    beta_mean: Optional[np.ndarray] = None   # (T, M) posterior mean
    chain_seconds: float = 0.0               # wall-clock of the chain
    startup_seconds: float = 0.0             # load + stats (+ Gram cache)
    iters_run: int = 0                       # iterations run by this call
    kernel_launches: dict = field(default_factory=dict)  # in this run
    # The --cache-dir entries of the run (one, or one per local shard).
    caches: List[StartupCache] = field(default_factory=list)


def _guard_resume_without_checkpoint(opt: Options, data) -> None:
    """--resume with no checkpoint: a fresh start is fine in an empty
    out-dir, but would silently destroy a previous chain's outputs
    (gmrm_tpu/runner.py:310-323)."""
    existing = [b for b in data.out_basenames
                if os.path.exists(os.path.join(opt.out_dir, b + ".bet"))]
    if existing:
        raise ValueError(
            f"--resume requested but no checkpoint found in "
            f"{opt.out_dir}, which already holds chain outputs "
            f"({existing[0]}.bet ...).  A fresh run would destroy them: "
            f"drop --resume to restart deliberately, or restore the "
            f"checkpoint file.")


def resume_missing_bet(opt: Options, data, n_rec: int) -> None:
    """A checkpoint that counts ``n_rec`` thinned records whose ``.bet`` is
    gone: refuse, rather than write a history whose first records are
    zeros (gmrm_tpu/runner.py:360-369)."""
    if not n_rec:
        return
    for base in data.out_basenames:
        b = os.path.join(opt.out_dir, base)
        if not os.path.exists(b + ".bet"):
            raise IOError(
                f"resume: checkpoint records {n_rec} thinned rows but "
                f"{b}.bet is missing — restore the output files or restart "
                f"the chain.")


def open_outputs(opt: Options, data, n_rec: Optional[int]) -> None:
    """Create each trait's .bet/.cpn, deleting its .csv (a fresh run,
    ``n_rec`` None; the reference's delete-then-create,
    phenotype.cpp:129-203), or keep them and cut them back to the
    checkpoint's ``n_rec`` records (a resume: rows written after the
    checkpoint are stale)."""
    opt.ensure_out_dir()
    for base in data.out_basenames:
        b = os.path.join(opt.out_dir, base)
        if n_rec is not None and os.path.exists(b + ".bet"):
            for suffix, kind in ((".bet", "f8"), (".cpn", "i4")):
                HistoryWriter.open_existing(b + suffix, data.m_total,
                                            kind).truncate_to(n_rec)
            truncate_csv_to(b + ".csv", n_rec)
            continue
        if n_rec is None and os.path.exists(b + ".csv"):
            os.remove(b + ".csv")
        HistoryWriter(b + ".bet", data.m_total, "f8")
        HistoryWriter(b + ".cpn", data.m_total, "i4")


class OutputSet:
    """Per-trait .csv/.bet/.cpn writers (reference phenotype.cpp:129-203).
    ``n_rec`` None: a fresh run; else a resume from a checkpoint that
    counts ``n_rec`` records (:func:`open_outputs`)."""

    def __init__(self, opt: Options, data: LoadedData,
                 n_rec: Optional[int] = None):
        self.enabled = bool(opt.out_dir)
        self.csv_paths, self.bet, self.cpn = [], [], []
        if not self.enabled:
            return
        if n_rec is not None:
            resume_missing_bet(opt, data, n_rec)
        open_outputs(opt, data, n_rec)
        for base in data.out_basenames:
            b = os.path.join(opt.out_dir, base)
            self.csv_paths.append(b + ".csv")
            self.bet.append(HistoryWriter.open_existing(
                b + ".bet", data.m_total, "f8"))
            self.cpn.append(HistoryWriter.open_existing(
                b + ".cpn", data.m_total, "i4"))

    def write_thinned(self, rec: int, it: int, host: dict, m0: np.ndarray,
                      data: LoadedData):
        """``host`` holds sigmag/sigmae/pi_est and natural-order betas/comp
        (T, m_local) as NumPy arrays."""
        if not self.enabled:
            return
        for ti in range(len(self.bet)):
            row = format_csv_record(it, host["sigmag"][ti],
                                    float(host["sigmae"][ti]),
                                    int(m0[ti].sum()), host["pi_est"][ti])
            write_csv_record(self.csv_paths[ti], rec, row)
            self.bet[ti].write_record(it, host["betas"][ti], rec=rec)
            self.cpn[ti].write_record(it, host["comp"][ti], rec=rec)


_SIGMA_DIVERGED = 1.0e6


def check_finite_chain(sigmag, sigmae, it: int) -> None:
    """Fail loudly on a divergent chain (non-finite or exploding variances;
    valid chains have sigmaE + sum sigmaG ~ 1 on the scaled phenotypes)."""
    sg = np.asarray(sigmag, np.float64)
    se = np.asarray(sigmae, np.float64)
    bad = (not (np.isfinite(sg).all() and np.isfinite(se).all())
           or se.max(initial=0.0) > _SIGMA_DIVERGED
           or sg.max(initial=0.0) > _SIGMA_DIVERGED)
    if bad:
        raise FloatingPointError(
            f"FATAL  : chain diverged by iteration {it} (non-finite or "
            f"exploding sigmaG/sigmaE).  On small panels with extreme "
            f"local LD the wave relaxation can be unstable — rerun with a "
            f"smaller --block-size, or with --wave-size 1.")


def _host_record(state: SamplerState, data: LoadedData) -> dict:
    """One device-to-host copy of what a thinned record needs, with the
    marker axis back in original order."""
    ml = data.m_local
    host = {k: getattr(state, k).cpu().numpy()
            for k in ("sigmag", "sigmae", "pi_est")}
    for k in ("betas", "comp"):
        x = getattr(state, k)[:, :ml].cpu().numpy()
        host[k] = x[:, data.inv_order]
    return host


def iteration_step(state: SamplerState, static: StaticInputs, rng: RngPlan,
                   opt: Options):
    """One iteration of the chain as ``step(it) -> (state, aux)``: in wave
    mode the whole-sweep iteration with its host work in two CUDA graphs
    (sampler/whole_sweep.py; eager on the CPU), which updates ``state`` in
    place; at W = 1 ``gibbs_iteration``."""
    if opt.wave_size > 1:
        return WholeSweepIteration(state, static, rng,
                                   block_size=opt.block_size,
                                   wave=opt.wave_size,
                                   shuffle=opt.shuffle_markers)

    def step(it):
        nonlocal state
        state, aux = gibbs_iteration(state, static, it, rng,
                                     block_size=opt.block_size,
                                     wave=opt.wave_size,
                                     shuffle=opt.shuffle_markers)
        return state, aux
    return step


def _checkpoint_plan(opt: Options, data: LoadedData):
    """(checkpoint path or None, whether to resume from it), after the
    housekeeping of gmrm_tpu/runner.py:474-500: a fresh run clears stale
    checkpoint files; --resume with no checkpoint refuses when sharded
    checkpoints or a previous chain's outputs are there, and else starts
    fresh."""
    ckpt = None
    if opt.out_dir and (opt.checkpoint_every or opt.resume):
        opt.ensure_out_dir()
        ckpt = checkpoint.checkpoint_path(opt.out_dir)
    if not opt.resume and opt.out_dir and os.path.isdir(opt.out_dir):
        checkpoint._clear_ckpt_files(opt.out_dir)
    resuming = bool(opt.resume and ckpt and os.path.exists(ckpt))
    if opt.resume and ckpt and not resuming:
        others = checkpoint._ckpt_files(opt.out_dir)
        if others:
            raise ValueError(
                f"--resume: no {ckpt}, but per-process sharded checkpoints "
                f"exist ({[os.path.basename(f) for f in others]}) — resume "
                f"with the sharded runner (which accepts any process "
                f"layout) instead of the single-device runner; a fresh run "
                f"here would overwrite that chain's outputs.")
        _guard_resume_without_checkpoint(opt, data)
    return ckpt, resuming


def run_training(opt: Options, device=None, verbose: bool = True
                 ) -> RunResult:
    """The --process path on one device (None means CUDA)."""
    dev = resolve_device(device)
    launches0 = _build.launch_counts()
    # f32 stays f32: the c-dot/Gram arithmetic is held to the JAX package
    # at f32 tolerances, and TF32 keeps only ~3 decimal digits.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt.validate()
    if opt.cva is None:
        opt.load_group_mixtures()
    t_start = time.perf_counter()
    _, m_pre = read_dim(opt.dim_file)
    if opt.trunc_markers:
        m_pre = min(m_pre, opt.trunc_markers)
    resolve_plan(opt, dev.type, m_pre, verbose=verbose)
    data = load_data(opt)
    if verbose:
        print(f"INFO   : time to load genotype + phenotype data = "
              f"{time.perf_counter() - t_start:.2f} seconds.")
        # Per-phenotype NA detail at --verbosity 2, as the reference
        # (phenotype.cpp:610-627) and gmrm_tpu print it.
        if opt.verbosity_level(2):
            for ph in data.phens:
                print(f"INFO   : {ph.filepath} has {ph.nas} NAs and "
                      f"{ph.nonas} non-NAs.")
    ckpt, resuming = _checkpoint_plan(opt, data)
    t0 = time.perf_counter()
    cache = startup_cache(data, opt)
    static = build_static(data, opt, dev, cache)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if verbose:
        if cache is not None and cache.warm:
            print(f"INFO   : warm startup from {cache.path}")
        what = " and the Gram cache" if static.gram_cache is not None else ""
        print(f"INFO   : time to compute the markers' statistics{what}: "
              f"{time.perf_counter() - t0:.2f} seconds.")
    n_rec, start_it = 0, 1
    if resuming:
        state, last_it, beta_acc, n_rec = checkpoint.load_checkpoint(
            ckpt, dev, opt.seed, checkpoint.layout_of(opt, data.m_total),
            run_dtype(opt))
        start_it = last_it + 1
        if verbose:
            print(f"INFO   : resuming from checkpoint at iteration {last_it}")
    else:
        state = init_sampler_state(data, opt, dev)
        beta_acc = np.zeros((len(data.phens), data.m_local))
    result = RunResult(state=state,
                       startup_seconds=time.perf_counter() - t_start,
                       caches=[cache] if cache is not None else [])
    outputs = OutputSet(opt, data, n_rec if resuming else None)
    rng = RngPlan(opt.seed, dev)

    # Built from the loaded state on a resume: the W > 1 iteration owns it,
    # and its first call runs eagerly with first = (it == 1), as an
    # uninterrupted chain's does.
    step = iteration_step(state, static, rng, opt)
    t_chain = time.perf_counter()
    for it in range(start_it, opt.iterations + 1):
        t0 = time.perf_counter()
        state, aux = step(it)
        if it % opt.output_thin_rate == 0:
            host = _host_record(state, data)
            check_finite_chain(host["sigmag"], host["sigmae"], it)
            outputs.write_thinned(n_rec, it, host, aux.m0.cpu().numpy(),
                                  data)
            beta_acc += host["betas"]
            n_rec += 1
            if verbose:
                sg_sum = host["sigmag"].sum(axis=1)
                for ti in range(sg_sum.shape[0]):
                    print(f"RESULT : i:{it} p:{ti}  sum sigmaG = "
                          f"{sg_sum[ti]:20.15f}  sigmaE = "
                          f"{host['sigmae'][ti]:20.15f}")
        if verbose and opt.verbosity_level(1):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            print(f"RESULT : It {it}  total proc time = "
                  f"{time.perf_counter() - t0:7.3f} sec")
        result.iter_seconds.append(time.perf_counter() - t0)
        if ckpt and opt.checkpoint_every and it % opt.checkpoint_every == 0:
            checkpoint.save_checkpoint(
                ckpt, state, it, beta_acc, n_rec, opt.seed,
                checkpoint.layout_of(opt, data.m_total))

    check_finite_chain(state.sigmag.cpu().numpy(),
                       state.sigmae.cpu().numpy(), opt.iterations)
    result.chain_seconds = time.perf_counter() - t_chain
    result.iters_run = max(0, opt.iterations - start_it + 1)
    result.state = state
    result.kernel_launches = {k: v - launches0[k]
                              for k, v in _build.launch_counts().items()}
    if n_rec:
        result.beta_mean = beta_acc / n_rec
    return result
