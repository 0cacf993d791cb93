"""Run options and compute-plan resolution for the port.

``Options``, ``OptionsError`` and the sampler's fixed hyper-priors are the
port's own copy of gmrm_tpu/config.py (the reference CLI's option surface,
``src/options.{hpp,cpp}``), so that nothing here imports the JAX package.
Left out: ``Options.resolve_compute_plan``, which asks JAX for its
backend, the TPU-only ``Options.check_group_limit`` and the VMEM ceiling
on ``--block-size``; ``resolve_plan`` and ``check_slice`` below take their
place.

The plan is the same on CPU and CUDA, so the CPU tests run the same sweep
as the card, with each kernel's plain PyTorch version: the auto wave is 32
(else 16, else 8) dividing the block size, and 1 (the exact serial sweep)
when none divides it, when the panel has fewer than 64 blocks, with
``--use-pallas 0`` or with ``--dtype float64`` (the plan the JAX package's
float64 run resolves to, gmrm_tpu/config.py:141-155: it computes no
float64 chain at W > 1).  Wave mode (W > 1) sweeps through the whole-sweep
kernel, one launch per iteration (ops/sweep_kernel.sweep_blocks); a
marker-sharded run (``--devices S`` with S > 1, or a process group) sweeps
block by block through the fused per-block kernel
(ops/sweep_kernel.block_sweep), and its plan guards the wave on the
markers of one shard.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


class OptionsError(ValueError):
    """Raised for invalid or inconsistent run options."""


@dataclass
class Options:
    # Input files (reference options.cpp:26-63)
    bed_file: str = ""
    dim_file: str = ""
    phen_files: List[str] = field(default_factory=list)
    group_index_file: str = ""
    group_mixture_file: str = ""
    bim_file: str = ""
    ref_bim_file: str = ""

    # Run control (reference options.cpp:64-151; defaults at options.hpp:49-56)
    verbosity: int = 0
    shuffle_markers: bool = True
    mimic_hydra: bool = False
    seed: int = 0
    iterations: int = 1
    trunc_markers: int = 0          # 0 = no truncation
    out_dir: str = ""
    output_thin_rate: int = 1
    predict: bool = False

    # Accelerator knobs (no reference analog)
    block_size: int = 128           # markers per Gram block (sync cadence)
    wave_size: Optional[int] = None  # markers per serial step within a block
                                    # (1 = exact serial; W>1 = the same
                                    # relaxation as W co-scheduled shards,
                                    # see ops/scan_kernel_wave.py).  None =
                                    # auto: resolve_plan picks 32, 16 or
                                    # 8, whichever divides block_size,
                                    # else 1.
    dtype: str = "float32"          # compute dtype for residual/accumulations
    use_pallas: Optional[bool] = None  # False = the exact serial W=1 path
    n_devices: int = 0              # 0 = all visible devices
    checkpoint_every: int = 0       # 0 = no checkpointing (improvement over ref)
    resume: bool = False
    cache_dir: str = ""             # persist marker stats + Gram cache
                                    # across runs of the same dataset
                                    # ("" = rebuild each run, like the
                                    # reference)

    # Parsed group-mixture matrices (set by load_group_mixtures)
    cva: Optional[np.ndarray] = None    # (G, K) mixture variances
    cvai: Optional[np.ndarray] = None   # (G, K) inverse variances (0 in col 0)

    @property
    def n_groups(self) -> int:
        return 0 if self.cva is None else self.cva.shape[0]

    @property
    def n_mixtures(self) -> int:
        return 0 if self.cva is None else self.cva.shape[1]

    def validate(self) -> None:
        """Minimal-setup checks, mirroring reference check_options (options.cpp:175-220)."""
        if not self.bed_file:
            raise OptionsError("no bed file provided! Please use the --bed-file option.")
        if not self.dim_file:
            raise OptionsError("no dim file provided! Please use the --dim-file option.")
        if not self.phen_files:
            raise OptionsError("no phen file(s) provided! Please use the --phen-files option.")
        for fp in self.phen_files:
            if not os.path.isfile(fp):
                raise OptionsError(f"file {fp} not found")
        if not self.predict:
            if bool(self.group_index_file) != bool(self.group_mixture_file):
                raise OptionsError(
                    "you need to activate BOTH --group-index-file and --group-mixture-file"
                )
        if self.predict:
            if not self.bim_file:
                raise OptionsError(
                    "you need to pass a bim file with --bim-file when activating --predict"
                )
            if not self.ref_bim_file:
                raise OptionsError(
                    "you need to pass a reference bim file with --ref-bim-file "
                    "when activating --predict"
                )
        if self.mimic_hydra and len(self.phen_files) > 1:
            raise OptionsError("with --mimic-hydra, only a single phenotype can be processed.")
        if self.seed < 0:
            raise OptionsError("option --seed has to be a positive integer!")
        if self.iterations < 1:
            raise OptionsError("option --iterations has to be a strictly positive integer!")
        if self.output_thin_rate < 1:
            raise OptionsError("option --output-thin-rate has to be a strictly positive integer!")
        if self.block_size < 1:
            raise OptionsError("option --block-size has to be a strictly positive integer!")
        if self.wave_size is not None and self.wave_size < 1:
            raise OptionsError("option --wave-size has to be a strictly positive integer (or omitted for auto)!")

    def verbosity_level(self, level: int) -> bool:
        """True when detail prints at ``level`` are enabled — the
        reference's Options::verbosity_level (options.hpp:28)."""
        return level <= self.verbosity

    def guard_wave_blocks(self, m_local: int, verbose: bool = True) -> int:
        """Block count this shard will run with; auto-downgrades an
        AUTO-selected wave to the exact-serial recursion when the panel
        has too few Gram blocks for the relaxation's safety margin.

        Interleaved storage separates same-block markers by nblocks
        positions; below ~64 blocks extreme local LD can still
        destabilize W=32 (benchmarking/LD_VALIDATION.md stress tests:
        rho=0.99 / 16 blocks DIVERGES).  A default that can NaN on valid
        input is not acceptable (VERDICT r4 weak 1), so the auto plan
        falls back to W=1; an EXPLICIT --wave-size keeps the user's
        choice with a warning, and the in-chain divergence guard
        (runner.check_finite_chain) still fails loudly.  Production marker
        counts give hundreds of blocks — the anchor has 156.
        """
        nblocks = max(1, -(-max(m_local, 1) // self.block_size))
        if self.wave_size > 1 and nblocks < 64:
            if getattr(self, "wave_auto", False):
                if verbose:
                    print(f"INFO   : only {nblocks} Gram blocks — "
                          f"auto wave relaxation disabled (exact-serial "
                          f"W=1); pass --wave-size explicitly to "
                          f"override.")
                self.wave_size = 1
            elif verbose:
                print(f"WARNING: only {nblocks} Gram blocks for "
                      f"wave mode; on strongly LD-structured panels "
                      f"consider --wave-size 1 or a smaller "
                      f"--block-size.")
        return nblocks

    def load_group_mixtures(self) -> None:
        """Parse the .grm group-mixture file into cva/cvai.

        File layout and validation mirror reference read_group_mixture_file
        (options.cpp:222-286): one row of K whitespace-separated variances per
        group; all rows must have the same K; first entry of each row must be
        0.0; entries strictly ascending.  cvai[g, 0] is left 0 (unused; the
        reference leaves it uninitialized).
        """
        if not self.group_mixture_file:
            # Single default group, spike + one slab, like running without
            # grouping is not supported by the reference either — require it.
            raise OptionsError(
                "can not open the mixture file. Use the --group-mixture-file option!"
            )
        rows: List[List[float]] = []
        with open(self.group_mixture_file) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                vals = [float(tok) for tok in line.split()]
                if rows and len(vals) != len(rows[0]):
                    raise OptionsError(
                        "check your mixture file. The same number of mixtures is "
                        f"expected for all groups. got {len(vals)} mixtures for group "
                        f"{len(rows)}, while first group had {len(rows[0])}."
                    )
                rows.append(vals)
        if not rows:
            raise OptionsError(f"mixture file {self.group_mixture_file} is empty")
        cva = np.asarray(rows, dtype=np.float64)
        if np.any(cva[:, 0] != 0.0):
            raise OptionsError("First element of group mixture must be 0.0!")
        if cva.shape[1] > 1 and np.any(np.diff(cva, axis=1) <= 0.0):
            raise OptionsError("Mixtures must be given in ascending order!")
        cvai = np.zeros_like(cva)
        if cva.shape[1] > 1:
            cvai[:, 1:] = 1.0 / cva[:, 1:]
        self.cva = cva
        self.cvai = cvai

    def ensure_out_dir(self) -> None:
        if self.out_dir and not os.path.isdir(self.out_dir):
            os.makedirs(self.out_dir, exist_ok=True)


# Fixed hyper-priors of the sampler (reference bayes.hpp:14-17).
V0E = 1.0e-4
S02E = 1.0e-4
V0G = 1.0e-4
S02G = 1.0e-4


WAVES = (32, 16, 8)


class SliceNotCovered(OptionsError, NotImplementedError):
    """An option the port does not support yet; the message names the
    ROADMAP.md item that will add it."""


def _auto_wave(block_size: int) -> int:
    for w in WAVES:
        if block_size % w == 0:
            return w
    return 1


def planned_wave(opt: Options) -> int:
    """The wave the options resolve to before the block-count guard:
    ``Options.resolve_compute_plan`` semantics, where ``--use-pallas 0``
    is the exact serial path; the auto wave is 1 at float64."""
    if opt.use_pallas is False:
        return 1
    if opt.wave_size is None and opt.dtype == "float64":
        return 1
    w = opt.wave_size if opt.wave_size is not None else _auto_wave(
        opt.block_size)
    return w if opt.block_size % w == 0 else 1


def check_slice(opt: Options, device_type: str,
                sharded: bool = False) -> None:
    """Raise SliceNotCovered for an option the ported slices lack: in
    training, ``--dtype float64`` with an explicit ``--wave-size`` that
    plans W > 1, and ``--use-pallas 0`` on CUDA.  Predict ignores the
    training-only flags (``--wave-size``, ``--resume``,
    ``--checkpoint-every``, ``--cache-dir``, ``--use-pallas``), as
    gmrm_tpu/predict.py does.  ``sharded``: the run is marker-sharded (more
    than one shard, or a process group)."""
    if (opt.dtype == "float64" and not opt.predict
            and opt.wave_size is not None and planned_wave(opt) > 1):
        where = " on a marker-sharded run" if sharded else ""
        raise SliceNotCovered(
            f"--dtype float64 with --wave-size {opt.wave_size}{where} is "
            f"not ported (ROADMAP §1 item 'float64 at W>1'): the JAX "
            f"package computes no float64 chain at W > 1 (its wave scan "
            f"narrows to float32), so there is no reference to hold one "
            f"against.  Float64 runs the exact serial sweep: drop "
            f"--wave-size, or pass --wave-size 1.")
    if opt.use_pallas is False and device_type == "cuda" and not opt.predict:
        raise SliceNotCovered(
            "--use-pallas 0 on CUDA: the CUDA path always runs its kernels "
            "(ROADMAP §1); pass --wave-size 1 for the exact serial sweep, "
            "or run on the CPU.")


def resolve_plan(opt: Options, device_type: str, m_local: int,
                 verbose: bool = False, sharded: bool = False) -> int:
    """Resolve the wave in place on ``opt`` and return the block count.
    ``m_local`` is the marker count the guard looks at: all markers on one
    device, ``m_total // n_shards`` on a sharded run.

    Keeps ``Options.guard_wave_blocks`` semantics: an auto-selected wave
    drops to 1 (the exact serial sweep) below 64 blocks, and an explicit
    wave is kept with a warning.
    """
    check_slice(opt, device_type, sharded)
    opt.wave_auto = opt.wave_size is None
    opt.wave_size = planned_wave(opt)
    return opt.guard_wave_blocks(m_local, verbose=verbose)
