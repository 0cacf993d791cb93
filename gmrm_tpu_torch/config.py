"""Compute-plan resolution for the port.

``gmrm_tpu.config.Options`` is reused as it is (it imports only NumPy),
but never through ``Options.resolve_compute_plan``, which asks JAX for its
backend, nor ``Options.check_group_limit``, a TPU-only limit.  The plan
here is the same on CPU and CUDA, so the CPU tests run the same sweep as
the card, with each kernel's plain PyTorch version: the auto wave is 32
(else 16, else 8) dividing the block size, and 1 (the exact serial sweep)
when none divides it, when the panel has fewer than 64 blocks, or with
``--use-pallas 0``.
"""

from __future__ import annotations

from gmrm_tpu.config import Options, OptionsError

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
    is the exact serial path."""
    if opt.use_pallas is False:
        return 1
    w = opt.wave_size if opt.wave_size is not None else _auto_wave(
        opt.block_size)
    return w if opt.block_size % w == 0 else 1


def check_slice(opt: Options, device_type: str) -> None:
    """Raise SliceNotCovered for every option the ported slice lacks."""
    gaps = [
        (opt.predict, "--predict", "ROADMAP §1 item 'predict'"),
        (opt.resume, "--resume", "ROADMAP §1 item 'checkpoint/resume'"),
        (opt.checkpoint_every, "--checkpoint-every",
         "ROADMAP §1 item 'checkpoint/resume'"),
        (opt.cache_dir, "--cache-dir",
         "ROADMAP §1 item 'checkpoint/resume and --cache-dir'"),
        (opt.n_devices > 1, "--devices > 1", "ROADMAP §1 item 'sharded'"),
        (opt.dtype == "float64", "--dtype float64",
         "ROADMAP §1 item 'float64'"),
        (opt.use_pallas is False and device_type == "cuda",
         "--use-pallas 0 on CUDA",
         "the CUDA path always runs its kernels (ROADMAP §1)"),
    ]
    for bad, flag, item in gaps:
        if bad:
            raise SliceNotCovered(
                f"{flag} is not ported to gmrm_tpu_torch yet ({item}); "
                f"use gmrm_tpu for it.")


def resolve_plan(opt: Options, device_type: str, m_local: int,
                 verbose: bool = False) -> int:
    """Resolve the wave in place on ``opt`` and return the block count.

    Keeps ``Options.guard_wave_blocks`` semantics: an auto-selected wave
    drops to 1 (the exact serial sweep) below 64 blocks, and an explicit
    wave is kept with a warning.
    """
    check_slice(opt, device_type)
    opt.wave_auto = opt.wave_size is None
    opt.wave_size = planned_wave(opt)
    return opt.guard_wave_blocks(m_local, verbose=verbose)
