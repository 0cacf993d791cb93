"""Compute-plan resolution for the port.

``gmrm_tpu.config.Options`` is reused as it is (it imports only NumPy),
but never through ``Options.resolve_compute_plan``, which asks JAX for its
backend, nor ``Options.check_group_limit``, a TPU-only limit.  The plan
here is the same on CPU and CUDA: the wave is 32 (else 16, else 8)
dividing the block size, so the CPU tests run the same block-mode sweep as
the card, with each kernel's plain PyTorch version.
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
    ``Options.resolve_compute_plan`` semantics with Pallas on."""
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
        (planned_wave(opt) == 1, "a wave of 1 (exact-serial W=1)",
         "ROADMAP §1 item 'W=1 exact serial'"),
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
    drops to 1 below 64 blocks, and an explicit wave is kept with a
    warning.  A wave that ends at 1 raises: W=1 is the next slice.
    """
    check_slice(opt, device_type)
    opt.wave_auto = opt.wave_size is None
    opt.wave_size = planned_wave(opt)
    nblocks = opt.guard_wave_blocks(m_local, verbose=verbose)
    if opt.wave_size == 1:
        raise SliceNotCovered(
            f"only {nblocks} Gram blocks: the auto plan falls back to the "
            f"exact-serial W=1 sweep, which is not ported to "
            f"gmrm_tpu_torch yet (ROADMAP §1 item 'W=1 exact serial'); "
            f"pass --wave-size explicitly or use gmrm_tpu.")
    return nblocks
