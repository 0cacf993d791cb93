"""Command line of the port: its own copy of the reference flag surface
(gmrm_tpu/cli.py, reference ``src/options.cpp:26-151``), dispatched to the
port's predict mode (``--predict``, gmrm_tpu_torch/predict.py) or its
training runners.  ``--S`` is accepted and ignored, like the reference.
``--devices S`` with S > 1 trains marker-sharded over S shards
(gmrm_tpu_torch/parallel/runner.py), all on this process's one device
unless a process group spreads them: under a launcher that sets ``RANK``
and ``WORLD_SIZE`` (``torchrun``, one process per card) the processes join
one group first (in predict mode each process then writes its markers'
lines of the one ``.mlma``).  ``--checkpoint-every``, ``--resume`` and
``--cache-dir`` work on one device and marker-sharded, and predict ignores
them.  ``--dtype float64`` trains the exact serial sweep by default and
the float64 wave scan with an explicit ``--wave-size`` W > 1;
``--use-pallas 0`` on CUDA raises ``SliceNotCovered`` (an
``OptionsError``)."""

from __future__ import annotations

import argparse
import os
import sys

from gmrm_tpu_torch.config import Options, OptionsError, check_slice


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gmrm-tpu-torch",
        description="Bayesian grouped mixture-of-regressions (BayesR) "
                    "Gibbs sampler for GWAS on one NVIDIA GPU",
    )
    p.add_argument("--bed-file", default="")
    p.add_argument("--dim-file", default="")
    p.add_argument("--phen-files", default="",
                   help="comma-separated list of .phen files")
    p.add_argument("--group-index-file", default="")
    p.add_argument("--group-mixture-file", default="")
    p.add_argument("--verbosity", type=int, default=0)
    p.add_argument("--shuffle-markers", type=int, default=1)
    p.add_argument("--mimic-hydra", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iterations", type=int, default=1)
    p.add_argument("--trunc-markers", type=int, default=0)
    p.add_argument("--S", default="", help="accepted for compatibility; unused")
    p.add_argument("--out-dir", default="")
    p.add_argument("--output-thin-rate", type=int, default=1)
    p.add_argument("--predict", action="store_true")
    p.add_argument("--bim-file", default="")
    p.add_argument("--ref-bim-file", default="")
    # Accelerator knobs
    p.add_argument("--block-size", type=int, default=128,
                   help="markers per Gram block (residual sync cadence); "
                        "128 is the validated production configuration")
    p.add_argument("--wave-size", type=int, default=None,
                   help="markers per serial step within a block (1 = exact "
                        "serial recursion; W>1 relaxes like W co-scheduled "
                        "shards — the reference's own multi-rank semantics). "
                        "Default: auto — 32, 16 or 8, whichever divides the "
                        "block size, and 1 on panels of fewer than 64 "
                        "blocks; 1 at --dtype float64, where an explicit "
                        "W>1 runs the float64 wave scan")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"],
                   help="the chain's float type; float64 trains the exact "
                        "serial sweep unless --wave-size names W>1, and "
                        "every float of the chain, the wave scan "
                        "included, is float64")
    p.add_argument("--devices", type=int, default=0,
                   help="number of marker shards (0 = one per process); "
                        "more than one trains marker-sharded, every "
                        "shard of a process on its one device")
    p.add_argument("--use-pallas", type=int, default=-1,
                   help="-1 auto, 0 off, 1 on")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save a resumable chain checkpoint every N "
                        "iterations (0 = off; improvement over the "
                        "reference, which cannot resume)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the checkpoint in <out-dir> if present "
                        "(checkpoint.npz; a sharded run any layout of "
                        "checkpoint*.npz, under any shard or process "
                        "count); the same --seed")
    p.add_argument("--cache-dir", default="",
                   help="persist marker stats + Gram cache here, keyed "
                        "by a digest of the .bed rows read, the phen files "
                        "and the geometry (warm startup across runs of "
                        "the same dataset)")
    return p


def options_from_args(args) -> Options:
    return Options(
        bed_file=args.bed_file,
        dim_file=args.dim_file,
        phen_files=[f for f in args.phen_files.split(",") if f],
        group_index_file=args.group_index_file,
        group_mixture_file=args.group_mixture_file,
        bim_file=args.bim_file,
        ref_bim_file=args.ref_bim_file,
        verbosity=args.verbosity,
        shuffle_markers=bool(args.shuffle_markers),
        mimic_hydra=args.mimic_hydra,
        seed=args.seed,
        iterations=args.iterations,
        trunc_markers=args.trunc_markers,
        out_dir=args.out_dir,
        output_thin_rate=args.output_thin_rate,
        predict=args.predict,
        block_size=args.block_size,
        wave_size=args.wave_size,
        dtype=args.dtype,
        n_devices=args.devices,
        use_pallas=None if args.use_pallas < 0 else bool(args.use_pallas),
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        cache_dir=args.cache_dir,
    )


def main(argv=None, device=None) -> int:
    """Run predict or training; ``device`` None means CUDA, which must be
    present.  Dispatch as gmrm_tpu/cli.py:115-136: predict first, without
    the group mixtures; then training, with "devices" read as shards: more
    than one shard, or a process group, goes to the sharded runner."""
    from gmrm_tpu_torch.parallel import distributed
    from gmrm_tpu_torch.runner import resolve_device, run_training

    opt = options_from_args(build_parser().parse_args(argv))
    dev = resolve_device(device)
    if (int(os.environ.get("WORLD_SIZE", "1")) > 1
            and not distributed.is_initialized()):
        distributed.init_distributed(
            backend="nccl" if dev.type == "cuda" else "gloo")
    sharded = opt.n_devices > 1 or distributed.is_initialized()
    check_slice(opt, dev.type)
    try:
        opt.validate()
        if opt.predict:
            from gmrm_tpu_torch.predict import run_predict
            # Verbose whatever --verbosity says, as gmrm_tpu/cli.py runs it.
            run_predict(opt, device=dev)
            return 0
        if opt.group_mixture_file:
            opt.load_group_mixtures()
        if sharded:
            from gmrm_tpu_torch.parallel.runner import run_training_sharded
            run_training_sharded(opt, n_devices=opt.n_devices, device=dev,
                                 verbose=opt.verbosity >= 0)
        else:
            run_training(opt, device=dev, verbose=opt.verbosity >= 0)
    except OptionsError as e:
        print(f"FATAL  : {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
