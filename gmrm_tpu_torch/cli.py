"""Command line of the port: the reference flag surface of gmrm_tpu's CLI
(``gmrm_tpu.cli.build_parser``), dispatched to the port's training
runner.  Options the ported slice does not cover raise
``SliceNotCovered`` (an ``OptionsError``) naming the ROADMAP.md item."""

from __future__ import annotations

import sys

from gmrm_tpu.cli import build_parser, options_from_args
from gmrm_tpu.config import OptionsError
from gmrm_tpu_torch.config import check_slice


def main(argv=None, device=None) -> int:
    """Run training; ``device`` None means CUDA, which must be present."""
    from gmrm_tpu_torch.runner import resolve_device, run_training

    parser = build_parser()
    parser.prog = "gmrm-tpu-torch"
    opt = options_from_args(parser.parse_args(argv))
    dev = resolve_device(device)
    check_slice(opt, dev.type)
    try:
        opt.validate()
        if opt.group_mixture_file:
            opt.load_group_mixtures()
        run_training(opt, device=dev, verbose=opt.verbosity >= 0)
    except OptionsError as e:
        print(f"FATAL  : {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
