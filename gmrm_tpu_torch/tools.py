"""Post-processing helpers for chain artifacts (the port's copy of
gmrm_tpu/tools.py).

``extract-nonzero-beta`` reimplements the reference's precompiled
``example/extract_non_zero_betaAll`` utility (args: .bet path, min
iteration, max iteration; prints ``%7d %7d %20.12f`` = iteration, global
marker index, beta for every non-zero beta in the selected records).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from gmrm_tpu_torch.io.writers import read_history


def extract_nonzero_beta(bet_path: str, it_min: int, it_max: int, out=None):
    """Yield (iteration, marker, beta) rows; print to ``out`` if given."""
    iters, data = read_history(bet_path, "f8")
    rows = []
    for r in range(iters.shape[0]):
        it = int(iters[r])
        if it < it_min or it > it_max:
            continue
        nz = np.nonzero(data[r])[0]
        for j in nz:
            rows.append((it, int(j), float(data[r, j])))
            if out is not None:
                out.write("%7d %7d %20.12f\n" % rows[-1])
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gmrm-tpu-torch-tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser(
        "extract-nonzero-beta",
        help="print non-zero betas from a .bet history "
             "(reference example/extract_non_zero_betaAll)",
    )
    ex.add_argument("bet_file")
    ex.add_argument("it_min", type=int)
    ex.add_argument("it_max", type=int)
    args = p.parse_args(argv)
    if args.cmd == "extract-nonzero-beta":
        extract_nonzero_beta(args.bet_file, args.it_min, args.it_max,
                             out=sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
