#!/usr/bin/env python3
"""Run one cell of the benchmark of gmrm_tpu_torch on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Makes the cell's inputs from the seed, sets
the program up through its normal path, warms up, drives the chain for
the window, checks the outputs against the plain reference, and prints
one JSON line last on standard output: the end-to-end metrics with
``--trace 0``, the per-layer metrics (from a ``torch.profiler`` trace of
a further window) with ``--trace 1``.  The numbers compared, each with
its limit, are the last lines on standard error and the last key of the
result.  Exits non-zero with no result where the card is missing, the
program cannot be imported, or JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "gmrm_tpu")
CACHE = os.path.join(ROOT, ".portbench_cache")


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def err(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Every build and kernel cache at a fixed path inside the checkout.
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    sys.path[:0] = [HERE, ROOT]

    import torch
    from pbcore import drive, judge, spec
    from work import gibbs_iteration

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        err(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import gmrm_tpu_torch  # noqa: F401  (fails here where the program is absent)
    err(f"portbench: card {torch.cuda.get_device_name(0)}; nvidia-smi "
        f"name, power limit, max SM clock: {card_line()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    run = drive.run(cell, args.seed, args.seconds, bool(args.trace),
                    log=err)
    bad = forbidden_modules()
    if bad:
        err(f"portbench: the run loaded {bad}; the benchmark runs the port "
            f"alone")
        return 3
    tr = cell.traffic
    es = 8 if tr["dtype"] == "float64" else 4
    work = gibbs_iteration.iteration_work(cell.config["individuals"],
                                          cell.config["markers"],
                                          int(tr["traits"]), es)
    least, bound = gibbs_iteration.least_seconds(work, tr["dtype"])
    run["work"] = dict(work, least_s=least, bound=bound)
    err(f"portbench: window {run['window_s']:.3f} s, {run['iterations']} "
        f"iterations, {len(run['records_s'])} records; the iteration's least "
        f"time {least * 1e3:.4f} ms by {bound}; judged in "
        f"{run['check_s']:.3f} s")

    checks = run["checks"]
    info = checks.pop("_info")
    ok = judge.correct(checks)
    result = {
        "correct": ok,
        "attempted": run["iterations"],
        "failed": 0,
        "metrics": spec.values(cell, run, end_to_end=not args.trace),
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips,
                   "memory_peak_bytes": int(run["memory_peak_bytes"])},
    }
    if args.trace:
        t = run["trace"]
        result["device"]["busy_s"] = t["busy_s"]
        result["device"]["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["checks"] = {k: [c["value"], c["limit"]] for k, c in checks.items()}
    err(f"portbench: tie flips in the check iteration: {info['flips']}")
    for k, c in checks.items():
        err(f"check {k} = {c['value']!r} limit {c['limit']!r}"
            f"{'' if c['value'] <= c['limit'] else '  FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
