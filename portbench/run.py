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

A cell on several cards (``chips`` > 1) runs one process a card
(``pbcore/cards.py``), each on its shard of a marker-sharded deployment;
this process waits for them and prints the one result: process 0's
clock and trace, the fullest card's memory and each compared number's
largest over the processes.  It exits non-zero with no result where any
of them fails.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

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
    from pbcore import drive, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        err(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import gmrm_tpu_torch  # noqa: F401  (fails here where the program is absent)
    if cell.chips > 1:
        run = cards_run(cell, args)
        if run is None:
            return 1
        kind = run["device_kind"]
    else:
        kind = torch.cuda.get_device_name(0)
        err(f"portbench: card {kind}; nvidia-smi "
            f"name, power limit, max SM clock: {card_line()}; torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}")
        run = drive.run(cell, args.seed, args.seconds, bool(args.trace),
                        log=err)
    bad = forbidden_modules()
    if bad:
        err(f"portbench: the run loaded {bad}; the benchmark runs the port "
            f"alone")
        return 3
    result = finish(cell, run, bool(args.trace), kind)
    print(json.dumps(result), flush=True)
    return 0


def finish(cell, run, traced: bool, kind: str) -> dict:
    """The result line of a run, after its numbers compared went to
    standard error, each with its limit, as the last lines."""
    from pbcore import judge, spec
    from work import gibbs_iteration
    tr = cell.traffic
    es = 8 if tr["dtype"] == "float64" else 4
    # One card's work: its share of the markers on a cell of several.
    work = gibbs_iteration.iteration_work(cell.config["individuals"],
                                          cell.config["markers"] // cell.chips,
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
        "metrics": spec.values(cell, run, end_to_end=not traced),
        "device": {"platform": "gpu", "kind": kind,
                   "count": cell.chips,
                   "memory_peak_bytes": int(run["memory_peak_bytes"])},
    }
    if traced:
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
    return result


# What a run on several cards has besides its window: starting the
# processes, the inputs, the set-up, a traced window and the check.
CARDS_ALLOWANCE_S = 300


def cards_run(cell, args):
    """The run of a cell on several cards, one process a card, merged; None
    where a process failed or the run passed its deadline: ``--seconds``
    and ``CARDS_ALLOWANCE_S`` after the kernels' build."""
    import torch
    from pbcore import cards

    def stop(signum, frame):
        raise SystemExit(128 + signum)
    signal.signal(signal.SIGTERM, stop)
    err(f"portbench: {cell.chips} cards, one process each; nvidia-smi "
        f"name, power limit, max SM clock: {card_line()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    from gmrm_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build()
    built = time.perf_counter() - t0
    item = {"seed": args.seed, "seconds": args.seconds,
            "traced": bool(args.trace), "fault": None, "control": False}
    try:
        per = cards.launch(cell, [item], log=err,
                           seconds=args.seconds + CARDS_ALLOWANCE_S)[0]
    except cards.RankFailed as e:
        err(f"portbench: {e}; no result")
        return None
    if args.trace:
        for r, p in enumerate(per[1:], 1):
            t = p["trace"]
            err(f"portbench: process {r}: traced busy {t['busy_s']:.6f} s "
                f"of {t['window_s']:.6f} s")
    run = cards.merge(per)
    # The kernels' build, before the processes start, is set-up too.
    run["setup_s"] += built
    return run


if __name__ == "__main__":
    sys.exit(main())
