#!/usr/bin/env python3
"""Readings for the limits of a cell's correctness check, on the card.

    python3 portbench/calibrate.py --workload <cell> --seconds 3 \\
        --seeds 11 12 ... --control-seeds 11 12 13 [--out FILE] \\
        [--faults unchanged:11 exchange_left_out:12 ...]

For every seed: the cell's whole run with a short window, its numbers
compared; for each control seed also the control's numbers, from the same
state at the end of the window: the reference in the program's place with
its products rounded to TF32 (float32 cells), or the program's own float32
path judged as the float64 cell (the float64 cells).  One JSON line a run
on standard output and in ``--out``.  The benchmark's runs never run this.

A cell on several cards runs every seed in one set of processes, one a
card (``pbcore/cards.py``), each number the largest over them; there
``--faults name:seed`` also runs the cell with a fault of
``pbcore/faults.py`` planted under the timed path, after the seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[],
                    help="name:seed, cells on several cards")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from pbcore import drive, judge, spec
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    f64 = cell.traffic["dtype"] == "float64"

    def values(checks):
        return {k: v["value"] for k, v in checks.items() if not k.startswith("_")}

    out = open(args.out, "a") if args.out else None

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    if cell.chips > 1:
        cards_readings(cell, args, values, emit)
        if out:
            out.close()
        return 0
    quiet = lambda *a: None  # noqa: E731
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctl = seed in args.control_seeds
        r = drive.run(cell, seed, args.seconds, False, log=quiet,
                      extra=judge.control if ctl and not f64 else None)
        line = {"cell": cell.name, "seed": seed,
                "program": values(r["checks"]),
                "flips": r["checks"]["_info"]["flips"],
                "iterations": r["iterations"], "check_s": r["check_s"]}
        if ctl and f64:
            r32 = drive.run(spec.with_traffic(cell, dtype="float32"), seed,
                            args.seconds, False, log=quiet)
            line["control"] = values(r32["checks"])
        elif ctl:
            line["control"] = r["extra"]
        line["seconds"] = time.perf_counter() - t0
        emit(line)
    if out:
        out.close()
    return 0


def cards_readings(cell, args, values, emit) -> None:
    """The readings of a cell on several cards, every run in one set of
    processes."""
    from pbcore import cards
    items = [{"seed": s, "seconds": args.seconds, "traced": False,
              "fault": None, "control": s in args.control_seeds}
             for s in args.seeds]
    for f in args.faults:
        name, seed = f.split(":")
        items.append({"seed": int(seed), "seconds": args.seconds,
                      "traced": False, "fault": name, "control": False})
    t0 = time.perf_counter()
    runs = cards.launch(cell, items,
                        log=lambda *a: print(*a, file=sys.stderr, flush=True))
    for item, per in zip(items, runs):
        r = cards.merge(per)
        line = {"cell": cell.name, "seed": item["seed"],
                "program": values(r["checks"]),
                "flips": r["checks"]["_info"]["flips"],
                "iterations": r["iterations"], "check_s": r["check_s"],
                "data_s": r["data_s"], "setup_s": r["setup_s"],
                "memory_peak_bytes": r["memory_peak_bytes"]}
        if item["fault"]:
            line["fault"] = item["fault"]
        if item["control"]:
            line["control"] = r["extra"]
        emit(line)
    print(f"calibrate: {len(items)} runs in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
