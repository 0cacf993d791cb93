#!/usr/bin/env python3
"""One traced run of a cell on this machine's card, split by the program's
own spans and stamps.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s> [--out FILE]

from the root of a checkout.  Runs ``run.py --trace 1`` in this process
(its result line first), keeps the traced window's profiler events, and
prints: for each ``gmrm.`` span its calls, host and self host ms,
device-busy and device-idle ms and launches a traced iteration
(``pbcore/spans.py``), the device time no span launched, and the idle
outside every span; the stamp summaries of kernels 7/8 and 6/C
(``gmrm_tpu_torch.trace.stamp_summaries``) beside what the trace says of
the same launches (the window's first sweep, the one stamped): kernel
7/8's stamped period a block times the blocks against its device time,
and kernel 6/C's stamped chain against its launches' device time.  The last line
is one JSON object, also appended to ``--out``, with the program's own
span readings (``trace.span_summaries``) beside the trace's.  The
benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def kernel_check(dev, host, stamps, prefix):
    """The stamps beside the trace's device time of the launches they
    stamped: the window's first sweep (``trace.sweep_stamps``).  Kernel
    7/8 also beside its mean over the window."""
    first = min((x for x in host if x[0] == prefix + "sweep"),
                key=lambda x: x[1])
    launched = {c: s for n, s, _, c in host if n.startswith("cu")}

    def durations(kernel, in_first):
        return [e - s for n, s, e, c in dev if kernel in n and (
            not in_first or first[1] <= launched.get(c, -1.0) <= first[2])]
    out = {}
    sweep = stamps.get("sweep_blocks")
    if sweep:
        every = durations("sweep_blocks_kernel", False)
        out["sweep_blocks"] = {
            "trace_ms": 1e3 * sum(durations("sweep_blocks_kernel", True)),
            "window_mean_ms": 1e3 * sum(every) / len(every),
            "stamped_ms": 1e-3 * sweep["block_us"] * sweep["blocks"]}
    scan = stamps.get("serial_scan")
    if scan:
        d = durations("serial_scan_kernel", True)
        out["serial_scan"] = {"trace_ms": 1e3 * sum(d), "launches": len(d),
                              "stamped_ms": 1e-6 * scan["chain_ns"]}
    for v in out.values():
        v["ratio"] = v["stamped_ms"] / v["trace_ms"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import run as bench
    from pbcore import spans, spec, trace

    # run.py's traced window reduces the profiler's events through
    # trace.events; keep them with their correlation ids as well.
    kept = {}
    reduce_events = trace.events

    def events(prof):
        kept["dev"], kept["host"] = spans.events(prof)
        return reduce_events(prof)

    trace.events = events
    rc = bench.main(["--workload", args.workload, "--seed", str(args.seed),
                     "--seconds", str(args.seconds), "--trace", "1"])
    if rc:
        return rc
    import torch
    from gmrm_tpu_torch import trace as program_trace
    dev, host = kept["dev"], kept["host"]
    lo, hi = trace.window_bounds([x[:3] for x in host])
    red = spans.reduce_spans(dev, host, lo, hi)
    iters = int(spec.cell(args.workload).traffic["trace_iterations"])
    stamps = program_trace.stamp_summaries()
    line = {
        "cell": args.workload, "seed": args.seed,
        "card": torch.cuda.get_device_name(0),
        "busy_ms_per_iter": red["busy_ms"] / iters,
        "unattributed_share": red["unattributed_ms"] / red["busy_ms"],
        "idle_outside_ms_per_iter": red["idle_outside_ms"] / iters,
        "spans": {n: {k: v / iters for k, v in p.items()}
                  for n, p in red["spans"].items()},
        "stamps": stamps,
        "program_spans": program_trace.span_summaries(),
        "kernels": kernel_check(dev, host, stamps, spans.PREFIX),
    }
    err = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    err(f"spans: {args.workload} seed {args.seed}, {iters} traced "
        f"iterations, busy {line['busy_ms_per_iter']:.4f} ms an iteration, "
        f"unattributed {100 * line['unattributed_share']:.3f}%")
    for n, p in sorted(line["spans"].items()):
        err(f"  gmrm.{n}: " + ", ".join(f"{k} {v:.4f}" for k, v in p.items())
            + " (an iteration)")
    for k, v in line["kernels"].items():
        err(f"  {k}: stamped {v['stamped_ms']:.4f} ms, trace "
            f"{v['trace_ms']:.4f} ms, ratio {v['ratio']:.4f}")
    text = json.dumps(line, default=float)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
