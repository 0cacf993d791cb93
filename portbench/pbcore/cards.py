"""A cell on several cards: one process a card on this host, each joined
into the program's process group (``parallel.distributed
.init_distributed``: NCCL on cards, gloo on the CPU) and running its shard
(``pbcore/sharded.py``).

The parent builds the kernels once (``ops/_build.build``), starts the
processes with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
and a free ``MASTER_PORT``, and waits for them: where one fails, or the
run passes its deadline, it stops every one and the run fails.  Each
process runs on one CPU thread unless ``OMP_NUM_THREADS`` says
otherwise.  Each
process writes its part of each run as JSON into the run's work
directory, which they share, and logs to standard error; only the parent
prints a result.

Run as a script (``cards.py <workdir>``) this file is one such process.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PORTBENCH)


class RankFailed(RuntimeError):
    """A process of the run failed or passed the deadline."""


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cell_json(cell) -> dict:
    return {"name": cell.name, "chips": cell.chips, "config": cell.config,
            "traffic": cell.traffic, "limits": cell.limits}


def stop(procs) -> None:
    """Ends every process still running and waits for each."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    end = time.monotonic() + 15
    for p in procs:
        try:
            p.wait(timeout=max(0.1, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(cell, items: List[dict], device: str = "cuda", log=print,
           seconds: Optional[float] = None) -> list:
    """Runs each of ``items`` ({"seed", "seconds", "traced", "fault",
    "control"}) in turn on ``cell.chips`` processes, one a card (or, on the
    CPU, gloo processes).  Returns, for each item, every process's run
    dict in rank order.  ``seconds``: the time the processes have, from
    the end of the kernels' build, to end."""
    if device == "cuda":
        from gmrm_tpu_torch.ops import _build
        t0 = time.perf_counter()
        _build.build()
        _build.host_build()
        log(f"portbench: kernels built or found in "
            f"{time.perf_counter() - t0:.3f} s")
    deadline = None if seconds is None else time.monotonic() + seconds
    workdir = tempfile.mkdtemp(prefix="portbench-cards-")
    procs = []
    try:
        job = {"cell": cell_json(cell), "items": items, "device": device}
        with open(os.path.join(workdir, "job.json"), "w") as fh:
            json.dump(job, fh)
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(free_port()),
                   WORLD_SIZE=str(cell.chips),
                   OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"),
                   PYTHONPATH=os.pathsep.join(
                       [PORTBENCH, ROOT] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        try:                # what the program prints goes to stderr
            sink = sys.stderr.fileno()
        except (AttributeError, ValueError, OSError):
            sink = None
        for r in range(cell.chips):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), workdir],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdin=subprocess.DEVNULL, stdout=sink, cwd=ROOT))
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RankFailed(f"process {bad[0][0]} exited with "
                                 f"{bad[0][1]}")
            if all(c == 0 for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise RankFailed("the run passed its deadline")
            time.sleep(0.2)
        out = []
        for i in range(len(items)):
            per = []
            for r in range(cell.chips):
                with open(os.path.join(workdir, f"result_{i}_{r}.json")) as fh:
                    per.append(json.load(fh))
            out.append(per)
        return out
    finally:
        stop(procs)
        shutil.rmtree(workdir, ignore_errors=True)


def merge(per: list) -> dict:
    """One run dict from every process's part: process 0's, with the
    fullest card's peak memory and each compared number's largest over
    the processes (the control's too)."""
    from pbcore import judge
    run = dict(per[0])
    run["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in per)
    run["checks"] = judge.merge([r["checks"] for r in per])
    if "extra" in run:
        run["extra"] = {k: max(r["extra"][k] for r in per)
                        for k in run["extra"] if k != "flips"}
    return run


def _rank_main(workdir: str) -> int:
    with open(os.path.join(workdir, "job.json")) as fh:
        job = json.load(fh)
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])

    def log(*a):
        print(f"[rank {rank}]", *a, file=sys.stderr, flush=True)
    quiet = log if rank == 0 else (lambda *a: None)
    import torch
    import torch.distributed as dist
    from gmrm_tpu_torch.parallel.distributed import init_distributed
    import run as run_py
    from pbcore import faults, sharded, spec
    cuda = job["device"] == "cuda"
    init_distributed(
        f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        world, rank, backend="nccl" if cuda else "gloo",
        timeout_seconds=600)
    device = (torch.device("cuda", torch.cuda.current_device()) if cuda
              else torch.device("cpu"))
    ranks = sharded.Ranks()
    c = job["cell"]
    cell = spec.Cell(name=c["name"], chips=c["chips"], config=c["config"],
                     traffic=c["traffic"], limits=c["limits"])
    warm, B = int(cell.traffic["warmup_iterations"]), int(
        cell.traffic["block_size"])
    for i, item in enumerate(job["items"]):
        name = item.get("fault")
        fault = (None if not name else
                 lambda chain, f=faults.FAULTS[name]: f(chain, warm, B))
        run_dir = os.path.join(workdir, f"run{i}")
        if rank == 0:
            os.makedirs(run_dir, exist_ok=True)
        ranks.barrier()
        rec = sharded.run(cell, int(item["seed"]), float(item["seconds"]),
                          bool(item["traced"]), device, ranks, run_dir,
                          fault=fault, control=bool(item.get("control")),
                          log=quiet)
        loaded = run_py.forbidden_modules()
        if loaded:
            log(f"portbench: the run loaded {loaded}; the benchmark runs "
                f"the port alone")
            return 3
        rec["device_kind"] = (torch.cuda.get_device_name(device) if cuda
                              else "cpu")
        if "trace" in rec:
            t = rec["trace"]
            if rank:
                log(f"portbench: traced window busy {t['busy_s']:.6f} s of "
                    f"{t['window_s']:.6f} s, idle "
                    f"{100 * (1 - t['busy_s'] / t['window_s']):.4f}%")
            for name, (sec, n) in sorted(
                    t["ops"].items(), key=lambda kv: -kv[1][0])[:4]:
                log(f"portbench: traced {name[:60]}: {n} launches, mean "
                    f"{1e6 * sec / n:.2f} us")
        h = rec["host"]
        log(f"portbench: host {h['step_ms']:.4f} ms a block step in the "
            f"program's calls ({h['steps_per_iter']} steps, "
            f"{h['calls_ms_per_iter']:.2f} ms an iteration), waits on the "
            f"device {h['waits_ms_per_iter']:.2f} ms and on process 0's "
            f"flag {h['flag_ms_per_iter']:.2f} ms an iteration; "
            f"{h['cpu_per_s']:.3f} CPU s a s, "
            f"{h['voluntary_switches']} voluntary switches, on cpus "
            f"{h['cpus'][0]}-{h['cpus'][-1]} ({len(h['cpus'])})")
        log(f"portbench: {rec['iterations']} iterations, peak "
            f"{rec['memory_peak_bytes']} bytes, judged in "
            f"{rec['check_s']:.3f} s")
        path = os.path.join(workdir, f"result_{i}_{rank}.json")
        with open(path + ".part", "w") as fh:
            json.dump(rec, fh)
        os.replace(path + ".part", path)
        if rank == 0:
            shutil.rmtree(run_dir, ignore_errors=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1]))
