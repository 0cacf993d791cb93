"""One process's run of a cell on several cards: the marker-sharded
deployment, one shard a process and a card, driven through the program's
sharded path as ``parallel.runner.run_training_sharded`` drives it.

Set-up: the process's shard of the inputs made on its card
(``data.make_shards``), a ``parallel.runner.ProcessData`` around it in the
layout ``load_data_process`` gives, ``build_static_sharded``,
``init_states_sharded``, a ``RngPlan`` keyed by the shard, and the
``ShardedOutputSet``.  Each iteration is one ``gibbs_iteration_sharded``
with the program's ``Communicator``; every ``thin`` iterations a record
goes through ``ShardedOutputSet.write_thinned`` with ``_host_slices``
(positioned ``.bet``/``.cpn`` writes, process 0's ``.csv``).  Every process
runs the same iterations: before each, process 0's host clock decides
whether the window goes on, a flag broadcast over a host (gloo) group, so
no device operation of the harness's enters an iteration.  The host
queues at most ``drive.AHEAD`` iterations ahead, as on one card.
"""

from __future__ import annotations

import gc
import os
import resource
import time

import numpy as np
import torch
import torch.distributed as dist

from pbcore import data as data_mod
from pbcore import drive, judge


class Ranks:
    """The processes of the run: sums and gathers of device tensors over
    the default group (NCCL on cards, gloo on the CPU), and a barrier and
    process 0's flag over a host group."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.host = (None if dist.get_backend() == "gloo"
                     else dist.new_group(backend="gloo"))

    def allsum(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return x

    def gather(self, x: torch.Tensor) -> list:
        out = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(out, x.contiguous())
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.host)

    def flag(self, go: bool) -> bool:
        """Process 0's ``go``, on every process."""
        t = torch.tensor([int(go)], dtype=torch.int32)
        dist.broadcast(t, 0, group=self.host)
        return bool(t.item())


class HostClock:
    """Where this process's host spends the window: seconds in the
    program's calls, in waits on the device and on process 0's flag; its
    CPU time and voluntary context switches."""

    def __init__(self):
        self.s = {"calls": 0.0, "waits": 0.0, "flag": 0.0}
        self.t0, self.cpu0 = time.perf_counter(), time.process_time()
        self.ru0 = resource.getrusage(resource.RUSAGE_SELF)

    def time(self, what, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        self.s[what] += time.perf_counter() - t
        return out

    def summary(self, iterations: int, steps: int) -> dict:
        wall = time.perf_counter() - self.t0
        ru = resource.getrusage(resource.RUSAGE_SELF)
        n = max(iterations, 1)
        return dict(
            cpus=sorted(os.sched_getaffinity(0)), steps_per_iter=steps,
            step_ms=1e3 * self.s["calls"] / (n * steps),
            calls_ms_per_iter=1e3 * self.s["calls"] / n,
            waits_ms_per_iter=1e3 * self.s["waits"] / n,
            flag_ms_per_iter=1e3 * self.s["flag"] / n,
            cpu_per_s=(time.process_time() - self.cpu0) / wall,
            voluntary_switches=ru.ru_nvcsw - self.ru0.ru_nvcsw)


def process_data(cell, opt):
    """A ``parallel.runner.ProcessData`` around the shard already in device
    memory, in the layout ``load_data_process`` gives (the block partition,
    the interleave at W > 1); the phenotype and group files go through
    the program's readers."""
    from gmrm_tpu_torch.io.grouping import read_group_index
    from gmrm_tpu_torch.parallel import runner as prunner
    from gmrm_tpu_torch.parallel.mesh import marker_blocks
    from gmrm_tpu_torch.runner import stem
    n, m = cell.n, cell.m
    blocks = marker_blocks(m, cell.n_shards)
    m_pad_shard, mb_pad = cell.beds[0].shape
    gidx = read_group_index(opt.group_index_file, opt.n_groups)[:m]
    groups, invs = [], []
    for i, order in zip(cell.shards, cell.orders):
        s, ln = blocks[i]
        g = np.zeros(m_pad_shard, np.int32)
        g[:ln] = gidx[s:s + ln][order]
        groups.append(g)
        invs.append(np.argsort(order, kind="stable"))
    phens, eps0, na = drive.phenotypes(opt, n, mb_pad)
    return prunner.ProcessData(
        n=n, m_total=m, mb_pad=mb_pad,
        layout=prunner.ShardLayout(m, cell.n_shards, m_pad_shard),
        local_ids=list(cell.shards), bed_local=list(cell.beds),
        group_local=groups, m_local=[blocks[i][1] for i in cell.shards],
        inv_orders=invs, phens=phens, eps0=eps0, na=na,
        nonas=np.array([ph.nonas for ph in phens], dtype=np.float64),
        mtotgrp=np.bincount(gidx, minlength=opt.n_groups).astype(np.int32),
        out_basenames=[stem(fp) for fp in opt.phen_files])


class Chain:
    """The program's sharded iteration on this process's shards:
    ``chain(it) -> (states, aux)``.  ``comm`` is the program's
    ``Communicator`` (a fault may swap it)."""

    def __init__(self, states, statics, rngs, opt, comm):
        self.states, self.statics, self.rngs = states, statics, rngs
        self.opt, self.comm = opt, comm

    def __call__(self, it: int):
        from gmrm_tpu_torch.sampler.gibbs import gibbs_iteration_sharded
        self.states, aux = gibbs_iteration_sharded(
            self.states, self.statics, it, self.rngs,
            block_size=self.opt.block_size, wave=self.opt.wave_size,
            comm=self.comm, shuffle=self.opt.shuffle_markers)
        return self.states, aux


class Recorder:
    """The thinned records through the program's sharded path, timed as
    ``drive.Recorder`` times them."""

    def __init__(self, outputs, data_p, device):
        self.outputs, self.data_p, self.device = outputs, data_p, device
        self.iterations, self.seconds = [], []

    def __call__(self, states, aux, it: int) -> None:
        from gmrm_tpu_torch.parallel.runner import _host_slices
        from gmrm_tpu_torch.runner import check_finite_chain
        drive.sync(self.device)
        t0 = time.perf_counter()
        first = states[0]
        host = {k: getattr(first, k).cpu().numpy().astype(np.float64)
                for k in ("sigmag", "sigmae", "pi_est")}
        check_finite_chain(host["sigmag"], host["sigmae"], it)
        self.outputs.write_thinned(len(self.iterations), it, host,
                                   aux.m0.cpu().numpy().sum(axis=1),
                                   _host_slices(states, self.data_p))
        self.iterations.append(it)
        self.seconds.append(time.perf_counter() - t0)


def run(spec, seed: int, seconds: float, traced: bool, device, ranks,
        workdir: str, fault=None, control: bool = False, log=print) -> dict:
    """One run of ``spec`` on this process's shard; ``workdir`` is shared
    by every process of the run.  ``fault(chain)``, for the tests and the
    readings of the faults, returns the step that replaces the chain's;
    ``control`` adds the control's numbers under ``extra``.  Returns what
    the metric readers and the result line need, this process's part."""
    from gmrm_tpu_torch.config import Options, resolve_plan
    from gmrm_tpu_torch.parallel import runner as prunner
    from gmrm_tpu_torch.parallel.distributed import (
        Communicator, local_shard_ids,
    )
    from gmrm_tpu_torch.sampler.dists import RngPlan
    cfg, tr = spec.config, spec.traffic
    rec = {"cell": spec.name, "seed": seed, "spans": {}, "rank": ranks.rank}
    n_shards = int(cfg["shards"])
    shards = local_shard_ids(n_shards)
    if len(shards) != 1:
        raise ValueError(f"a run on cards takes one shard a process; "
                         f"{n_shards} shards over {ranks.world} processes")

    # The inputs, this process's shard, from the seed.
    t0 = time.perf_counter()
    cell = data_mod.make_shards(cfg, tr, seed, device,
                                os.path.join(workdir, "in"), shards,
                                ranks.gather, writer=ranks.rank == 0,
                                wait=ranks.barrier)
    drive.sync(device)
    rec["data_s"] = time.perf_counter() - t0
    log(f"portbench: inputs made in {rec['data_s']:.3f} s (N={cell.n}, "
        f"Mt={cell.m}, T={cell.traits}, shard {shards[0]} of {n_shards}: "
        f"{cell.m_locals[0]} markers, bed "
        f"{cell.beds[0].numel() / 1e9:.3f} GB on the device)")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # The program's set-up, through its sharded path.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_setup = time.perf_counter()
    f = cell.files
    opt = Options(
        bed_file="", dim_file=f["dim"], phen_files=f["phens"],
        group_index_file=f["gri"], group_mixture_file=f["grm"], seed=seed,
        iterations=1 << 30, out_dir=os.path.join(workdir, "out"),
        output_thin_rate=int(tr["thin"]), block_size=int(tr["block_size"]),
        wave_size=int(tr["wave"]), dtype=tr["dtype"])
    opt.load_group_mixtures()
    resolve_plan(opt, device.type, cell.m // n_shards)
    comm = Communicator(device)
    data_p = process_data(cell, opt)
    t0 = time.perf_counter()
    statics = prunner.build_static_sharded(data_p, opt, device)
    drive.sync(device)
    rec["spans"]["build_static"] = time.perf_counter() - t0
    states = prunner.init_states_sharded(data_p, opt, device)
    rngs = [RngPlan(opt.seed, device, shard=i) for i in shards]
    outputs = prunner.ShardedOutputSet(opt, data_p, comm)
    record = Recorder(outputs, data_p, device)
    chain = Chain(states, statics, rngs, opt, comm)
    step = chain if fault is None else fault(chain)
    it = 0
    for it in range(1, int(tr["warmup_iterations"]) + 1):
        states, aux = step(it)
    record(states, aux, it)
    drive.sync(device)
    ranks.barrier()
    rec["setup_s"] = time.perf_counter() - t_setup
    log(f"portbench: set-up {rec['setup_s']:.3f} s (statistics and Gram "
        f"cache {rec['spans']['build_static']:.3f} s), every process "
        f"warmed up")

    # The measured window; process 0's clock decides its end.
    clock = drive.Clock(device)
    thin = opt.output_thin_rate
    marks = [clock.mark()]
    host = HostClock()
    t_start = time.perf_counter()
    first = it + 1
    while host.time("flag", ranks.flag,
                    time.perf_counter() - t_start < seconds):
        it += 1
        states, aux = host.time("calls", step, it)
        marks.append(clock.mark())
        if it % thin == 0:
            record(states, aux, it)
        if len(marks) > drive.AHEAD + 1:
            host.time("waits", clock.wait, marks[-drive.AHEAD - 1])
    drive.sync(device)
    rec["window_s"] = time.perf_counter() - t_start
    rec["iterations"] = it - first + 1
    rec["host"] = host.summary(rec["iterations"], -(-cell.beds[0].shape[0]
                                                  // opt.block_size))
    rec["intervals_s"] = [clock.seconds(a, b) for a, b in zip(marks, marks[1:])]
    rec["records_s"] = [s for s, i in zip(record.seconds, record.iterations)
                        if i >= first]
    rec["markers"] = cell.m

    if traced:
        states, aux, it = drive.traced_window(
            rec, step, states, aux, it, thin, record, device,
            int(tr["trace_iterations"]), ops=True)

    # The check iteration and its record, then the program's outputs.
    before = [drive.snapshot(st) for st in states]
    it += 1
    states, aux = step(it)
    record(states, aux, it)
    after = [drive.snapshot(st) for st in states]
    drive.sync(device)
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    grams = [st.gram_cache for st in statics]
    nb_gram = 0 if grams[0] is None else grams[0].shape[0]
    gen = torch.Generator().manual_seed(int(seed) % (1 << 62))
    gram_blocks = (torch.randperm(nb_gram, generator=gen)[
        :int(tr["gram_check_blocks"])].tolist() if nb_gram else [])
    program = dict(
        before=before, after=after, dtype=states[0].eps.dtype,
        gram_blocks=gram_blocks,
        gram=[g[gram_blocks].clone() if gram_blocks else None for g in grams],
        records=list(record.iterations),
        files={"dir": opt.out_dir, "bases": list(data_p.out_basenames)},
        replica_mismatch=judge.replica_mismatch(after[0], ranks.gather))
    del step, chain, statics, states, aux, outputs, record, data_p, grams
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rec["checks"] = judge.judge_shard(spec, cell, program, seed, ranks)
    rec["check_s"] = time.perf_counter() - t0
    if control:
        rec["extra"] = judge.control_shard(spec, cell, program, seed, ranks)
    ranks.barrier()
    return rec

