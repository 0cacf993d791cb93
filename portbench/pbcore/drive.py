"""One run of a cell: the program set up through its normal path, warmed
up, driven for the window, optionally traced, then judged.

The window calls the program's iteration entry
(``runner.iteration_step(state, static, rng, opt)``) once an iteration
and, every ``thin`` iterations, writes a thinned record through
``runner._host_record`` and ``OutputSet.write_thinned``, as
``runner.run_training``'s loop does.  A CUDA event recorded after each
iteration gives the iteration's completion on the device without a
synchronize; the host waits on the event two iterations back before it
queues the next one, so the window's end is exact while the device always
has work queued.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from pbcore import data as data_mod
from pbcore import judge, trace

AHEAD = 2          # iterations the host may queue before it waits


class Clock:
    """Completion marks on the device's stream (CUDA events), or on the
    host clock where the program runs on the CPU (the tests)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def seconds(self, a, b) -> float:
        if self.cuda:
            return a.elapsed_time(b) * 1e-3
        return b - a


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phenotypes(opt, n: int, mb_pad: int):
    """The phenotype files through the program's reader: (phens, eps0,
    na), the residual's start and the observed masks (T, 4, mb_pad) in
    phase planes, as the program's loaders lay them out."""
    from gmrm_tpu_torch.io.phen import read_phen
    from gmrm_tpu_torch.ops.decode import to_phase_planes
    mb = -(-n // 4)
    phens = [read_phen(fp, n) for fp in opt.phen_files]
    T = len(phens)
    eps0 = np.zeros((T, 4, mb_pad))
    na = np.zeros((T, 4, mb_pad))
    for i, ph in enumerate(phens):
        eps0[i, :, :mb] = to_phase_planes(ph.epsilon_padded())
        na[i, :, :mb] = to_phase_planes(ph.na_vector_padded())
    return phens, eps0, na


def loaded_from_device(cell, opt, device):
    """A ``runner.LoadedData`` around genotypes already in device memory,
    in the layout ``runner.load_data`` gives; the phenotype and group
    files go through the program's readers."""
    from gmrm_tpu_torch import runner
    from gmrm_tpu_torch.io.grouping import read_group_index
    d = cell
    m_pad, mb_pad = d.bed.shape
    phens, eps0, na = phenotypes(opt, d.n, mb_pad)
    gidx = read_group_index(opt.group_index_file, opt.n_groups)[:d.m]
    group_of = np.zeros(m_pad, dtype=np.int32)
    group_of[:d.m] = gidx[d.order]
    return runner.LoadedData(
        n=d.n, m_total=d.m, m_local=d.m, mb_pad=mb_pad, m_pad=m_pad,
        bed=d.bed, phens=phens, eps0=eps0, na=na,
        nonas=np.array([ph.nonas for ph in phens], dtype=np.float64),
        group_of=group_of,
        mtotgrp=np.bincount(gidx, minlength=opt.n_groups).astype(np.int32),
        out_basenames=[runner.stem(fp) for fp in opt.phen_files],
        inv_order=np.argsort(d.order, kind="stable"))


class Recorder:
    """The thinned records of the chain, through the program's own path.
    A record's first copy waits for every iteration queued before it; the
    harness waits for them first, so that a record's seconds are its own
    (the copies, the reorder and the writes) and not the device's."""

    def __init__(self, runner, outputs, data_p, device):
        self.runner, self.outputs, self.data_p = runner, outputs, data_p
        self.device = device
        self.iterations = []        # iteration of every record written
        self.seconds = []           # host seconds of each record
        self.beta_acc = None

    def __call__(self, state, aux, it: int) -> None:
        sync(self.device)
        t0 = time.perf_counter()
        host = self.runner._host_record(state, self.data_p)
        self.runner.check_finite_chain(host["sigmag"], host["sigmae"], it)
        self.outputs.write_thinned(len(self.iterations), it, host,
                                   aux.m0.cpu().numpy(), self.data_p)
        if self.beta_acc is None:
            self.beta_acc = np.zeros_like(host["betas"])
        self.beta_acc += host["betas"]
        self.iterations.append(it)
        self.seconds.append(time.perf_counter() - t0)


STATE_KEYS = ("eps", "betas", "comp", "acum", "sigmag", "sigmae", "pi_est",
              "mu", "cass")


def snapshot(state) -> dict:
    return {k: getattr(state, k).detach().clone() for k in STATE_KEYS}


def run(spec, seed: int, seconds: float, traced: bool, device="cuda",
        fault: Optional[Callable] = None, log=print,
        extra: Optional[Callable] = None) -> dict:
    """One run of ``spec`` (a :class:`pbcore.spec.Cell`).  ``fault``, for
    the tests, wraps the iteration entry ``step(it) -> (state, aux)``;
    ``extra(spec, cell, program, seed)``, for the control, runs after the
    check and its result is kept.  Returns everything the metric readers
    and the result line need."""
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        return _run(spec, seed, seconds, traced, torch.device(device), fault,
                    log, extra, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(spec, seed, seconds, traced, device, fault, log, extra, workdir):
    cfg, tr = spec.config, spec.traffic
    rec = {"cell": spec.name, "seed": seed, "spans": {}}

    # The inputs, from the seed.
    t0 = time.perf_counter()
    on_device = cfg["inputs"] == "device"
    cell = data_mod.make(cfg, tr, seed, device, os.path.join(workdir, "in"),
                         storage_layout=on_device)
    sync(device)
    rec["data_s"] = time.perf_counter() - t0
    log(f"portbench: inputs made in {rec['data_s']:.3f} s "
        f"(N={cell.n}, Mt={cell.m}, T={cell.traits}, bed "
        f"{cell.bed.numel() / 1e9:.3f} GB on the device)")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # The program's set-up, through its normal path.
    from gmrm_tpu_torch import runner
    from gmrm_tpu_torch.config import Options, resolve_plan
    from gmrm_tpu_torch.sampler.dists import RngPlan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_setup = time.perf_counter()
    f = cell.files
    opt = Options(
        bed_file=f.get("bed", ""), dim_file=f["dim"], phen_files=f["phens"],
        group_index_file=f["gri"], group_mixture_file=f["grm"], seed=seed,
        iterations=1 << 30, out_dir=os.path.join(workdir, "out"),
        output_thin_rate=int(tr["thin"]), block_size=int(tr["block_size"]),
        wave_size=int(tr["wave"]), dtype=tr["dtype"])
    if not on_device:
        opt.validate()
    opt.load_group_mixtures()
    resolve_plan(opt, device.type, cell.m)
    if on_device:
        data_p = loaded_from_device(cell, opt, device)
    else:
        t0 = time.perf_counter()
        data_p = runner.load_data(opt)
        rec["spans"]["load_data"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    static = runner.build_static(data_p, opt, device)
    sync(device)
    rec["spans"]["build_static"] = time.perf_counter() - t0
    state = runner.init_sampler_state(data_p, opt, device)
    outputs = runner.OutputSet(opt, data_p)
    record = Recorder(runner, outputs, data_p, device)
    step = runner.iteration_step(state, static, RngPlan(opt.seed, device),
                                 opt)
    if fault is not None:
        step = fault(step)
    it = 0
    for it in range(1, int(tr["warmup_iterations"]) + 1):
        state, aux = step(it)
    record(state, aux, it)
    sync(device)
    rec["setup_s"] = time.perf_counter() - t_setup
    log(f"portbench: set-up {rec['setup_s']:.3f} s (load "
        f"{rec['spans'].get('load_data', 0.0):.3f} s, statistics and Gram "
        f"cache {rec['spans']['build_static']:.3f} s)")

    # The measured window.
    clock = Clock(device)
    thin = opt.output_thin_rate
    marks = [clock.mark()]
    t_start = time.perf_counter()
    first = it + 1
    while time.perf_counter() - t_start < seconds:
        it += 1
        state, aux = step(it)
        marks.append(clock.mark())
        if it % thin == 0:
            record(state, aux, it)
        if len(marks) > AHEAD + 1:
            clock.wait(marks[-AHEAD - 1])
    sync(device)
    rec["window_s"] = time.perf_counter() - t_start
    rec["iterations"] = it - first + 1
    rec["intervals_s"] = [clock.seconds(a, b) for a, b in zip(marks, marks[1:])]
    rec["records_s"] = [s for s, i in zip(record.seconds, record.iterations)
                        if i >= first]
    rec["markers"] = cell.m

    if traced:
        state, aux, it = traced_window(rec, step, state, aux, it, thin,
                                       record, device,
                                       int(tr["trace_iterations"]))

    # The check iteration and its record, then the program's outputs.
    before = snapshot(state)
    it += 1
    state, aux = step(it)
    record(state, aux, it)
    after = snapshot(state)
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    gram = static.gram_cache
    nb_gram = 0 if gram is None else gram.shape[0]
    gen = torch.Generator().manual_seed(int(seed) % (1 << 62))
    gram_blocks = (torch.randperm(nb_gram, generator=gen)[
        :int(tr["gram_check_blocks"])].tolist() if nb_gram else [])
    gram_sample = (gram[gram_blocks].clone() if gram_blocks else None)
    outfiles = {"dir": opt.out_dir, "bases": list(data_p.out_basenames)}
    program = dict(before=before, after=after, dtype=state.eps.dtype,
                   gram_blocks=gram_blocks, gram=gram_sample,
                   records=list(record.iterations), files=outfiles)
    del step, static, state, aux, outputs, record, data_p, gram
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rec["checks"] = judge.judge(spec, cell, program, seed)
    rec["check_s"] = time.perf_counter() - t0
    if extra is not None:
        rec["extra"] = extra(spec, cell, program, seed)
    return rec


def traced_window(rec, step, state, aux, it, thin, record, device, count,
                  ops=False):
    """``count`` more iterations under ``torch.profiler``; reduces the
    trace into ``rec['trace']``.  With ``ops`` (the cells on several
    cards) also each device operation's seconds and launches (``ops``)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts) as prof:
        with record_function(trace.SPAN_PREFIX + "window"):
            for _ in range(count):
                it += 1
                with record_function(trace.SPAN_PREFIX + "iteration"):
                    state, aux = step(it)
                if it % thin == 0:
                    with record_function(trace.SPAN_PREFIX + "record"):
                        record(state, aux, it)
            sync(device)
    dev, host = trace.events(prof)
    lo, hi = trace.window_bounds(host)
    red = trace.reduce(dev, host, lo, hi)
    red["iterations"] = count
    if ops:
        red["ops"] = trace.op_table(dev, lo, hi)
    rec["trace"] = red
    return state, aux, it
