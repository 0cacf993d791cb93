#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (gmrm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. build the CUDA kernels of gmrm_tpu_torch/csrc with nvcc (sm_90a), one
   nvcc per source, all started together;
2. each kernel against its plain PyTorch version on the card, at the
   training paths' shapes (T=4 traits, B=128, W=32, K=4, mb_pad=2560),
   with shared (NT=1) and per-trait (NT=4) NA masks, timed beside the
   plain version by replaying a CUDA graph of many calls (device time),
   and per eager call.  The whole-sweep kernel runs one sweep of the
   anchor's 157 blocks (an adaV group, a partly padded last block) against
   its plain version and against the composed chain of kernels 2, 3 and 4;
   one launch is a whole sweep, so it is timed with CUDA events around
   eager launches.  The fused per-block kernel of the sharded sweep runs
   blocks of the same operands against its plain version (comp exact, every
   element of the delta written), timed per launch;
3. the wave path's (W=32) one-sweep agreement gate at the anchor: the
   default marker_sweep, so the whole-sweep kernel, on the card against the
   same sweep from the plain versions (on the host CPU), with the same
   injected processing order and draws;
3b. the exact serial path's (W=1) one-sweep gate on a small panel
   (N=10,000 x Mt=4,096 x 4 traits with phenotype NAs: 32 blocks, so the
   auto plan resolves to W=1, as it does for users' small panels);
3c. the large-N regime (N=100,000 x Mt=4,096 x 4 traits with phenotype NAs,
   mb_pad=25,088, explicit W=32): one sweep through the whole-sweep kernel
   against the composed kernels on the card, same order and draws;
3d. one marker-sharded sweep at the anchor, 4 shards on the one card: the
   fused per-block kernel against the composed kernels 2, 3 and 4 run at
   the same cadence (per block step every shard against the one residual,
   then the sum of the deltas), same order and draws;
3e. one sharded sweep on the small panel, 2 shards of 16 blocks, where the
   auto plan resolves to W=1: kernels 5, 6 and 4 adding into a delta
   against their plain versions on the host CPU;
4. the training entry point, gmrm_tpu_torch.runner.run_training, on the
   reference anchor (N=10,000 x Mt=20,000 x 4 traits, bench.py:50-57) in
   wave mode for 20 iterations with thinned output: the whole-sweep kernel
   launches once per iteration and kernels 2-6 not at all; the chain and
   the written artifacts are checked;
4b. the same at W=1 (--wave-size 1) for 10 iterations, checking the
   launch counts of the exact serial path;
4c. the composed wave path (megakernel=False) for 5 iterations of
   gibbs_iteration at the anchor, checking its launch counts;
4d. the sharded entry point, gmrm_tpu_torch.parallel.runner
   .run_training_sharded, at the anchor: 2 shards on the auto plan (79
   blocks per shard, so W=32 and the fused per-block kernel) for 10
   iterations, and 4 shards at an explicit W=32 for 5, all shards on the one
   card; launch counts, the chain and the artifacts are checked;
4e. the 2-shard run again inside a one-rank NCCL process group, so that
   every sum of the path goes through NCCL on CUDA tensors; its artifacts
   must equal phase 4d's byte for byte;
5. a torch.profiler window over 5 whole-sweep iterations at the anchor, and
   one over 5 sharded iterations (2 shards): device-busy and wall time per
   iteration, idle share, launches.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without CUDA, or without the
rest of the repository beside it, the script fails before printing any
result.

To compare two trees on the single-device training paths inside one call
on one card (parent, change, change, parent):

    python3 chip_smoke.py --training-only 3 [--repo OTHER_TREE]

builds the kernels of the tree at --repo (default: this one), runs phases 4
and 4b three times and prints each run's ms/iteration, nothing else.
"""

import argparse

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

T, B, W, K, MB = 4, 128, 32, 4, 2560
N, MT = 10_000, 20_000
ITERS, THIN = 20, 5
MT_SMALL = 4_096        # the W=1 gate's panel: 32 blocks of B
ITERS_SERIAL = 10
ITERS_COMPOSED = 5
N_BIG, MT_BIG = 100_000, 4_096   # the large-N gate's panel: mb_pad 25,088
MEGA_KERNELS = ("gram_cache", "sweep_blocks")
COMPOSED_KERNELS = ("block_cdot", "wave_scan", "eps_update")
SERIAL_KERNELS = ("block_gram", "serial_scan", "eps_update")
SHARDED_RUNS = ((2, None, 10), (4, W, 5))   # shards, --wave-size, iterations

# Peak rates of one NVIDIA H100 SXM (data sheet, dense, at 700 W): device
# memory bytes/s, float32 outside the tensor cores, int8 tensor cores.
HBM_BPS, F32_OPS, INT8_OPS = 3.35e12, 67e12, 1979e12


def bound_of(nbytes, *ops_and_rates):
    """The least milliseconds the card could take: the larger of the bytes
    the function must move over the memory rate and its operations, each
    type over its peak rate.  Returns (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BPS
    t_ops = sum(ops / rate for ops, rate in ops_and_rates)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def fail(msg):
    print(f"FATAL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps):
    """Device milliseconds per call: ``reps`` calls captured in one CUDA
    graph and replayed after a warm-up, so the host's dispatch of each call
    is not timed."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn, reps):
    """Milliseconds per eager call over ``reps`` calls after a warm-up:
    the device time or the host's dispatch, whichever is longer."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(got, want):
    return float((got.double() - want.double()).abs().max())


def close(name, got, want, rtol, atol_rel):
    """rtol plus an atol of atol_rel * max|want|: the kernel sums in
    another order than the plain version."""
    import torch
    atol = atol_rel * float(want.abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {max_err(got, want):.3e}, atol {atol:.3e})")
    return max_err(got, want)


def to_device(obj, dev):
    """A state/static dataclass with every tensor moved to ``dev``."""
    import torch
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(dev)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def kernel_phase(dev, gen):
    """Phase 2: every kernel against its plain version on the card."""
    import torch
    from gmrm_tpu_torch.ops import block_gram as bg
    from gmrm_tpu_torch.ops import block_kernels as bk
    from gmrm_tpu_torch.ops import scan_kernel as sk6
    from gmrm_tpu_torch.ops import scan_kernel_wave as sw
    from gmrm_tpu_torch.ops import sweep_kernel as sk

    nblocks = -(-MT // B)
    m_pad = nblocks * B
    bed = torch.randint(0, 256, (m_pad, MB), generator=gen, device=dev,
                        dtype=torch.uint8)
    bed[MT:] = 0x55                                      # pad rows
    bed[:, MB - 60:] = 0x55                              # pad columns
    na_shared = torch.ones((T, 4, MB), device=dev)
    na_shared[:, :, MB - 60:] = 0
    na_trait = na_shared * (torch.rand((T, 4, MB), generator=gen,
                                       device=dev) > 0.03)
    rows_of = torch.randperm(m_pad, generator=gen, device=dev)
    out, times, bounds = {}, {}, {}
    f4 = 4                                   # bytes per float32 / int32
    tb, plane = T * B * f4, T * 4 * MB * f4  # a (T, B) and a (T, 4, mb) array
    block_ops = 4 * T * B * 4 * MB           # flops of A.eps and B.eps

    def timed(name, kernel, plain, reps, plain_reps):
        """Graph-replay ms of the kernel and its plain version, and the
        kernel's eager ms per call."""
        t = times.setdefault(name, ([], [], []))
        t[0].append(cuda_ms(kernel, reps))
        t[1].append(cuda_ms(plain, plain_reps))
        t[2].append(call_ms(kernel, reps))

    # Kernel 1: the Gram cache, bit-equal, NT = 1 and NT = T.
    for shared, na in ((True, na_shared), (False, na_trait)):
        na_in = (na[:1] if shared else na).contiguous()
        got = sk.build_gram_cache(bed, na, block_size=B, shared_na=shared)
        want = sk.gram_cache_plain(bed, na_in, B)
        if not torch.equal(got, want):
            fail(f"gram_cache (NT={na_in.shape[0]}) is not bit-equal to "
                 f"its plain version (max abs err {max_err(got, want)})")
        timed("gram_cache", lambda: sk.build_gram_cache(
            bed, na, block_size=B, shared_na=shared),
            lambda: sk.gram_cache_plain(bed, na_in, B), 3, 3)
    out["gram_cache"] = 0.0
    # NT = 1, as the first timing: bed and mask in, the cache out; the
    # Gram's multiply-adds are on integers below 256.
    bounds["gram_cache"] = bound_of(
        bed.numel() + 4 * MB * f4 + nblocks * (2 * B) ** 2 * f4,
        (2 * nblocks * (2 * B) ** 2 * 4 * MB, INT8_OPS))

    # Kernel 2: the c-dot of one block in processing order.
    eps = torch.randn((T, 4, MB), generator=gen, device=dev) * na_trait
    mave = torch.rand((T, B), generator=gen, device=dev) * 1.6 + 0.2
    msig = torch.rand((T, B), generator=gen, device=dev) * 1.5 + 0.5
    rows = rows_of[:B].to(torch.int32).contiguous()
    got = bk.block_cdot(bed, rows, eps, mave, msig)
    want = bk.block_cdot_plain(bed, rows, eps, mave, msig)
    out["block_cdot"] = close("block_cdot", got, want, 1e-5, 1e-5)
    timed("block_cdot", lambda: bk.block_cdot(bed, rows, eps, mave, msig),
          lambda: bk.block_cdot_plain(bed, rows, eps, mave, msig), 200, 200)
    bounds["block_cdot"] = bound_of(B * MB + plane + 3 * tb + B * f4,
                                    (block_ops, F32_OPS))

    # Kernel 4: the residual update, from a zero residual so the compared
    # values are the update itself.
    d = (torch.randn((T, B), generator=gen, device=dev)
         * (torch.rand((T, B), generator=gen, device=dev) > 0.5)) * 0.01
    err = 0.0
    for na in (na_shared, na_trait):
        got = bk.block_eps_update_(bed, rows, d, mave, na,
                                   torch.zeros((T, 4, MB), device=dev))
        want = bk.block_eps_update_plain_(bed, rows, d, mave, na,
                                          torch.zeros((T, 4, MB),
                                                      device=dev))
        err = max(err, close("eps_update", got, want, 1e-5, 1e-5))
        e1 = torch.zeros((T, 4, MB), device=dev)
        timed("eps_update",
              lambda: bk.block_eps_update_(bed, rows, d, mave, na, e1),
              lambda: bk.block_eps_update_plain_(bed, rows, d, mave, na, e1),
              200, 200)
    out["eps_update"] = err
    bounds["eps_update"] = bound_of(B * MB + 3 * plane + 2 * tb + B * f4,
                                    (block_ops, F32_OPS))

    # Kernel 3: the wave scan on identical inputs, with an adaV group and
    # pad markers.
    G = 3
    cva = torch.tensor([[0.0, 1e-3, 1e-2, 5e-2]] * G, device=dev)
    cvai = torch.zeros_like(cva)
    cvai[:, 1:] = 1.0 / cva[:, 1:]
    grp = torch.randint(0, G, (B,), generator=gen, device=dev)
    valid = torch.arange(B, device=dev) < B - 5
    sigmag = torch.rand((T, G), generator=gen, device=dev) * 0.4 + 0.1
    sigmag[0, 1] = 0.0
    sigmae = torch.rand((T,), generator=gen, device=dev) * 0.4 + 0.5
    pi = torch.rand((T, G, K), generator=gen, device=dev) + 0.1
    pi = pi / pi.sum(-1, keepdim=True)
    nonas = torch.full((T,), 490.0, device=dev)
    lc_t, rd_t, sqb_t = sk.build_sweep_tables(sigmag, sigmae, pi, cva,
                                              cvai, nonas, 500.0)
    x = torch.randn((B, 600), generator=gen, device=dev)
    gs = (x @ x.T).expand(T, B, B).contiguous()
    base = torch.randn((T, B), generator=gen, device=dev) * 30.0
    live, zerob = sw.scan_masks(grp, valid, sigmag)
    args = (base, lc_t[:, :, grp].contiguous(),
            rd_t[:, :, grp].contiguous(), sqb_t[:, :, grp].contiguous(), gs,
            torch.randn((T, B), generator=gen, device=dev) * 0.05,
            torch.randint(0, K, (T, B), generator=gen, device=dev,
                          dtype=torch.int32),
            torch.rand((T, B), generator=gen, device=dev),
            torch.rand((T, B), generator=gen, device=dev),
            torch.randn((T, B), generator=gen, device=dev), live, zerob,
            (1.0 / (2.0 * sigmae)).contiguous())
    got = sw.wave_scan(*args, wave=W)
    want = sw.wave_scan_plain(*args, W)
    if not torch.equal(got[2], want[2]):
        fail("wave_scan: comp differs from the plain version")
    if len(torch.unique(want[2][live != 0])) < 2:
        fail("wave_scan parity case drew a single component")
    out["wave_scan"] = max(
        close(f"wave_scan {name}", g, w, 1e-5, 1e-5)
        for name, g, w in zip(("dbeta", "beta", "acum"),
                              (got[0], got[1], got[3]),
                              (want[0], want[1], want[3])))
    timed("wave_scan", lambda: sw.wave_scan(*args, wave=W),
          lambda: sw.wave_scan_plain(*args, W), 200, 20)
    # The fold reads the Gram rows of a wave only when one of its markers
    # moved: count the waves of this case that did.
    moved = int((want[0].reshape(T, B // W, W) != 0).any(dim=2).any(dim=0)
                .sum())
    scan_bytes = 3 * K * tb + 12 * tb + T * f4
    bounds["wave_scan"] = bound_of(
        scan_bytes + moved * T * W * B * f4,
        (moved * 2 * T * W * B + T * B * K * 12, F32_OPS))

    # Kernel 5: the W=1 block's c and scaled Gram, gs bit-equal.
    err = 0.0
    for na_in in (na_shared[:1].contiguous(), na_trait):
        got = bg.block_gram_scaled(bed, rows, eps, na_in, mave, msig)
        want = bg.block_gram_scaled_plain(bed, rows, eps, na_in, mave, msig)
        if not torch.equal(got[1], want[1]):
            fail(f"block_gram (NT={na_in.shape[0]}): gs is not bit-equal to "
                 f"its plain version (max abs err {max_err(got[1], want[1])})")
        err = max(err, close("block_gram c", got[0], want[0], 1e-5, 1e-5))
        timed("block_gram", lambda: bg.block_gram_scaled(
            bed, rows, eps, na_in, mave, msig),
            lambda: bg.block_gram_scaled_plain(
                bed, rows, eps, na_in, mave, msig), 100, 20)
    out["block_gram"] = err
    bounds["block_gram"] = bound_of(
        B * MB + 4 * MB * f4 + plane + 3 * tb + B * f4 + T * B * B * f4,
        (2 * (2 * B) ** 2 * 4 * MB, INT8_OPS),
        (block_ops + 9 * T * B * B, F32_OPS))

    # Kernel 6: the serial scan on the inputs of kernel 3 (adaV group, pad
    # markers), then with |base| of order 1e3 so the 700 guards fire.
    err, drawn = 0.0, set()
    for scale in (1.0, 40.0):
        sargs = (args[0] * scale,) + args[1:]
        got = sk6.serial_scan(*sargs)
        want = sk6.serial_scan_plain(*sargs)
        if not torch.equal(got[2], want[2]):
            fail(f"serial_scan (base x{scale}): comp differs from the plain "
                 f"version in {int((got[2] != want[2]).sum())} entries")
        drawn |= set(want[2][live != 0].tolist())
        err = max([err] + [close(f"serial_scan {name}", g, w, 1e-5, 1e-5)
                           for name, g, w in zip(
                               ("dbeta", "beta", "acum"),
                               (got[0], got[1], got[3]),
                               (want[0], want[1], want[3]))])
        timed("serial_scan", lambda: sk6.serial_scan(*sargs),
              lambda: sk6.serial_scan_plain(*sargs), 200, 3)
    if len(drawn) < 2:
        fail("serial_scan parity cases drew a single component")
    out["serial_scan"] = err
    bounds["serial_scan"] = bound_of(
        scan_bytes + T * B * B * f4,
        (2 * T * B * B + T * B * K * K * 4, F32_OPS))
    return {name: (err, *times[name], bounds[name])
            for name, err in out.items()}


def sweep_operands(dev, gen, shared):
    """One sweep's operands at the anchor's shapes: 157 blocks of B=128
    (the last with 96 pad slots), G=3 groups, one of them adaV for trait 0,
    a standardized residual and the statistics of a random bed."""
    import torch
    from gmrm_tpu_torch.ops import sweep_kernel as sk
    from gmrm_tpu_torch.ops.blockops import marker_stats
    from gmrm_tpu_torch.sampler.state import StaticInputs

    nblocks = -(-MT // B)
    m_pad = nblocks * B
    G = 3
    bed = torch.randint(0, 256, (m_pad, MB), generator=gen, device=dev,
                        dtype=torch.uint8)
    bed[MT:] = 0x55
    bed[:, MB - 60:] = 0x55
    na = torch.ones((T, 4, MB), device=dev)
    na[:, :, MB - 60:] = 0
    if not shared:
        na = na * (torch.rand((T, 4, MB), generator=gen, device=dev) > 0.03)
    nonas = na.sum(dim=(1, 2))
    mave, msig = marker_stats(bed, na, nonas)
    valid = (torch.arange(m_pad, device=dev) < MT)[None]
    mave = torch.where(valid, mave, 0.0).contiguous()
    msig = torch.where(valid, msig, 0.0).contiguous()
    eps = torch.randn((T, 4, MB), generator=gen, device=dev) * na
    eps = (eps * torch.sqrt((nonas - 1) / (eps * eps).sum(dim=(1, 2)))
           [:, None, None]).contiguous()
    cva = torch.tensor([[0.0, 1e-4, 1e-3, 1e-2]] * G, device=dev)
    cvai = torch.zeros_like(cva)
    cvai[:, 1:] = 1.0 / cva[:, 1:]
    group_of = torch.randint(0, G, (m_pad,), generator=gen, device=dev)
    static = StaticInputs(
        bed=bed, na=na.contiguous(), mave=mave, msig=msig, group_of=group_of,
        mtotgrp=torch.bincount(group_of[:MT], minlength=G), nonas=nonas,
        cva=cva, cvai=cvai, n_total=float(4 * MB - 240), m_local=MT,
        gram_cache=sk.build_gram_cache(bed, na, block_size=B,
                                       shared_na=shared),
        shared_na=shared)
    sigmag = torch.rand((T, G), generator=gen, device=dev) * 0.4 + 0.1
    sigmag[0, 1] = 0.0
    pi = torch.rand((T, G, K), generator=gen, device=dev) + 0.1
    comp = torch.randint(0, K, (T, m_pad), generator=gen, device=dev,
                         dtype=torch.int32)
    state = dict(
        eps=eps, sigmag=sigmag, pi=pi / pi.sum(-1, keepdim=True),
        sigmae=0.5 * (eps * eps).sum(dim=(1, 2)) / nonas, comp=comp,
        betas=(torch.randn((T, m_pad), generator=gen, device=dev) * 0.01
               * (comp > 0) * valid).contiguous(),
        acum=torch.rand((T, m_pad), generator=gen, device=dev))
    blk = torch.randperm(nblocks, generator=gen, device=dev)
    win = torch.argsort(torch.rand((nblocks, B), generator=gen, device=dev),
                        dim=1)
    draws = (torch.rand((nblocks, T, B), generator=gen, device=dev),
             torch.randn((nblocks, T, B), generator=gen, device=dev))
    return static, state, blk, win, draws


def sweep_kernel_phase(dev, gen):
    """Phase 2, the whole-sweep kernel: one sweep at the anchor's shapes
    against its plain version on the card, NT = 1 and NT = T, and timed
    beside the plain version and the composed chain of kernels 2, 3, 4."""
    import torch
    from gmrm_tpu_torch.ops import sweep_kernel as sk
    from gmrm_tpu_torch.sampler.gibbs import _natural_cass, marker_sweep

    i32 = torch.int32
    err, ms, plain_ms, composed_ms, bound = 0.0, [], [], [], None
    for shared in (True, False):
        static, st, blk, win, (u, z) = sweep_operands(dev, gen, shared)
        nt = static.gram_cache.shape[1]
        nblocks, m_pad = blk.numel(), static.bed.shape[0]
        tables = sk.build_sweep_tables(st["sigmag"], st["sigmae"], st["pi"],
                                       static.cva, static.cvai, static.nonas,
                                       static.n_total)
        ops = (static.bed, blk.to(i32), win.to(i32).contiguous(),
               static.m_local, static.gram_cache, None,
               static.na[:nt].contiguous(), static.mave, static.msig,
               st["betas"], st["comp"], st["acum"], static.group_of, u, z,
               st["sigmag"], *tables, 1.0 / (2.0 * st["sigmae"]),
               static.nonas)

        def run(fn, eps):
            return fn(*ops[:5], eps, *ops[6:], wave=W)

        got = run(sk.sweep_blocks, st["eps"].clone())
        torch.cuda.synchronize()
        want = run(sk.sweep_blocks_plain, st["eps"].clone())
        name = f"sweep_blocks (NT={nt})"
        cass = [_natural_cass(x[2], static.group_of, st["sigmag"], MT, K)
                for x in (got, want)]
        diff = got[2] != want[2]
        if diff.any():
            # u of each natural slot, to state how close the draw was.
            rows = (blk[:, None] * B + win).reshape(-1)
            u_nat = torch.empty_like(want[3])
            u_nat[:, rows] = u.movedim(1, 0).reshape(T, m_pad)
            margin = torch.minimum((u_nat - got[3]).abs(),
                                   (u_nat - want[3]).abs())[diff].min()
            fail(f"{name}: comp differs from the plain version in "
                 f"{int(diff.sum())} of {diff.numel()} entries; least "
                 f"margin |u - cdf| {float(margin):.3e}")
        if not torch.equal(*cass):
            fail(f"{name}: cass differs from the plain version")
        d_beta, d_eps = max_err(got[1], want[1]), max_err(got[0], want[0])
        if d_beta > 1e-4 or d_eps > 1e-4:
            fail(f"{name}: max|dbeta| {d_beta:.3e}, max|deps| {d_eps:.3e} "
                 f"exceed 1e-4")
        close(f"{name} acum", got[3], want[3], 1e-5, 1e-5)
        live = (torch.arange(m_pad, device=dev) < MT)[None] & (
            st["sigmag"][:, static.group_of] != 0)
        if len(torch.unique(want[2][live])) < 2:
            fail(f"{name}: the parity case drew a single component")
        zeroed = ~live & (torch.arange(m_pad, device=dev) < MT)[None]
        if not (zeroed.any() and (got[1][zeroed] == 0).all()
                and (got[3][zeroed] == 1).all()
                and torch.equal(got[1][:, MT:], st["betas"][:, MT:])):
            fail(f"{name}: the adaV group or the pad slots came out wrong")
        err = max(err, d_beta, d_eps)

        eps_t = st["eps"].clone()

        def sweep(fn):
            eps_t.copy_(st["eps"])
            return run(fn, eps_t)

        blocks = blk[:, None] * B + win

        def composed():
            eps_t.copy_(st["eps"])
            return marker_sweep(eps_t, st["betas"], st["comp"], st["acum"],
                                st["sigmag"], st["sigmae"], st["pi"], static,
                                blocks, u, z, wave=W, megakernel=False)

        ms.append(call_ms(lambda: sweep(sk.sweep_blocks), 10))
        plain_ms.append(call_ms(lambda: sweep(sk.sweep_blocks_plain), 1))
        composed_ms.append(call_ms(composed, 2))
        if bound is None:
            # Bytes: every operand once.  Operations: A.eps, B.eps and the
            # update per block, the Gram entries a later wave reads, and the
            # fold of each wave that moved a marker in this sweep.
            dbeta = torch.where(live, st["betas"] - got[1],
                                0.0)[:, blocks.reshape(-1)]
            moved = int((dbeta.reshape(T, nblocks, B // W, W) != 0)
                        .any(dim=3).any(dim=0)[:, :-1].sum())
            nbytes = (static.bed.numel() + 4 * (
                static.gram_cache.numel() + 2 * st["eps"].numel()
                + nt * 4 * MB + 9 * T * m_pad + m_pad + 2 * u.numel()
                + nblocks * (B + 1)))
            flops = (nblocks * (2 * 4 * T * B * 4 * MB
                                + 9 * T * (B * B - B * W) // 2
                                + T * B * K * 12)
                     + moved * 2 * T * W * B)
            bound = bound_of(nbytes, (flops, F32_OPS))
    plan = sk.sweep_plan(T, B, MB, 1, K, W)
    return (err, ms, plain_ms, composed_ms, bound), plan


def block_sweep_phase(dev, gen):
    """Phase 2, the fused per-block kernel (kernel 9): blocks of the
    anchor's operands (an adaV group; the last block has 96 pad slots)
    against its plain version on the card, NT = 1 and NT = T, from the
    shard's whole arrays in place and from the block's own slices; every
    element of the delta must be written.  Timed per launch by graph replay
    and per eager call, beside the plain version."""
    import torch
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.ops import sweep_kernel as sk

    i32 = torch.int32
    err, ms, plain_ms, eager_ms, bound = 0.0, [], [], [], None
    for shared in (True, False):
        static, st, blk, win, (u, z) = sweep_operands(dev, gen, shared)
        nt = static.gram_cache.shape[1]
        nblocks = blk.numel()
        tables = sk.build_sweep_tables(st["sigmag"], st["sigmae"], st["pi"],
                                       static.cva, static.cvai, static.nonas,
                                       static.n_total)
        win = win.to(i32).contiguous()
        grp = static.group_of.to(i32)
        m_loc = torch.tensor([MT], dtype=i32, device=dev)
        i2se = 1.0 / (2.0 * st["sigmae"])
        tail = (st["sigmag"], *tables, i2se, static.nonas)
        name = f"block_sweep (NT={nt})"

        def whole(fn, b, state):
            return fn(torch.tensor([b], dtype=i32, device=dev), m_loc,
                      static.bed, win[b], static.gram_cache, st["eps"],
                      static.na, static.mave, static.msig, *state, grp,
                      u[b], z[b], *tail, wave=W)

        def state0():
            return (st["betas"].clone(), st["comp"].clone(),
                    st["acum"].clone())

        # The last block (pad slots), the first and one in the middle.
        drawn = set()
        for b in (nblocks - 1, 0, nblocks // 2):
            got_state, want_state = state0(), state0()
            # Poison the allocator's free block of the delta's size, so an
            # element the kernel leaves unwritten shows as NaN.
            del_me = torch.full_like(st["eps"], float("nan"))
            del del_me
            got = whole(sk.block_sweep, b, got_state)
            torch.cuda.synchronize()
            want = whole(sk.block_sweep_plain, b, want_state)
            if not torch.equal(got[2], want[2]):
                fail(f"{name}, block {b}: comp differs from the plain "
                     f"version in {int((got[2] != want[2]).sum())} entries")
            if not torch.isfinite(got[0]).all():
                fail(f"{name}, block {b}: the delta has unwritten or "
                     f"non-finite elements")
            d_eps, d_beta = max_err(got[0], want[0]), max_err(got[1],
                                                              want[1])
            if d_eps > 1e-4 or d_beta > 1e-4:
                fail(f"{name}, block {b}: max|deps| {d_eps:.3e}, max|dbeta| "
                     f"{d_beta:.3e} exceed 1e-4")
            close(f"{name} acum", got[3], want[3], 1e-5, 1e-5)
            if got[0][:, :, MB - 60:].abs().max() != 0:
                fail(f"{name}, block {b}: pad columns of the delta are not 0")
            err = max(err, d_eps, d_beta)
            rows = slice(b * B, (b + 1) * B)
            drawn |= set(want[2][:, rows].reshape(-1).tolist())
            # The same block from copies of its own slices.
            sl = sk.block_sweep(
                b, MT, static.bed[rows], win[b], static.gram_cache[b:b + 1],
                st["eps"], static.na, static.mave[:, rows].contiguous(),
                static.msig[:, rows].contiguous(),
                st["betas"][:, rows].contiguous(),
                st["comp"][:, rows].contiguous(),
                st["acum"][:, rows].contiguous(), grp[rows].contiguous(),
                u[b], z[b], *tail, wave=W)
            if not (torch.equal(sl[0], got[0])
                    and torch.equal(sl[1], got[1][:, rows])
                    and torch.equal(sl[2], got[2][:, rows])
                    and torch.equal(sl[3], got[3][:, rows])):
                fail(f"{name}, block {b}: the block's slices and the whole "
                     f"arrays give different results")
        if len(drawn) < 2:
            fail(f"{name}: the parity cases drew a single component")
        # An all-pad block contributes an all-zero delta.
        pad = sk.block_sweep(0, 0, static.bed[:B], win[0],
                             static.gram_cache[:1], st["eps"], static.na,
                             static.mave[:, :B].contiguous() * 0,
                             static.msig[:, :B].contiguous() * 0,
                             st["betas"][:, :B].contiguous(),
                             st["comp"][:, :B].contiguous(),
                             st["acum"][:, :B].contiguous(),
                             grp[:B].contiguous(), u[0], z[0], *tail, wave=W)
        if pad[0].abs().max() != 0 or not torch.equal(
                pad[1], st["betas"][:, :B]):
            fail(f"{name}: an all-pad block moved the state or the delta")

        b = nblocks // 2
        state = state0()
        blk_t = torch.tensor([b], dtype=i32, device=dev)

        def run(fn):
            return fn(blk_t, m_loc, static.bed, win[b], static.gram_cache,
                      st["eps"], static.na, static.mave, static.msig, *state,
                      grp, u[b], z[b], *tail, wave=W)

        eager_ms.append(call_ms(lambda: run(sk.block_sweep), 200))
        plain_ms.append(cuda_ms(lambda: run(sk.block_sweep_plain), 5))
        # A cooperative launch is not captured into a CUDA graph, and the
        # wrapper's checks cost the host more than the kernel costs the
        # device.  Device time per launch: the wrapper's own launch call,
        # recorded once and repeated back to back with the same operands,
        # so that launches queue up, between CUDA events.
        recorded = []
        real_launch = _build.launch
        _build.launch = lambda *a: recorded.append(a) or real_launch(*a)
        try:
            run(sk.block_sweep)
        finally:
            _build.launch = real_launch
        ms.append(call_ms(lambda: real_launch(*recorded[0]), 2000))
        if bound is None:
            got = whole(sk.block_sweep, b, state0())
            rows = slice(b * B, (b + 1) * B)
            dbeta = (st["betas"][:, rows] - got[1][:, rows])[:, win[b].long()]
            moved = int((dbeta.reshape(T, B // W, W) != 0).any(dim=2)
                        .any(dim=0)[:-1].sum())
            f4 = 4
            nbytes = (B * MB + nt * (2 * B) ** 2 * f4 + 2 * T * 4 * MB * f4
                      + nt * 4 * MB * f4 + 11 * T * B * f4 + 2 * B * f4)
            flops = (2 * 4 * T * B * 4 * MB
                     + 9 * T * (B * B - B * W) // 2 + T * B * K * 12
                     + moved * 2 * T * W * B)
            bound = bound_of(nbytes, (flops, F32_OPS))
    plan = sk.block_sweep_plan(T, B, MB, 1, K, W)
    return (err, ms, plain_ms, eager_ms, bound), plan


def anchor_dataset(tmp):
    """The reference anchor of bench.py:50-57 (N=10k, Mt=20k, 4 traits)."""
    import numpy as np
    from gmrm_tpu_torch.io.sim import simulate
    return simulate(tmp, n=N, m=MT, n_traits=T, n_causal=MT // 4, h2=0.5,
                    n_groups=1, na_rate=0.0, seed=171014,
                    mixtures=np.array([0.0, 0.0001, 0.001, 0.01]))


def small_dataset(tmp):
    """The W=1 gate's panel: the anchor's N and traits, 4,096 markers, 2%
    phenotype NAs (so NT=4)."""
    import numpy as np
    from gmrm_tpu_torch.io.sim import simulate
    return simulate(tmp, n=N, m=MT_SMALL, n_traits=T, n_causal=MT_SMALL // 4,
                    h2=0.5, n_groups=1, na_rate=0.02, seed=171015,
                    mixtures=np.array([0.0, 0.0001, 0.001, 0.01]))


def big_dataset(tmp):
    """The large-N gate's panel: N=100,000 (mb_pad=25,088, where the JAX
    package leaves its resident kernel for the N-tiled one at T=4, B=128),
    4,096 markers, 4 traits with 2% phenotype NAs (NT=4)."""
    import numpy as np
    from gmrm_tpu_torch.io.sim import simulate
    return simulate(tmp, n=N_BIG, m=MT_BIG, n_traits=T, n_causal=MT_BIG // 4,
                    h2=0.5, n_groups=1, na_rate=0.02, seed=171016,
                    mixtures=np.array([0.0, 0.0001, 0.001, 0.01]))


def anchor_options(sim, out_dir, wave=W, iterations=ITERS):
    """``wave`` None lets the plan pick the wave, as a user's run does."""
    from gmrm_tpu_torch.config import Options
    opt = Options(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                  group_index_file=sim.gri, group_mixture_file=sim.grm,
                  iterations=iterations, seed=42, out_dir=out_dir,
                  block_size=B, wave_size=wave, output_thin_rate=THIN)
    opt.validate()
    opt.load_group_mixtures()
    return opt


def sweep_gate(sim, dev, wave, name, card, against="plain"):
    """Phases 3, 3b and 3c: one sweep through the default marker_sweep on
    the card (the whole-sweep kernel at W>1, kernels 5, 6 and 4 at W=1)
    against the plain versions on the host CPU or, with ``against``
    "composed", against the composed kernels 2, 3, 4 on the card.
    ``wave`` None is the auto plan, which must resolve to W=1."""
    import numpy as np
    import torch
    from gmrm_tpu_torch import runner
    from gmrm_tpu_torch.config import resolve_plan
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.ops.sweep_kernel import sweep_plan
    from gmrm_tpu_torch.sampler.gibbs import marker_sweep

    opt = anchor_options(sim, "", wave)
    resolve_plan(opt, "cuda", sim.m)
    if (opt.wave_size > 1) != (wave is not None):
        fail(f"{name}: the plan resolved to W={opt.wave_size}")
    data = runner.load_data(opt)
    static = runner.build_static(data, opt, dev)
    state = runner.init_sampler_state(data, opt, dev)
    nblocks = data.m_pad // B
    rng = np.random.default_rng(7)
    if opt.wave_size > 1:
        blocks = (rng.permutation(nblocks)[:, None] * B
                  + np.argsort(rng.uniform(size=(nblocks, B)), axis=1))
    else:
        blocks = np.concatenate([rng.permutation(data.m_local),
                                 np.arange(data.m_local, data.m_pad)])
    inj = [torch.from_numpy(a) for a in (
        blocks.reshape(nblocks, B),
        rng.uniform(size=(nblocks, T, B)).astype(np.float32),
        rng.normal(size=(nblocks, T, B)).astype(np.float32))]
    sigmae = 0.5 * (state.eps * state.eps).sum(dim=(1, 2)) / static.nonas
    if against == "plain":
        other = (torch.device("cpu"), to_device(state, "cpu"),
                 to_device(static, "cpu"), None)
    else:
        other = (dev, state, static, False)
    res, counts = {}, {}
    for key, (d, st, sta, mega) in (("kernels", (dev, state, static, None)),
                                    (against, other)):
        _build.reset_launch_counts()
        out = marker_sweep(
            st.eps.clone(), st.betas, st.comp, st.acum, st.sigmag,
            sigmae.to(d), st.pi_est, sta, *[x.to(d) for x in inj],
            wave=opt.wave_size, megakernel=mega)
        res[key] = [x.cpu() for x in out]
        counts[key] = {k: v for k, v in _build.launch_counts().items() if v}
    want_counts = ({"sweep_blocks": 1} if opt.wave_size > 1
                   else dict.fromkeys(SERIAL_KERNELS, nblocks))
    if counts["kernels"] != want_counts or (
            against == "composed"
            and counts[against] != dict.fromkeys(COMPOSED_KERNELS, nblocks)):
        fail(f"{name}: launches {counts}")
    (ke, kb, kc, _, kcass), (pe, pb, pc, _, pcass) = (res["kernels"],
                                                      res[against])
    n_diff = int((kc != pc).sum())
    db = float((kb - pb).abs().max())
    de = float((ke - pe).abs().max())
    nt = 1 if static.shared_na else T
    print(f"# {name} (W={opt.wave_size}, NT={nt}, {nblocks} blocks, "
          f"mb_pad={data.mb_pad}) against the {against} sweep: comp "
          f"mismatches {n_diff} of {kc.numel()}, cass equal "
          f"{torch.equal(kcass, pcass)}, max|dbeta| {db:.3e}, max|deps| "
          f"{de:.3e}", flush=True)
    if n_diff or not torch.equal(kcass, pcass) or db > 1e-4 or de > 1e-4:
        fail(f"{name}: the kernels disagree with the {against} sweep")
    if opt.wave_size > 1:
        plan = sweep_plan(T, B, data.mb_pad, nt, K, opt.wave_size)
        dev_inj = [x.to(dev) for x in inj]

        def sweep_ms(mega, reps):
            return call_ms(lambda: marker_sweep(
                state.eps.clone(), state.betas, state.comp, state.acum,
                state.sigmag, sigmae, state.pi_est, static, *dev_inj,
                wave=opt.wave_size, megakernel=mega), reps)

        timing = f"{sweep_ms(None, 5):.3f} ms per marker_sweep"
        if against == "composed":
            timing += f", composed {sweep_ms(False, 2):.3f} ms"
        print(f"# {name}: whole-sweep kernel grid {plan['grid']} CTAs x "
              f"{plan['cols']} byte columns, eps {plan['eps_bytes_per_cta']} "
              f"bytes per CTA, {plan['smem_bytes']} bytes of shared memory; "
              f"resident in shared memory: {', '.join(plan['resident'])}; "
              f"{timing} (CUDA events around eager calls)  [{card}]",
              flush=True)
    return 0 if static.gram_cache is None else static.gram_cache.numel() * 4


def training_phase(sim, dev, tmp, wave, iterations):
    """Phases 4 and 4b: run_training through the entry point.  In wave mode
    the Gram cache launches once per run and the whole-sweep kernel once per
    iteration; at W=1 the path's kernels each launch once per block and
    iteration.  The other paths' kernels launch not at all."""
    import numpy as np
    from gmrm_tpu_torch.io.writers import read_history
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.runner import check_finite_chain, run_training

    out_dir = os.path.join(tmp, f"out_w{wave}")
    opt = anchor_options(sim, out_dir, wave, iterations)
    _build.reset_launch_counts()
    res = run_training(opt, device=dev, verbose=False)
    launches = _build.launch_counts()
    nblocks = -(-MT // B)
    per_run = {"gram_cache": 1, "sweep_blocks": iterations}
    path = MEGA_KERNELS if wave > 1 else SERIAL_KERNELS
    for name, n in launches.items():
        want = (0 if name not in path
                else per_run.get(name, nblocks * iterations))
        if n != want:
            fail(f"W={wave} training: kernel {name} launched {n} times, "
                 f"expected {want}")
    check_finite_chain(res.state.sigmag.cpu().numpy(),
                       res.state.sigmae.cpu().numpy(), iterations)
    for ph in sim.phens:
        base = os.path.join(out_dir, os.path.splitext(
            os.path.basename(ph))[0])
        its, bet = read_history(base + ".bet", "f8")
        _, cpn = read_history(base + ".cpn", "i4")
        if (bet.shape != (iterations // THIN, MT) or cpn.shape != bet.shape
                or list(its) != list(range(THIN, iterations + 1, THIN))
                or not np.isfinite(bet).all()
                or cpn.min() < 0 or cpn.max() >= K):
            fail(f"{base}.bet/.cpn do not read back as expected")
    # Thin boundaries sync the device, so iterations THIN+1 .. the last
    # span sync to sync.
    steady = sum(res.iter_seconds[THIN:]) / (iterations - THIN)
    sg = res.state.sigmag.sum(dim=1).cpu().numpy()
    se = res.state.sigmae.cpu().numpy()
    return res, launches, steady, sg / (sg + se)


def sharded_setup(sim, dev, n_shards, wave=W):
    """The per-shard static inputs, start states and RNG plans of ``sim``,
    as run_training_sharded builds them, every shard on ``dev``; ``wave``
    None is the auto plan."""
    from gmrm_tpu_torch.config import resolve_plan
    from gmrm_tpu_torch.parallel import runner as prunner
    from gmrm_tpu_torch.sampler.dists import RngPlan

    opt = anchor_options(sim, "", wave)
    resolve_plan(opt, "cuda", sim.m // n_shards, sharded=True)
    data = prunner.load_data_process(opt, n_shards,
                                     interleave=opt.wave_size > 1)
    return (opt, data, prunner.build_static_sharded(data, opt, dev),
            prunner.init_states_sharded(data, opt, dev),
            [RngPlan(opt.seed, dev, shard=i) for i in range(n_shards)])


def sharded_gate(sim, dev, card, n_shards, wave, name):
    """Phases 3d and 3e: one sharded sweep on the card, with the same
    injected order and draws per shard on both sides.  At W > 1 the fused
    per-block kernel against the composed kernels 2, 3 and 4 at the same
    cadence, both on the card; with ``wave`` None (the auto plan, which
    must resolve to W=1) kernels 5, 6 and 4 adding into a delta against
    their plain versions on the host CPU."""
    import numpy as np
    import torch
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.parallel.distributed import Communicator
    from gmrm_tpu_torch.sampler.gibbs import marker_sweep_sharded

    opt, data, statics, states, _ = sharded_setup(sim, dev, n_shards, wave)
    if (opt.wave_size > 1) != (wave is not None):
        fail(f"{name}: the plan resolved to W={opt.wave_size}")
    mps = data.layout.m_pad_shard
    nblocks = mps // B
    rng = np.random.default_rng(11)
    if opt.wave_size > 1:
        orders = [rng.permutation(nblocks)[:, None] * B
                  + np.argsort(rng.uniform(size=(nblocks, B)), axis=1)
                  for _ in range(n_shards)]
    else:
        orders = [np.concatenate([rng.permutation(ln), np.arange(ln, mps)])
                  .reshape(nblocks, B) for ln in data.m_local]
    u = [rng.uniform(size=(nblocks, T, B)).astype(np.float32)
         for _ in range(n_shards)]
    z = [rng.normal(size=(nblocks, T, B)).astype(np.float32)
         for _ in range(n_shards)]
    first = states[0]
    sigmae = 0.5 * (first.eps * first.eps).sum(dim=(1, 2)) / statics[0].nonas
    n_launch = n_shards * nblocks
    if opt.wave_size > 1:
        sides = (("fused", dev, None, {"block_sweep": n_launch}),
                 ("composed", dev, False,
                  dict.fromkeys(COMPOSED_KERNELS, n_launch)))
    else:
        sides = (("kernels", dev, None,
                  dict.fromkeys(SERIAL_KERNELS, n_launch)),
                 ("plain", torch.device("cpu"), None, {}))
    res, ms = [], []
    for key, d, mega, want in sides:
        eps0 = first.eps.to(d)
        marker = [(st.betas.to(d), st.comp.to(d), st.acum.to(d))
                  for st in states]
        sta = [to_device(x, d) for x in statics]
        inj = [[torch.from_numpy(a).to(d) for a in arrs]
               for arrs in (orders, u, z)]

        def sweep():
            return marker_sweep_sharded(
                eps0.clone(), marker, first.sigmag.to(d), sigmae.to(d),
                first.pi_est.to(d), sta, *inj, wave=opt.wave_size,
                comm=Communicator(d), megakernel=mega)
        _build.reset_launch_counts()
        out = sweep()
        counts = {k: v for k, v in _build.launch_counts().items() if v}
        if counts != want:
            fail(f"{name}, {key}: launches {counts}, expected {want}")
        res.append((out[0].cpu(), [[x.cpu() for x in ms_] for ms_ in out[1]],
                    out[2].cpu()))
        ms.append(call_ms(sweep, 2) if d.type == "cuda" else None)
    (ae, a_st, acass), (be, b_st, bcass) = res
    n_diff = sum(int((a[1] != b[1]).sum()) for a, b in zip(a_st, b_st))
    db = max(max_err(a[0], b[0]) for a, b in zip(a_st, b_st))
    de = max_err(ae, be)
    moved = sum(int((a[1] != 0).sum()) for a in a_st)
    timing = "; ".join(f"{t:.3f} ms per sharded sweep {side[0]}"
                       for side, t in zip(sides, ms) if t is not None)
    print(f"# {name} (S={n_shards}, W={opt.wave_size}, {nblocks} blocks per "
          f"shard, shards of {data.m_local} markers, mb_pad={data.mb_pad}): "
          f"{sides[0][0]} against {sides[1][0]} at the same cadence: comp "
          f"mismatches {n_diff} of {n_shards * T * mps}, cass equal "
          f"{torch.equal(acass, bcass)}, max|dbeta| {db:.3e}, max|deps| "
          f"{de:.3e}; {timing} (CUDA events around eager calls)  [{card}]",
          flush=True)
    if (n_diff or not torch.equal(acass, bcass) or db > 1e-4 or de > 1e-4
            or not moved):
        fail(f"{name}: the two sides disagree")


def sharded_training_phase(sim, dev, tmp, n_shards, wave, iterations,
                           nccl=False):
    """Phases 4d and 4e: run_training_sharded through the entry point, all
    shards on the one card; with ``nccl`` inside a one-rank NCCL process
    group.  The Gram cache launches once per shard, the fused per-block
    kernel once per shard, block step and iteration, nothing else."""
    import numpy as np
    import torch.distributed as dist
    from gmrm_tpu_torch.io.writers import read_history
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.parallel.distributed import init_distributed
    from gmrm_tpu_torch.parallel.runner import run_training_sharded

    out_dir = os.path.join(tmp, f"out_s{n_shards}{'_nccl' if nccl else ''}")
    opt = anchor_options(sim, out_dir, wave, iterations)
    if nccl:
        init_distributed(f"file://{tmp}/rendezvous_s{n_shards}", 1, 0,
                         backend="nccl", timeout_seconds=120)
    try:
        _build.reset_launch_counts()
        res = run_training_sharded(opt, n_devices=n_shards, device=dev,
                                   verbose=False)
        launches = _build.launch_counts()
    finally:
        if nccl:
            dist.destroy_process_group()
    if opt.wave_size != W:
        fail(f"S={n_shards} training: the plan resolved to W={opt.wave_size}")
    nblocks = -(-(-(-MT // n_shards)) // B)     # ceil(ceil(MT / S) / B)
    want = {"gram_cache": n_shards,
            "block_sweep": n_shards * nblocks * iterations}
    for name, n in launches.items():
        if n != want.get(name, 0):
            fail(f"S={n_shards} training: kernel {name} launched {n} times, "
                 f"expected {want.get(name, 0)}")
    for ph in sim.phens:
        base = os.path.join(out_dir, os.path.splitext(
            os.path.basename(ph))[0])
        its, bet = read_history(base + ".bet", "f8")
        _, cpn = read_history(base + ".cpn", "i4")
        if (bet.shape != (iterations // THIN, MT) or cpn.shape != bet.shape
                or list(its) != list(range(THIN, iterations + 1, THIN))
                or not np.isfinite(bet).all()
                or cpn.min() < 0 or cpn.max() >= K or not (cpn != 0).any()):
            fail(f"{base}.bet/.cpn do not read back as expected")
    # Thin boundaries sync the device: iterations THIN+1 .. the last span
    # sync to sync; a chain of THIN iterations is timed whole.
    if iterations > THIN:
        steady = sum(res.iter_seconds[THIN:]) / (iterations - THIN)
        span = f"iterations {THIN + 1}-{iterations}"
    else:
        steady = res.chain_seconds / iterations
        span = f"the whole chain of {iterations}"
    sg = res.state[0].sigmag.sum(dim=1).cpu().numpy()
    se = res.state[0].sigmae.cpu().numpy()
    h2 = sg / (sg + se)
    if not (np.isfinite(h2).all() and (h2 > 0.05).all() and (h2 < 0.95).all()):
        fail(f"S={n_shards} training: h2 {h2}")
    return res, launches, steady, span, h2, out_dir


def same_artifacts(sim, dir_a, dir_b):
    """Whether two runs wrote the same .bet/.cpn/.csv bytes."""
    for ph in sim.phens:
        base = os.path.splitext(os.path.basename(ph))[0]
        for suffix in (".bet", ".cpn", ".csv"):
            with open(os.path.join(dir_a, base + suffix), "rb") as fa, \
                    open(os.path.join(dir_b, base + suffix), "rb") as fb:
                if fa.read() != fb.read():
                    return False
    return True


def chain_setup(sim, dev):
    """The anchor's data, static inputs, start state and RNG plan, as
    run_training builds them."""
    from gmrm_tpu_torch import runner
    from gmrm_tpu_torch.config import resolve_plan
    from gmrm_tpu_torch.sampler.dists import RngPlan

    opt = anchor_options(sim, "")
    resolve_plan(opt, "cuda", sim.m)
    data = runner.load_data(opt)
    return (opt, runner.build_static(data, opt, dev),
            runner.init_sampler_state(data, opt, dev), RngPlan(opt.seed, dev))


def composed_phase(sim, dev):
    """Phase 4c: the composed wave path (kernels 2, 3 and 4 per block) for
    a few iterations of gibbs_iteration, so the earlier path stays driven."""
    import torch
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.runner import check_finite_chain
    from gmrm_tpu_torch.sampler.gibbs import gibbs_iteration

    opt, static, state, rng = chain_setup(sim, dev)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    seconds = []
    for it in range(1, ITERS_COMPOSED + 1):
        t0 = time.perf_counter()
        state, _ = gibbs_iteration(state, static, it, rng, block_size=B,
                                   wave=opt.wave_size, megakernel=False)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = _build.launch_counts()
    nblocks = -(-MT // B)
    for name, n in launches.items():
        want = nblocks * ITERS_COMPOSED if name in COMPOSED_KERNELS else 0
        if n != want:
            fail(f"composed path: kernel {name} launched {n} times, "
                 f"expected {want}")
    check_finite_chain(state.sigmag.cpu().numpy(),
                       state.sigmae.cpu().numpy(), ITERS_COMPOSED)
    return launches, sum(seconds[1:]) / (ITERS_COMPOSED - 1)


def profile_phase(sim, dev, n_shards=0):
    """Phase 5: torch.profiler over 5 iterations at the anchor after 2 of
    warm-up, on the whole-sweep path or, with ``n_shards``, on the sharded
    path.  Returns the device-busy and wall milliseconds per iteration,
    launches per iteration and the busiest device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gmrm_tpu_torch.parallel.distributed import Communicator
    from gmrm_tpu_torch.sampler.gibbs import (
        gibbs_iteration, gibbs_iteration_sharded,
    )

    if n_shards:
        opt, _, static, state, rng = sharded_setup(sim, dev, n_shards)
        comm = Communicator(dev)

        def step(state, it):
            return gibbs_iteration_sharded(
                state, static, it, rng, block_size=B, wave=opt.wave_size,
                comm=comm)[0]
    else:
        opt, static, state, rng = chain_setup(sim, dev)

        def step(state, it):
            return gibbs_iteration(state, static, it, rng, block_size=B,
                                   wave=opt.wave_size)[0]
    for it in (1, 2):
        state = step(state, it)
    torch.cuda.synchronize()
    n = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in range(3, 3 + n):
            state = step(state, it)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events
               if "cuda" in str(e.device_type).lower() and e.name != ""]
    def device_us(e):            # named cuda_time before torch 2.4
        return getattr(e, "device_time", None) or e.cuda_time

    busy_us = sum(device_us(e) for e in kernels)
    if busy_us <= 0:
        fail("torch.profiler recorded no device time")
    launches = sum(1 for e in events if e.name.startswith("cudaLaunch"))
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + device_us(e)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return (busy_us / 1e3 / n, wall * 1e3 / n, launches / n,
            [(k[:48], round(v / 1e3 / n, 3)) for k, v in top])


SOURCES = {
    "gram_cache": ("gmrm_tpu_torch/csrc/gram_cache.cu",
                   "gmrm_tpu/ops/sweep_kernel.py:1158"),
    "block_cdot": ("gmrm_tpu_torch/csrc/block_cdot.cu",
                   "gmrm_tpu/ops/pallas_kernels.py:275"),
    "wave_scan": ("gmrm_tpu_torch/csrc/wave_scan.cu",
                  "gmrm_tpu/ops/scan_kernel_wave.py:57"),
    "eps_update": ("gmrm_tpu_torch/csrc/eps_update.cu",
                   "gmrm_tpu/ops/pallas_kernels.py:352"),
    "block_gram": ("gmrm_tpu_torch/csrc/block_gram.cu",
                   "gmrm_tpu/ops/pallas_kernels.py:135"),
    "serial_scan": ("gmrm_tpu_torch/csrc/serial_scan.cu",
                    "gmrm_tpu/ops/scan_kernel.py:61"),
    "sweep_blocks": ("gmrm_tpu_torch/csrc/sweep_blocks.cu",
                     "gmrm_tpu/ops/sweep_kernel.py:371"),
    "block_sweep": ("gmrm_tpu_torch/csrc/block_sweep.cu",
                    "gmrm_tpu/ops/sweep_kernel.py:961"),
}
# The whole-sweep kernel also stands for the N-tiled TPU kernel.
ALSO_REPLACES = {"sweep_blocks": "gmrm_tpu/ops/sweep_kernel.py:576"}


def training_only(dev, reps, card, repo):
    """Phases 4 and 4b ``reps`` times on one simulated anchor: the steady
    ms/iteration of every run, for comparing two trees inside one call."""
    with tempfile.TemporaryDirectory() as tmp:
        sim = anchor_dataset(os.path.join(tmp, "data"))
        for rep in range(reps):
            for wave, iters in ((W, ITERS), (1, ITERS_SERIAL)):
                run_dir = os.path.join(tmp, f"run{rep}_w{wave}")
                os.makedirs(run_dir)
                steady = training_phase(sim, dev, run_dir, wave, iters)[2]
                print(f"# {repo}: training W={wave}, run {rep + 1}: "
                      f"{steady * 1e3:.2f} ms/iteration  [{card}]",
                      flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--training-only", type=int, default=0,
                        metavar="REPS")
    parser.add_argument("--repo", default=REPO)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, os.path.abspath(args.repo))
    from gmrm_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    if args.training_only:
        _build.library()
        training_only(dev, args.training_only, card, args.repo)
        return

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"# build: {lib.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"# ptxas {line.strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    kernels = kernel_phase(dev, gen)
    for name, (err, t_k, t_p, t_call, bound) in kernels.items():
        print(f"# {name}: max abs err {err:.3e}; kernel ms {t_k}, plain ms "
              f"{t_p} (CUDA graph replay); kernel ms per eager call "
              f"{t_call}; bound {bound[0]:.5f} ms by {bound[1]}  [{card}]",
              flush=True)
    (err, t_k, t_p, t_c, bound), plan = sweep_kernel_phase(dev, gen)
    kernels["sweep_blocks"] = (err, t_k, t_p, None, bound)
    chain = 157 * sum(kernels[k][1][0] for k in COMPOSED_KERNELS)
    print(f"# sweep_blocks, one sweep of {-(-MT // B)} blocks at NT=1 and "
          f"NT={T}: comp and cass equal to the plain version, max abs err of "
          f"beta and eps {err:.3e}; kernel ms per sweep {t_k}, plain ms "
          f"{t_p}, composed chain (kernels 2+3+4 and their torch glue) ms "
          f"{t_c}, all by CUDA events around eager calls (a cooperative "
          f"launch; one launch is a whole sweep); the three composed kernels "
          f"alone by graph replay: {chain:.3f} ms per sweep; bound "
          f"{bound[0]:.5f} ms by {bound[1]}; grid {plan['grid']} CTAs x "
          f"{plan['cols']} byte columns, eps {plan['eps_bytes_per_cta']} "
          f"bytes per CTA, resident in shared memory: "
          f"{', '.join(plan['resident'])}  [{card}]", flush=True)

    (err, t_k, t_p, t_call, bound), bplan = block_sweep_phase(dev, gen)
    kernels["block_sweep"] = (err, t_k, t_p, t_call, bound)
    print(f"# block_sweep, blocks of the same operands at NT=1 and NT={T}, "
          f"from the shard's whole arrays in place and from the block's own "
          f"slices, and an all-pad block: comp equal to the plain version, "
          f"every element of the delta written, max abs err of the delta "
          f"and beta {err:.3e}; kernel ms per launch {t_k} (CUDA events "
          f"around 2,000 queued launches; a cooperative launch), plain ms "
          f"{t_p} (CUDA graph replay), ms per eager call of the wrapper "
          f"{t_call}; bound {bound[0]:.5f} ms by {bound[1]}; grid "
          f"{bplan['grid']} CTAs x {bplan['cols']} byte columns, "
          f"{bplan['smem_bytes']} bytes of shared memory, resident: "
          f"{', '.join(bplan['resident'])}  [{card}]", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sim = anchor_dataset(os.path.join(tmp, "data"))
        small = small_dataset(os.path.join(tmp, "small"))
        big = big_dataset(os.path.join(tmp, "big"))
        print(f"# anchor, small and large-N datasets simulated in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        cache_bytes = sweep_gate(sim, dev, W, "sweep gate", card)
        sweep_gate(small, dev, None, "W=1 sweep gate", card)
        sweep_gate(big, dev, W, "large-N sweep gate", card,
                   against="composed")
        runs = {w: training_phase(sim, dev, tmp, w, iters)
                for w, iters in ((W, ITERS), (1, ITERS_SERIAL))}
        composed_launches, composed_s = composed_phase(sim, dev)
        busy_ms, wall_ms, n_launch, top = profile_phase(sim, dev)
        sharded_gate(sim, dev, card, 4, W, "sharded sweep gate")
        sharded_gate(small, dev, card, 2, None, "sharded W=1 sweep gate")
        sharded = {(s, False): sharded_training_phase(sim, dev, tmp, s, w, n)
                   for s, w, n in SHARDED_RUNS}
        s0, w0, n0 = SHARDED_RUNS[0]
        sharded[(s0, True)] = sharded_training_phase(sim, dev, tmp, s0, w0,
                                                     n0, nccl=True)
        if not same_artifacts(sim, sharded[(s0, False)][5],
                              sharded[(s0, True)][5]):
            fail("the run inside a one-rank NCCL group wrote other bytes "
                 "than the run without a group")
        sh_prof = profile_phase(sim, dev, n_shards=s0)
    torch.cuda.synchronize()
    for w, (res, launches, steady, h2) in runs.items():
        startup = ("load + stats + Gram cache of "
                   f"{cache_bytes / 2**20:.1f} MiB" if w > 1
                   else "load + stats")
        print(f"# training W={w}: startup {res.startup_seconds:.2f} s "
              f"({startup}); steady {steady * 1e3:.2f} ms/iteration = "
              f"{MT / steady:.0f} markers/s over iterations {THIN + 1}-"
              f"{res.iters_run}; chain {res.chain_seconds:.2f} s for "
              f"{res.iters_run} iterations; h2 "
              f"{[round(float(x), 3) for x in h2]}; launches {launches}  "
              f"[{card}]", flush=True)
    print(f"# composed wave path (megakernel=False), W={W}: "
          f"{composed_s * 1e3:.2f} ms/iteration = {MT / composed_s:.0f} "
          f"markers/s over iterations 2-{ITERS_COMPOSED}, each ended by a "
          f"synchronize; launches {composed_launches}  [{card}]", flush=True)
    print(f"# profiler, whole-sweep path, 5 iterations: device busy "
          f"{busy_ms:.3f} ms/iteration, wall {wall_ms:.3f} ms/iteration, "
          f"idle share {1 - busy_ms / wall_ms:.3f}, {n_launch:.1f} launches "
          f"per iteration; busiest kernels (ms/iteration) {top}  [{card}]",
          flush=True)

    for (n_sh, nccl), (res, launches, steady, span, h2, _) in sharded.items():
        how = ("inside a one-rank NCCL process group, artifacts byte-equal "
               "to the run without a group" if nccl
               else "no process group")
        print(f"# sharded training S={n_sh} (all shards on the one card, "
              f"{how}), W={W}: startup {res.startup_seconds:.2f} s (load + "
              f"stats + {n_sh} Gram caches); {steady * 1e3:.2f} ms/iteration "
              f"= {MT / steady:.0f} markers/s over {span}; h2 "
              f"{[round(float(x), 3) for x in h2]}; launches {launches}  "
              f"[{card}]", flush=True)
    busy_s, wall_s, launch_s, top_s = sh_prof
    print(f"# profiler, sharded path S={SHARDED_RUNS[0][0]}, 5 iterations: "
          f"device busy {busy_s:.3f} ms/iteration, wall {wall_s:.3f} "
          f"ms/iteration, idle share {1 - busy_s / wall_s:.3f}, "
          f"{launch_s:.1f} launches per iteration; busiest kernels "
          f"(ms/iteration) {top_s}  [{card}]", flush=True)

    # Launches: each path's run, its counts set to 0 just before it (the
    # whole-sweep and W=1 training runs, the composed iterations and the
    # sharded training runs without a process group).
    # library_ms: no single PyTorch call computes any of these functions
    # (each fuses the 2-bit decode with a product, or is a serial scan).
    rows = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": (sum(r[1][name] for r in runs.values())
                          + composed_launches[name]
                          + sum(r[1][name] for (_, nccl), r
                                in sharded.items() if not nccl)),
             "max_abs_err": kernels[name][0],
             "ms": kernels[name][1][0], "plain_ms": kernels[name][2][0],
             "bound_ms": kernels[name][4][0], "bound_by": kernels[name][4][1],
             "library_ms": None,
             **({"also_replaces": ALSO_REPLACES[name]}
                if name in ALSO_REPLACES else {})}
            for name, (src, rep) in SOURCES.items()]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
