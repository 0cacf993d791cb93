#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (gmrm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. build the CUDA kernels of gmrm_tpu_torch/csrc with nvcc (sm_90a), one
   nvcc per source, all started together; meanwhile worker processes
   simulate the datasets of phases 3 to 5;
2. each kernel against its plain PyTorch version on the card, at the
   training paths' shapes (T=4 traits, B=128, W=32, K=4, mb_pad=2560),
   with shared (NT=1) and per-trait (NT=4) NA masks, timed beside the
   plain version by replaying a CUDA graph of many calls (device time),
   and per eager call.  The Gram cache (kernel 1) is held bit-equal at the
   anchor, at B=192, at mb=203 and at mb_pad=25,088 (157 blocks), beside
   torch.bmm on pre-decoded operands; the wave scan (kernel 3) runs on the
   anchor's (157, ..., B) arrays with a block index (a middle and the last
   block, twice, bit-equal), on one block's tensors, and on shapes that
   reach its other branches, with one stamped launch.  The block Gram
   (kernel 5) builds a run of blocks
   per launch (all 157 at NT=1, a run under its byte budget at NT=4) and
   one block alone; the serial scan (kernel 6) runs on the sweep's arrays
   with a block index and on one block's tensors; the c-dot and the update
   (kernels 2 and 4) and the two fused into one launch run on one block
   (also at mb 200 and 203: a one-level tree, byte copies), launched twice
   on the same inputs (bit-equal), then as the W=1 sweep launches them, on
   the sweep's arrays with a block index, where they are timed, beside
   torch.matmul on pre-decoded operands, and once more at mb_pad=25,088.
   The whole-sweep kernel runs one sweep of the
   anchor's 157 blocks (an adaV group, a partly padded last block) against
   its plain version and against the composed chain of kernels 2, 3 and 4;
   one launch is a whole sweep, so it is timed with CUDA events around
   eager launches, and one more launch records the kernel's %globaltimer
   stamps, which split a block's time into its phases.  The sharded
   sweep's block-step kernel (kernel 9) runs one block step of 1, 2 and 4
   shards of the same operands (the last block's pad slots, a block of pad
   slots only, shards of different real marker counts) against its plain
   version (comp exact, every element of the out-mode sum written), twice
   (bit-equal), in place against out mode plus the add (bit-equal), as
   one launch per shard against one launch (bit-equal) and, for one
   shard, from a block's own slices against the whole arrays (bit-equal);
   the same again on four blocks of two wide panels, mb_pad=25,088 (NT=4)
   and 60,000 (NT=1), where a column CTA takes its columns in tiles; timed
   per launch by graph replay, per eager step and by the host's clock,
   beside a torch.matmul yardstick, with one stamped launch each;
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
   block-step kernel (one launch per block step for all 4 shards, the sum
   added into the residual in place) against the composed kernels 2, 3
   and 4 run at the same cadence (per block step every shard against the
   one residual, then the sum of the deltas), same order and draws;
3e. one sharded sweep on the small panel, 2 shards of 16 blocks, where the
   auto plan resolves to W=1: kernels 5, 2, 6 and 4 adding into a delta
   against their plain versions on the host CPU;
4. the training entry point, gmrm_tpu_torch.runner.run_training, on the
   reference anchor (N=10,000 x Mt=20,000 x 4 traits, bench.py:50-57) in
   wave mode for 20 iterations with thinned output: the whole-sweep kernel
   launches once per iteration, between the two CUDA graphs of the host's
   arithmetic, and kernels 2-6 not at all; the chain and the written
   artifacts are checked, the run's peak device memory is printed, and its
   state after 20 iterations must equal, bit for bit, that of 20 eager
   gibbs_iteration calls from the same start and seed;
4b. the same at W=1 (--wave-size 1) for 10 iterations, checking the
   launch counts of the exact serial path: per sweep one block-Gram launch
   per run of blocks, the c-dot of block 0, the serial scan per block,
   the fused update and next c-dot for every block but the last, whose
   update runs alone;
4c. the composed wave path (megakernel=False) for 5 iterations of
   gibbs_iteration at the anchor, checking its launch counts: per sweep the
   c-dot of block 0, the wave scan per block, the fused update and next
   c-dot for every block but the last and the last block's update alone;
4d. the sharded entry point, gmrm_tpu_torch.parallel.runner
   .run_training_sharded, at the anchor: 2 shards on the auto plan (79
   blocks per shard, so W=32 and the block-step kernel) for 10
   iterations, and 4 shards at an explicit W=32 for 5, all shards on the one
   card; launch counts (the block-step kernel once per block step and
   iteration), the chain and the artifacts are checked;
4e. the 2-shard run again inside a one-rank NCCL process group, so that
   every sum of the path goes through NCCL on CUDA tensors (the kernel in
   out mode, then the all-reduce and the add); its artifacts must equal
   phase 4d's (in place) byte for byte;
4f. resume and the startup cache on the card: at W=32, 12 iterations with
   --checkpoint-every 7 and a fresh --cache-dir (cold: the Gram cache
   kernel once, the whole-sweep kernel 12 times), then --resume to 20 from
   the warm cache (the Gram cache kernel not at all, the sweep 13 times),
   the warm mave, msig and Gram cache equal to a build without the cache;
   at W=1 a checkpoint at 3, 5 iterations, the resume to 10; the 2-shard
   run the same, with a cache entry per shard; the .csv/.bet/.cpn bytes of
   each resumed chain equal phase 4's, 4b's and 4d's.  Prints the seconds
   and bytes of one checkpoint save at the anchor, the cold and warm
   startups and the cache key's digest;
5. a torch.profiler window over 5 whole-sweep iterations at the anchor (as
   run_training runs them), one over 5 W=1 iterations, one over 5 composed
   iterations and one over 5 sharded iterations (2 shards): device-busy
   and wall time per iteration, idle share, host-issued launches and graph
   replays per iteration;
6. predict (run after phase 4): its kernel (csrc/predict_sums.cu) against
   its plain version at the anchor's bed (the NA-free trait, and a 2% NA
   mask) and on the large-N panel's bed (xtx bit-equal, xty within
   1e-5 sum|val*y| + 1e-6, two launches bit-equal), timed by graph replay
   beside torch.mv on pre-decoded operands; then the entry point,
   gmrm_tpu_torch.predict.run_predict, on phase 4's W=32 .bet files: on the
   card (one kernel launch per trait), again through the command line
   (python -m gmrm_tpu_torch --predict: the same .mlma bytes) and on the
   CPU (equal ids and layout, fields within the xty bound), with the wall
   time of each run_predict call split into read, upload, sums, OLS and
   write;
7. float64 (``--dtype float64``: the exact serial W=1 path on kernels A-D,
   csrc/block_gram.cu's float64 scaling, csrc/passes_f64.cu,
   csrc/serial_scan_f64.cu, csrc/predict_sums.cu's float64 kernel): each
   against its float64 plain version at the anchor's shapes (A bit-equal;
   B, C within 1e-10 of the largest magnitude, C's comp exact; D's xtx
   bit-equal, xty within 1e-11 sum|val*y| + 1e-12), timed by graph replay
   beside float64 torch.matmul / torch.mv yardsticks; one float64 sweep on
   the small panel against the plain float64 sweep on the host CPU;
   run_training at the anchor (W=1, 10 iterations) twice from one seed,
   byte-equal, with no float32 kernel launched, a profiler window over 5
   float64 iterations, and the chain cut at 5 and resumed,
   byte-equal; one S=2 sharded float64 sweep against the plain one;
   run_training_sharded at S=2, and inside a one-rank NCCL group,
   byte-equal; run_predict at float64 on the card and on the CPU.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without CUDA, or without the
rest of the repository beside it, the script fails before printing any
result.

To compare two trees on the single-device training paths inside one call
on one card (parent, change, change, parent):

    python3 chip_smoke.py --training-only 3 [--repo OTHER_TREE]

builds the kernels of the tree at --repo (default: this one), runs phases
4, 4b and 4c and phase 5's W=32, W=1 and composed profiler windows three
times and prints each run's ms/iteration, idle share and host-issued
calls, nothing else.
``--sweep-only REPS [--repo TREE]`` does the same for phase 2's whole-sweep
kernel: its gate against the plain version, its ms per sweep and, where
the tree's kernel records them, its stamps.  ``--sharded-only REPS [--repo
TREE]`` runs phase 4d (2 and 4 shards) and the sharded profiler windows
(1, 2 and 4 shards) with the host's microseconds per block step of a
sharded sweep, and kernel 9's device time per block step of 1, 2 and 4
shards on phase 2's wide panels (a tree of the earlier design launches
once per shard); with ``--training-only`` in the same process.
``--same-bytes TREE`` runs phase 4's and 4b's float32 chains in TREE and
in this tree (TREE, this, this, TREE; a process each) and requires equal
``.bet/.cpn/.csv`` bytes, and equal bytes from the float32 block Gram and
predict sums kernels on seeded inputs.
"""

import argparse
import concurrent.futures
import dataclasses
import gc
import json
import multiprocessing
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
MB_BIG = 25_088
# Per block of a sharded composed W>1 sweep (the update into a delta); one
# device fuses kernels 4 and 2 (composed_counts).
COMPOSED_KERNELS = ("block_cdot", "wave_scan", "eps_update")
# Per block of a sharded W=1 sweep; one device fuses kernels 4 and 2.
SERIAL_KERNELS = ("block_cdot", "serial_scan", "eps_update")
SHARDED_RUNS = ((2, None, 10), (4, W, 5))   # shards, --wave-size, iterations
# The whole-sweep kernel's earlier design (three grid syncs a block), ms per
# sweep at NT=1 and NT=4 (PERF.md section 6, row 7).
EARLIER_SWEEP_MS = (2.673, 2.663)
# Kernels 2 and 4 in their earlier design (a CTA per marker row; a thread
# per phase plane and byte column), ms per launch at NT=1 (and NT=4)
# (PERF.md section 6, rows 2 and 4).
EARLIER_PASSES_MS = {"block_cdot": (0.0294,), "eps_update": (0.0424, 0.0423)}
# Kernel 9 in its earlier design (one cooperative launch per shard and block
# step, three grid syncs), ms per launch of one shard's block at NT=1 and
# NT=4, and ms per eager call of its wrapper (PERF.md section 6, row 9).
EARLIER_BLOCK_SWEEP_MS = {"launch": (0.0297, 0.0282), "call": (0.077, 0.095)}
SHARDS_PHASE2 = (1, 2, 4)     # local shards of kernel 9's launches in phase 2
# Kernels 1 and 3 in their earlier designs (scalar int32 4x4 register tiles,
# all four quadrants; one CTA of 256 threads reading every operand from
# global memory), ms per launch at NT=1 and NT=4, and per block (PERF.md
# section 6, rows 1 and 3).
EARLIER_GRAM_CACHE_MS = (10.12, 38.49)
EARLIER_WAVE_SCAN_MS = (0.0267,)

# Peak rates of one NVIDIA H100 SXM (data sheet, dense, at 700 W): device
# memory bytes/s, float32 outside the tensor cores, int8 tensor cores,
# float64 outside the tensor cores (the float64 kernels use none).
HBM_BPS, F32_OPS, INT8_OPS, F64_OPS = 3.35e12, 67e12, 1979e12, 33.5e12
ITERS_F64 = 10          # the float64 anchor run (phase 7)


def bound_of(nbytes, *ops_and_rates):
    """The least milliseconds the card could take: the larger of the bytes
    the function must move over the memory rate and its operations, each
    type over its peak rate.  Returns (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BPS
    t_ops = sum(ops / rate for ops, rate in ops_and_rates)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def serial_counts(nblocks, nt, sweeps=1, shards=1, fused=True):
    """Launches of ``sweeps`` W=1 sweeps of ``shards`` shards of ``nblocks``
    blocks: kernel 6 once per block and kernel 5 once per run of blocks
    under the Gram byte budget; on one device (``fused``) kernel 2 once
    for the first block, the fused pass once for each block but the last
    and kernel 4 once for the last, on a sharded run kernels 2 and 4 once
    per block."""
    from gmrm_tpu_torch.ops.block_gram import gram_run_blocks
    runs = -(-nblocks // gram_run_blocks(T, B, nt, nblocks))
    per_sweep = ({"block_cdot": 1, "serial_scan": nblocks,
                  "update_cdot": nblocks - 1, "eps_update": 1} if fused
                 else dict.fromkeys(SERIAL_KERNELS, nblocks))
    per_sweep["block_gram"] = runs
    return {k: v * sweeps * shards for k, v in per_sweep.items() if v}


def f64_counts(nblocks, nt, sweeps=1, shards=1):
    """Launches of ``sweeps`` float64 W=1 sweeps of ``shards`` shards of
    ``nblocks`` blocks: kernel C once per block, kernel B's c-dot and
    update once per block each (there is no fused float64 pass), kernel A
    once per run of blocks under the Gram byte budget (8-byte entries)."""
    from gmrm_tpu_torch.ops.block_gram import gram_run_blocks
    runs = -(-nblocks // gram_run_blocks(T, B, nt, nblocks, 8))
    per_sweep = {"block_gram_f64": runs, "block_cdot_f64": nblocks,
                 "eps_update_f64": nblocks, "serial_scan_f64": nblocks}
    return {k: v * sweeps * shards for k, v in per_sweep.items()}


def composed_counts(nblocks, sweeps=1):
    """Launches of ``sweeps`` composed W>1 sweeps on one device: per sweep
    kernel 2 for the first block, kernel 3 per block, the fused update and
    next c-dot for every block but the last and kernel 4 for the last."""
    return {"block_cdot": sweeps, "wave_scan": nblocks * sweeps,
            "update_cdot": (nblocks - 1) * sweeps, "eps_update": sweeps}


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


PASSES = ("block_cdot", "eps_update", "update_cdot")


def mask_name(na):
    return "NT=1" if bool((na == na[:1]).all()) else f"NT={na.shape[0]}"


def bit_equal_twice(name, fn):
    """``fn`` twice on the same inputs; each returns a tuple of tensors
    that must be equal bit for bit.  Returns the first run's."""
    import torch
    first, second = fn(), fn()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(first, second)):
        fail(f"{name}: two launches on the same inputs wrote different bits")
    return first


def passes_one_block(bk, bed, rows, rows2, eps, mave, msig, mave2, msig2, d,
                     na, errs, tag=""):
    """Phase 2: kernels 2 and 4 and the fused pass through the one-block
    wrappers against their plain versions (rtol 1e-5, atol 1e-5 of
    max|want|: the kernels sum in another order), each launched twice on
    the same inputs, bit-equal.  The update and the fused pass start from a
    zero residual (the compared values are the update itself) and the fused
    pass also from ``eps``.  Returns the largest errors so far."""
    import torch
    errs = dict(errs)
    where = f"{mask_name(na)}{tag}, one block"
    got = bit_equal_twice(f"block_cdot ({where})", lambda: (
        bk.block_cdot(bed, rows, eps, mave, msig),))[0]
    want = bk.block_cdot_plain(bed, rows, eps, mave, msig)
    errs["block_cdot"] = max(errs["block_cdot"], close(
        f"block_cdot ({where})", got, want, 1e-5, 1e-5))
    got = bit_equal_twice(f"eps_update ({where})", lambda: (
        bk.block_eps_update_(bed, rows, d, mave, na,
                             torch.zeros_like(eps)),))[0]
    want = bk.block_eps_update_plain_(bed, rows, d, mave, na,
                                      torch.zeros_like(eps))
    errs["eps_update"] = max(errs["eps_update"], close(
        f"eps_update ({where})", got, want, 1e-5, 1e-5))
    if not got.abs().sum() > 0:
        fail(f"eps_update ({where}) is zero")
    for start, what in ((torch.zeros_like(eps), "zero"), (eps, "random")):
        def run(fn):
            e = start.clone()
            return e, fn(bed, rows, d, mave, na, e, rows2, mave2, msig2)
        got = bit_equal_twice(f"update_cdot ({where})",
                              lambda: run(bk.block_update_cdot_))
        want = run(bk.block_update_cdot_plain_)
        for part, g, w in zip(("eps", "c"), got, want):
            errs["update_cdot"] = max(errs["update_cdot"], close(
                f"update_cdot ({where}, {what} residual) {part}", g, w,
                1e-5, 1e-5))
    return errs


def passes_sweep_arrays(bk, passes, bed, rows_all, mave_p, msig_p, na, eps,
                        d_all, errs):
    """Phase 2: kernels 2 and 4 and the fused pass through ``BlockPasses``
    (the sweep's whole arrays and a block index) at a middle block and the
    last one, against the plain versions on those blocks' slices; the fused
    pass updates with the block before and dots the block.  Each launched
    twice, bit-equal.  Returns the largest errors so far."""
    import torch
    errs = dict(errs)
    eps = eps * na
    nb = rows_all.shape[0]
    for b in (nb // 2, nb - 1):
        where = f"{mask_name(na)}, block {b} of the sweep's arrays"

        def cdot():
            passes.cdot(b, eps)
            return (passes.c[b].clone(),)
        got = bit_equal_twice(f"block_cdot ({where})", cdot)[0]
        want = bk.block_cdot_plain(bed, rows_all[b], eps, mave_p[b],
                                   msig_p[b])
        errs["block_cdot"] = max(errs["block_cdot"], close(
            f"block_cdot ({where})", got, want, 1e-5, 1e-5))

        def update():
            e = torch.zeros_like(eps)
            passes.update_(b, d_all, e)
            return (e,)
        got = bit_equal_twice(f"eps_update ({where})", update)[0]
        want = bk.block_eps_update_plain_(bed, rows_all[b], d_all[b],
                                          mave_p[b], na,
                                          torch.zeros_like(eps))
        errs["eps_update"] = max(errs["eps_update"], close(
            f"eps_update ({where})", got, want, 1e-5, 1e-5))
        if not got.abs().sum() > 0:
            fail(f"eps_update ({where}) is zero")
        for start, what in ((torch.zeros_like(eps), "zero"), (eps, "random")):
            def fused():
                e = start.clone()
                passes.update_cdot_(b - 1, d_all, e)
                return e, passes.c[b].clone()
            got = bit_equal_twice(f"update_cdot ({where})", fused)
            e = start.clone()
            want = (e, bk.block_update_cdot_plain_(
                bed, rows_all[b - 1], d_all[b - 1], mave_p[b - 1], na, e,
                rows_all[b], mave_p[b], msig_p[b]))
            for part, g, w in zip(("eps", "c"), got, want):
                errs["update_cdot"] = max(errs["update_cdot"], close(
                    f"update_cdot ({where}, {what} residual) {part}", g, w,
                    1e-5, 1e-5))
    return errs


def passes_big(bk, dev, gen):
    """Phase 2: kernels 2 and 4 and the fused pass at the large-N panel's
    width (mb = 25,088) on a bed of 32 blocks with a per-trait mask:
    checked as ``passes_sweep_arrays`` does, then timed at a middle block
    by CUDA-graph replay beside their bounds."""
    import torch
    nb, mb = MT_BIG // B, N_BIG // 4 + 88        # 32 blocks, mb_pad 25,088
    bed = torch.randint(0, 256, (nb * B, mb), generator=gen, device=dev,
                        dtype=torch.uint8)
    bed[:, mb - 88:] = 0x55
    na = torch.ones((T, 4, mb), device=dev)
    na[:, :, mb - 88:] = 0
    na = na * (torch.rand((T, 4, mb), generator=gen, device=dev) > 0.03)
    rows_all = torch.randperm(nb * B, generator=gen, device=dev).to(
        torch.int32).reshape(nb, B).contiguous()
    mave_p = torch.rand((nb, T, B), generator=gen, device=dev) * 1.6 + 0.2
    msig_p = torch.rand((nb, T, B), generator=gen, device=dev) * 1.5 + 0.5
    d_all = torch.randn((nb, T, B), generator=gen, device=dev) * 0.01
    eps = torch.randn((T, 4, mb), generator=gen, device=dev) * na
    passes = bk.BlockPasses(bed, rows_all, mave_p, msig_p, na)
    res = {"errs": passes_sweep_arrays(
        bk, passes, bed, rows_all, mave_p, msig_p, na, eps, d_all,
        dict.fromkeys(PASSES, 0.0))}
    b, e1 = nb // 2, eps.clone()
    f4 = 4
    plane, tb, blk = T * 4 * mb * f4, T * B * f4, B * mb + B * f4
    ops = 4 * T * B * 4 * mb
    plan = bk.pass_plan(T, B, mb)
    for name, fn, nbytes, flops in (
            ("block_cdot", lambda: passes.cdot(b, eps), blk + plane + 3 * tb,
             ops),
            ("eps_update", lambda: passes.update_(b, d_all, e1),
             blk + 3 * plane + 2 * tb, ops),
            ("update_cdot", lambda: passes.update_cdot_(b, d_all, e1),
             2 * blk + 3 * plane + 5 * tb, 2 * ops)):
        ms = cuda_ms(fn, 100)
        bound = bound_of(nbytes, (flops, F32_OPS))
        res[name] = (f"{ms:.4f} ms (NT={T}), bound {bound[0]:.5f} ms by "
                     f"{bound[1]}, {plan.grid} CTAs x {plan.S} byte columns, "
                     f"{plan.groups} groups")
    if not torch.isfinite(e1).all():
        fail("the timed updates at mb=25,088 left a non-finite residual")
    return res


def passes_stamp_split(bk, passes, b, eps, d_all):
    """Where a launch of each pass goes: one launch at block ``b`` (after
    two unstamped ones) with a stamp buffer, thread 0 of every CTA
    recording the global timer at the events of ``bk.PASS_STAMPS``; each
    event's mean and latest time over the CTAs that record it, from the
    first CTA's start, in microseconds."""
    import torch
    runs = {"block_cdot": lambda st: passes.cdot(b, eps, st),
            "eps_update": lambda st: passes.update_(b, d_all, eps.clone(), st),
            "update_cdot": lambda st: passes.update_cdot_(b, d_all,
                                                          eps.clone(), st)}
    split = {}
    for name, run in runs.items():
        stamps = torch.zeros((passes.plan.grid, bk.NST), dtype=torch.int64,
                             device=eps.device)
        run(None)
        run(None)
        run(stamps)
        torch.cuda.synchronize()
        s = stamps.cpu().double()
        t0 = s[:, 0].min()
        parts = []
        for e, event in enumerate(bk.PASS_STAMPS):
            col = s[:, e][s[:, e] > 0] - t0
            if col.numel():
                parts.append(f"{event} {float(col.mean()) / 1e3:.2f}/"
                             f"{float(col.max()) / 1e3:.2f}")
        split[name] = ", ".join(parts)
    return split


def scan_case(dev, gen, Tv, Bv, Kv, G=3):
    """One block's scan inputs at (T, B, K) = (Tv, Bv, Kv), as the one-block
    scan wrappers take them: an adaV group, three pad markers, a Gram of
    600 random columns.  Returns the arguments and the live mask."""
    import torch
    from gmrm_tpu_torch.ops import scan_kernel_wave as sw
    from gmrm_tpu_torch.ops import sweep_kernel as sk
    cva_v = torch.cat([torch.zeros((G, 1), device=dev), torch.logspace(
        -4, -1.3, Kv - 1, device=dev).expand(G, Kv - 1)], dim=1)
    cvai_v = torch.zeros_like(cva_v)
    cvai_v[:, 1:] = 1.0 / cva_v[:, 1:]
    sg_v = torch.rand((Tv, G), generator=gen, device=dev) * 0.4 + 0.1
    sg_v[0, 1] = 0.0
    se_v = torch.rand((Tv,), generator=gen, device=dev) * 0.4 + 0.5
    pi_v = torch.rand((Tv, G, Kv), generator=gen, device=dev) + 0.1
    tabs = sk.build_sweep_tables(
        sg_v, se_v, pi_v / pi_v.sum(-1, keepdim=True), cva_v, cvai_v,
        torch.full((Tv,), 490.0, device=dev), 500.0)
    grp_v = torch.randint(0, G, (Bv,), generator=gen, device=dev)
    live_v, zerob_v = sw.scan_masks(
        grp_v, torch.arange(Bv, device=dev) < Bv - 3, sg_v)
    xv = torch.randn((Bv, 600), generator=gen, device=dev)
    return ((torch.randn((Tv, Bv), generator=gen, device=dev) * 30.0,
             *(t[:, :, grp_v].contiguous() for t in tabs),
             (xv @ xv.T).expand(Tv, Bv, Bv).contiguous(),
             torch.randn((Tv, Bv), generator=gen, device=dev) * 0.05,
             torch.randint(0, Kv, (Tv, Bv), generator=gen, device=dev,
                           dtype=torch.int32),
             torch.rand((Tv, Bv), generator=gen, device=dev),
             torch.rand((Tv, Bv), generator=gen, device=dev),
             torch.randn((Tv, Bv), generator=gen, device=dev), live_v,
             zerob_v, (1.0 / (2.0 * se_v)).contiguous()), live_v)


def kernel_phase(dev, gen):
    """Phase 2: every kernel against its plain version on the card."""
    import torch
    from gmrm_tpu_torch.ops import block_gram as bg
    from gmrm_tpu_torch.ops import block_kernels as bk
    from gmrm_tpu_torch.ops import scan_kernel as sk6
    from gmrm_tpu_torch.ops import scan_kernel_wave as sw
    from gmrm_tpu_torch.ops import sweep_kernel as sk
    from gmrm_tpu_torch.ops.decode import decode_planes

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
    out, times, bounds, notes = {}, {}, {}, {}
    f4 = 4                                   # bytes per float32 / int32
    tb, plane = T * B * f4, T * 4 * MB * f4  # a (T, B) and a (T, 4, mb) array
    block_ops = 4 * T * B * 4 * MB           # flops of A.eps and B.eps

    def timed(name, kernel, plain, reps, plain_reps, per=1):
        """Graph-replay ms of the kernel and its plain version, and the
        kernel's eager ms per call, each over ``per`` (the blocks of a
        batched call)."""
        t = times.setdefault(name, ([], [], []))
        t[0].append(cuda_ms(kernel, reps) / per)
        t[1].append(cuda_ms(plain, plain_reps) / per)
        t[2].append(call_ms(kernel, reps) / per)

    # Kernel 1: the Gram cache, bit-equal to its plain version: the anchor
    # at NT = 1 and NT = T (timed beside the plain version), then B = 192
    # (partial 128-tiles), mb = 203 (the byte path) and the large-N
    # panel's mb_pad = 25,088 (157 blocks, 504 MB of bed), timed alone.
    # The int8 operations one block and mask needs: g1 and g3 are symmetric
    # (B (B + 1) / 2 products each), g2t is not (B B), over the individuals
    # that are not padding.
    gram_ops = 2 * (2 * (B * (B + 1) // 2) + B * B) * 4 * (MB - 60)
    cases = [("anchor", bed, na_shared, na_trait, B)]
    b192 = MT - MT % 192
    cases.append(("B=192", bed[:b192], na_shared, na_trait, 192))
    cases.append(("mb=203", bed[:, :203].contiguous(),
                  na_shared[:, :, :203].contiguous(),
                  na_trait[:, :, :203].contiguous(), B))
    bed_w = torch.randint(0, 256, (m_pad, MB_BIG), generator=gen, device=dev,
                          dtype=torch.uint8)
    bed_w[MT:] = 0x55
    na_w = torch.ones((T, 4, MB_BIG), device=dev)
    na_w[:, :, MB_BIG - 60:] = 0
    cases.append(("mb_pad=25,088", bed_w, na_w,
                  na_w * (torch.rand((T, 4, MB_BIG), generator=gen,
                                     device=dev) > 0.03), B))
    gram_notes = []
    for label, bed_c, na_s, na_t, bsz in cases:
        for shared, na in ((True, na_s), (False, na_t)):
            na_in = (na[:1] if shared else na).contiguous()
            nt = na_in.shape[0]
            got = sk.build_gram_cache(bed_c, na, block_size=bsz,
                                      shared_na=shared)
            want = sk.gram_cache_plain(bed_c, na_in, bsz)
            if not torch.equal(got, want):
                fail(f"gram_cache ({label}, NT={nt}) is not bit-equal to "
                     f"its plain version (max abs err "
                     f"{max_err(got, want)})")
            del got, want

            def kern(bed_c=bed_c, na=na, bsz=bsz, shared=shared):
                return sk.build_gram_cache(bed_c, na, block_size=bsz,
                                           shared_na=shared)
            if label == "anchor":
                timed("gram_cache", kern,
                      lambda: sk.gram_cache_plain(bed_c, na_in, bsz), 3, 3)
            else:
                gram_notes.append(f"{label} NT={nt} {cuda_ms(kern, 3):.4f}")
    del cases, kern, bed_w, na_w
    # The yardstick that leaves the decode out: torch.bmm on every block's
    # pre-decoded float32 operands (NT = 1, TF32 off), the body of
    # raw_gram_plain for all blocks at once.
    pa, pb = decode_planes(bed)
    ab = torch.cat([pa.reshape(nblocks, B, -1), pb.reshape(nblocks, B, -1)],
                   dim=1)                            # (nblocks, 2B, 4mb)
    del pa, pb
    abn = ab * na_shared[0].reshape(1, 1, -1)
    gram_mm = cuda_ms(lambda: torch.bmm(abn, ab.transpose(1, 2)), 3)
    del ab, abn
    out["gram_cache"] = 0.0
    grid = sk.gram_cache_grid(B, nblocks, 1)
    tops = gram_ops * nblocks / (times["gram_cache"][0][0] * 1e-3) / 1e12
    notes["gram_cache"] = (
        f"times in order: the anchor at NT=1, NT={T}; grid {grid} CTAs "
        f"(quadrant tiles, masks, blocks); {tops:.1f} int8 TOP/s of the "
        f"products the function needs at NT=1; other "
        f"shapes, ms by graph replay: {'; '.join(gram_notes)}; torch.bmm "
        f"on all blocks' pre-decoded float32 operands (NT=1) "
        f"{gram_mm:.4f} ms; earlier design {EARLIER_GRAM_CACHE_MS} ms "
        f"(NT=1, NT={T}) as recorded in PERF.md")
    # NT = 1, as the first timing: bed and mask in, the cache out; the
    # products that the three quadrants need.
    bounds["gram_cache"] = bound_of(
        bed.numel() + 4 * MB * f4 + nblocks * (2 * B) ** 2 * f4,
        (nblocks * gram_ops, INT8_OPS))

    # Kernels 2 and 4 and the fused pass, one block each through the
    # one-block wrappers, with the shared (NT=1) and the per-trait (NT=4)
    # mask, against their plain versions; the update and the fused pass
    # also from a zero residual, so that the compared values are the update
    # itself.  Two launches on the same inputs must write the same bits:
    # the c-dot's partials are summed in a fixed order, without float
    # atomics.  Timed below, as the W=1 sweep launches them.
    eps = torch.randn((T, 4, MB), generator=gen, device=dev) * na_trait
    mave = torch.rand((T, B), generator=gen, device=dev) * 1.6 + 0.2
    msig = torch.rand((T, B), generator=gen, device=dev) * 1.5 + 0.5
    rows = rows_of[:B].to(torch.int32).contiguous()
    rows2 = rows_of[B:2 * B].to(torch.int32).contiguous()
    mave2 = torch.rand((T, B), generator=gen, device=dev) * 1.6 + 0.2
    msig2 = torch.rand((T, B), generator=gen, device=dev) * 1.5 + 0.5
    d = (torch.randn((T, B), generator=gen, device=dev)
         * (torch.rand((T, B), generator=gen, device=dev) > 0.5)) * 0.01
    out.update(dict.fromkeys(PASSES, 0.0))
    for na in (na_shared, na_trait):
        out.update(passes_one_block(bk, bed, rows, rows2, eps * na, mave,
                                    msig, mave2, msig2, d, na, out))
    # The other branches of the launch: one group of slices (mb = 200, a
    # one-level tree) and an mb that is no multiple of 4 (byte copies).
    for mb_x in (200, 203):
        bed_x = bed[:, :mb_x].contiguous()
        na_x = na_trait[:, :, :mb_x].contiguous()
        out.update(passes_one_block(
            bk, bed_x, rows, rows2, (eps[:, :, :mb_x] * na_x).contiguous(),
            mave, msig, mave2, msig2, d, na_x, out, f" (mb={mb_x})"))
    blk_bytes = B * MB + B * f4                       # a block's bed rows
    bounds["block_cdot"] = bound_of(blk_bytes + plane + 3 * tb,
                                    (block_ops, F32_OPS))
    bounds["eps_update"] = bound_of(blk_bytes + 3 * plane + 2 * tb,
                                    (block_ops, F32_OPS))
    bounds["update_cdot"] = bound_of(2 * blk_bytes + 3 * plane + 5 * tb,
                                     (2 * block_ops, F32_OPS))

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
    scan_bytes = 3 * K * tb + 12 * tb + T * f4
    wave_err, wave_drawn = 0.0, set()

    def wave_held(name, got, want, live_b):
        nonlocal wave_err
        if not torch.equal(got[2], want[2]):
            fail(f"wave_scan ({name}): comp differs from the plain version "
                 f"in {int((got[2] != want[2]).sum())} entries")
        wave_err = max([wave_err] + [
            close(f"wave_scan {name} {part}", g, w, 1e-5, 1e-5)
            for part, g, w in zip(("dbeta", "beta", "acum"),
                                  (got[0], got[1], got[3]),
                                  (want[0], want[1], want[3]))])
        wave_drawn.update(want[2][live_b != 0].tolist())

    # Kernel 3 as the composed sweep launches it: the anchor's 157 blocks of
    # (nb, ..., B) arrays (the last with 96 pad slots) and a run of scaled
    # Grams, a middle and the last block by index, the kernel forming base
    # and d = msig * dbeta itself, launched twice (bit-equal); then the
    # one-block wrapper (base given) on the middle block's slices, which
    # must give the sweep's bits, and on one block's tensors.
    grp_n = torch.randint(0, G, (nblocks, B), generator=gen, device=dev)
    valid_n = torch.ones((nblocks, B), dtype=torch.bool, device=dev)
    valid_n[-1, B - 96:] = False
    live_n, zerob_n = (x.movedim(0, 1).contiguous()
                       for x in sw.scan_masks(grp_n, valid_n, sigmag))

    def blocks_of(tab):                       # (K, T, G) -> (nb, K, T, B)
        return tab[:, :, grp_n].movedim(2, 0).contiguous()

    xg = torch.randn((nblocks, B, 600), generator=gen, device=dev)
    gs_n = torch.bmm(xg, xg.transpose(1, 2))[:, None].expand(
        nblocks, T, B, B).contiguous()
    del xg
    c_n = torch.randn((nblocks, T, B), generator=gen, device=dev) * 30.0
    nm1 = nonas - 1.0
    i2se = args[12]
    wops = (nm1, blocks_of(lc_t), blocks_of(rd_t), blocks_of(sqb_t),
            torch.randn((nblocks, T, B), generator=gen, device=dev) * 0.05,
            torch.randint(0, K, (nblocks, T, B), generator=gen, device=dev,
                          dtype=torch.int32),
            torch.rand((nblocks, T, B), generator=gen, device=dev),
            torch.rand((nblocks, T, B), generator=gen, device=dev),
            torch.randn((nblocks, T, B), generator=gen, device=dev), live_n,
            zerob_n, torch.rand((nblocks, T, B), generator=gen, device=dev)
            + 0.5, i2se)
    wsweep = sw.WaveScanSweep(*wops, wave=W)
    bm = nblocks // 2

    def plain_block(b):
        base_b = (c_n[b] + wops[4][b] * nm1[:, None]).contiguous()
        return (base_b, *(x[b] for x in wops[1:4]), gs_n[b],
                *(x[b] for x in wops[4:11]), i2se)

    for b in (bm, nblocks - 1):
        def step(b=b):
            wsweep.step(b, c_n, gs_n, b, bc=b)
            return tuple(x[b].clone() for x in (
                wsweep.dbeta, wsweep.beta_new, wsweep.comp_new,
                wsweep.acum_new, wsweep.d))
        got = bit_equal_twice(f"wave_scan (sweep arrays, block {b})", step)
        wave_held(f"sweep arrays, block {b}", got,
                  sw.wave_scan_plain(*plain_block(b), W), live_n[b])
        if not torch.equal(got[4], wops[11][b] * got[0]):
            fail("wave_scan: d is not msig * dbeta bit for bit")
        if b == bm:
            mid = got
    if not torch.equal(wsweep.beta_new[-1][:, B - 96:],
                       wops[4][-1][:, B - 96:]):
        fail("wave_scan: the last block's pad slots moved")
    one = sw.wave_scan(*plain_block(bm), wave=W)
    if not all(torch.equal(x, y) for x, y in zip(one, mid)):
        fail("wave_scan: the one-block wrapper and the sweep interface "
             "wrote different bits for the same block")
    wave_held("one block's tensors", sw.wave_scan(*args, wave=W),
              sw.wave_scan_plain(*args, W), live)
    plain_m = plain_block(bm)
    timed("wave_scan", lambda: wsweep.step(bm, c_n, gs_n, bm, bc=bm),
          lambda: sw.wave_scan_plain(*plain_m, W), 200, 20)
    timed("wave_scan", lambda: sw.wave_scan(*plain_m, wave=W),
          lambda: sw.wave_scan_plain(*plain_m, W), 200, 20)
    nw = B // W
    wstamps = torch.zeros(2 + 2 * nw, dtype=torch.int64, device=dev)
    wsweep.step(bm, c_n, gs_n, bm, bc=bm, stamps=wstamps)
    torch.cuda.synchronize()
    wsplit = ", ".join(
        f"{name} {float(t) / 1e3:.2f}" for name, t in zip(
            sw.wave_stamp_names(nw), (wstamps - wstamps[0]).cpu()))
    # The kernel's other branches against the plain version: W=8 and W=4
    # (more waves), a block whose tables and Gram rows stay in global
    # memory, one with the Gram rows of its first wave staged and the
    # others' in global memory, 4-byte copies (B and W no multiple of 4),
    # one wave (W = B), and T W above the CTA's 512 threads (no warp left
    # to fold in the background).
    for Tv, Bv, Kv, Wv, plan in ((4, 128, 4, 8, (1, 15)),
                                 (3, 64, 3, 4, (1, 15)),
                                 (8, 256, 16, 32, (0, 0)),
                                 (4, 256, 4, 32, (1, 1)),
                                 (4, 130, 4, 13, (1, 9)),
                                 (2, 64, 2, 64, (1, 0)),
                                 (8, 256, 4, 128, (1, 0))):
        if sw.wave_plan(Tv, Bv, Kv, Wv) != plan:
            fail(f"wave_scan: plan {sw.wave_plan(Tv, Bv, Kv, Wv)} at T={Tv},"
                 f" B={Bv}, K={Kv}, W={Wv}")
        vargs, live_v = scan_case(dev, gen, Tv, Bv, Kv)
        wave_held(f"T={Tv}, B={Bv}, K={Kv}, W={Wv}",
                  sw.wave_scan(*vargs, wave=Wv),
                  sw.wave_scan_plain(*vargs, Wv), live_v)
    if len(wave_drawn) < 2:
        fail("wave_scan parity cases drew a single component")
    out["wave_scan"] = wave_err
    notes["wave_scan"] = (
        "times in order: the sweep's arrays (a middle block), the one-block "
        f"wrapper on its slices; plan (tables staged, waves of Gram rows "
        f"staged) {sw.wave_plan(T, B, K, W)}; stamps of one launch, us "
        f"from its start: {wsplit}; earlier design {EARLIER_WAVE_SCAN_MS} "
        f"ms per block as recorded in PERF.md; no PyTorch call computes a "
        f"scan")
    # Bytes: the block's operands and outputs once and the Gram rows that
    # a fold reads, of the waves that moved a marker; operations: those
    # folds and the draws.
    moved = [w for w in range(nw - 1)
             if (mid[0][:, w * W:(w + 1) * W] != 0).any()]
    fold_floats = sum(T * W * (B - (w + 1) * W) for w in moved)
    bounds["wave_scan"] = bound_of(
        3 * K * tb + 14 * tb + 2 * T * f4 + fold_floats * f4,
        (2 * fold_floats + T * B * K * 12, F32_OPS))

    # Kernel 5: the scaled Grams of a run of blocks from one launch, gs
    # bit-equal: all 157 blocks at NT=1 (pad rows last, so the last block
    # has pad slots), a run under the byte budget at NT=4; then one block
    # with its c (the public counterpart, nb = 1).
    order = torch.cat([torch.randperm(MT, generator=gen, device=dev),
                       torch.arange(MT, m_pad, device=dev)])
    rows_all = order.to(torch.int32).reshape(nblocks, B).contiguous()
    real = (order < MT).reshape(nblocks, 1, B)
    mave_p = (torch.rand((nblocks, T, B), generator=gen, device=dev) * 1.6
              + 0.2) * real
    msig_p = (torch.rand((nblocks, T, B), generator=gen, device=dev) * 1.5
              + 0.5) * real
    err, extra = 0.0, {}
    for na_in in (na_shared[:1].contiguous(), na_trait):
        nt = na_in.shape[0]
        nb = bg.gram_run_blocks(T, B, nt, nblocks)
        if nb != (nblocks if nt == 1 else 128):
            fail(f"block_gram: a run of {nb} blocks at NT={nt}")
        run = (rows_all[-nb:], na_in, mave_p[-nb:].contiguous(),
               msig_p[-nb:].contiguous())
        got = bg.blocks_gram_scaled(bed, *run)
        want = bg.blocks_gram_scaled_plain(bed, *run)
        if not torch.equal(got, want):
            fail(f"block_gram (NT={nt}, {nb} blocks): gs is not bit-equal "
                 f"to its plain version (max abs err {max_err(got, want)})")
        if not (got[-1].abs().sum() > 0 and (got[-1][:, -1] == 0).all()):
            fail(f"block_gram (NT={nt}): the last block's pad slots")
        del got, want
        timed("block_gram", lambda: bg.blocks_gram_scaled(bed, *run),
              lambda: bg.blocks_gram_scaled_plain(bed, *run), 5, 1, per=nb)
        ms = times["block_gram"][0][-1]
        extra[f"NT={nt}"] = (
            f"{nb} blocks per launch, {ms * nb:.4f} ms per launch, "
            f"{gram_ops * nt / (ms * 1e-3) / 1e12:.1f} int8 TOP/s of the "
            f"products the function needs")
    for na_in in (na_shared[:1].contiguous(), na_trait):
        got = bg.block_gram_scaled(bed, rows, eps, na_in, mave, msig)
        want = bg.block_gram_scaled_plain(bed, rows, eps, na_in, mave, msig)
        if not torch.equal(got[1], want[1]):
            fail(f"block_gram (NT={na_in.shape[0]}, one block): gs is not "
                 f"bit-equal to its plain version (max abs err "
                 f"{max_err(got[1], want[1])})")
        err = max(err, close("block_gram c", got[0], want[0], 1e-5, 1e-5))
        timed("block_gram", lambda: bg.block_gram_scaled(
            bed, rows, eps, na_in, mave, msig),
            lambda: bg.block_gram_scaled_plain(
                bed, rows, eps, na_in, mave, msig), 100, 20)
    # The yardstick that leaves the decode out: torch.matmul on one block's
    # pre-decoded float32 operands, the body of raw_gram_plain.
    pa, pb = decode_planes(bed[rows.long()])
    ab = torch.cat([pa, pb], dim=0).reshape(2 * B, -1)
    abn = ab * na_shared[0].reshape(1, -1)
    extra["matmul"] = (f"torch.matmul (2B x 4mb) @ (4mb x 2B) on pre-decoded "
                       f"float32 operands {cuda_ms(lambda: abn @ ab.T, 50):.4f}"
                       f" ms per block")
    del pa, pb, ab, abn
    out["block_gram"] = err
    notes["block_gram"] = (
        "times in order: per block of the NT=1 run, per block of the NT=4 "
        "run, one block with its c-dot at NT=1, at NT=4; "
        + "; ".join(f"{k}: {v}" for k, v in extra.items()))
    # Per block of the NT=1 run: its bed rows and statistics in, gs out.
    bounds["block_gram"] = bound_of(
        B * MB + 4 * MB * f4 / nblocks + 2 * tb + B * f4 + T * B * B * f4,
        (gram_ops, INT8_OPS), (9 * T * B * B, F32_OPS))

    # Kernels 2 and 4 and the fused pass as the W=1 sweep launches them:
    # the anchor's whole (157, T, B) arrays and a block index, for a middle
    # block and the last one (pad slots; the fused pass dots it from the
    # block before), against the plain versions on those blocks' slices,
    # and two launches bit-equal.  Then timed this way, NT=1 first.
    d_all = (torch.randn((nblocks, T, B), generator=gen, device=dev) * 0.01
             * real).contiguous()
    for na in (na_shared, na_trait):
        passes = bk.BlockPasses(bed, rows_all, mave_p, msig_p, na)
        out.update(passes_sweep_arrays(bk, passes, bed, rows_all, mave_p,
                                       msig_p, na, eps, d_all, out))
    bm = nblocks // 2
    for na in (na_shared, na_trait):
        passes = bk.BlockPasses(bed, rows_all, mave_p, msig_p, na)
        eps_n, e1 = eps * na, eps * na
        plain_args = (bed, rows_all[bm], d_all[bm], mave_p[bm], na)
        timed("block_cdot", lambda: passes.cdot(bm, eps_n),
              lambda: bk.block_cdot_plain(bed, rows_all[bm], eps_n,
                                          mave_p[bm], msig_p[bm]), 200, 200)
        timed("eps_update", lambda: passes.update_(bm, d_all, e1),
              lambda: bk.block_eps_update_plain_(*plain_args, e1), 200, 200)
        timed("update_cdot", lambda: passes.update_cdot_(bm, d_all, e1),
              lambda: bk.block_update_cdot_plain_(
                  *plain_args, e1, rows_all[bm + 1], mave_p[bm + 1],
                  msig_p[bm + 1]), 200, 200)
        if not torch.isfinite(e1).all():
            fail("the timed updates left a non-finite residual")
    # Where a launch's time goes, by the kernels' own stamps (NT=1).
    split = passes_stamp_split(
        bk, bk.BlockPasses(bed, rows_all, mave_p, msig_p, na_shared), bm,
        eps * na_shared, d_all)
    # The yardsticks that leave the decode out: torch.matmul on one block's
    # pre-decoded float32 operands, (T, 4mb) @ (4mb, 2B) for the c-dot and
    # (T, 2B) @ (2B, 4mb) for the update.
    pa, pb = decode_planes(bed[rows_all[bm].long()])
    ab = torch.cat([pa, pb], dim=0).reshape(2 * B, -1)
    e2 = eps.reshape(T, -1)
    dd = torch.cat([d_all[bm], -mave_p[bm] * d_all[bm]], dim=1)
    matmul = {"block_cdot": cuda_ms(lambda: e2 @ ab.T, 50),
              "eps_update": cuda_ms(lambda: dd @ ab, 50)}
    del pa, pb, ab
    # Once more at the large-N panel's width (mb = 25,088: 392 slices of 64
    # bytes, 25 groups), a bed of 32 blocks, checked and timed at NT=4.
    big = passes_big(bk, dev, gen)
    plan = bk.pass_plan(T, B, MB)
    for k in PASSES:
        notes[k] = (
            "times in order: the sweep's arrays at NT=1, NT=4 (a middle "
            f"block); launch: {plan.grid} CTAs x {plan.S} byte columns, "
            f"{plan.smem} bytes of shared memory (fused pass), {plan.groups} "
            f"groups in the c-dot's tree; stamps at NT=1, event mean/latest "
            f"us from the first CTA's start: {split[k]}; at mb=25,088: "
            f"{big[k]}"
            + (f"; torch.matmul on the block's pre-decoded float32 operands "
               f"{matmul[k]:.4f} ms" if k in matmul else ""))
    for k, v in big["errs"].items():
        out[k] = max(out[k], v)

    # Kernel 6: the serial scan.  First the sweep's interface: whole
    # (nb, ..., B) arrays and a block index (three blocks, an adaV group,
    # the last block with 96 pad slots), the kernel forming base and
    # d = msig * dbeta itself; then one block's tensors (the inputs of
    # kernel 3).  Both with |base| of order 30 and of order 1e3, where the
    # 700 guards fire.
    nb_s = 3
    grp_s = torch.randint(0, G, (nb_s, B), generator=gen, device=dev)
    valid_s = torch.ones((nb_s, B), dtype=torch.bool, device=dev)
    valid_s[-1, B - 96:] = False
    masks = [sw.scan_masks(grp_s[n], valid_s[n], sigmag) for n in range(nb_s)]
    live_s = torch.stack([m[0] for m in masks])
    zerob_s = torch.stack([m[1] for m in masks])

    def per_block(tab):                       # (K, T, G) -> (nb, K, T, B)
        return tab[:, :, grp_s].movedim(2, 0).contiguous()

    xs = torch.randn((nb_s, B, 600), generator=gen, device=dev)
    gs_s = (xs @ xs.transpose(1, 2))[:, None].expand(
        nb_s, T, B, B).contiguous()
    c_s = torch.randn((nb_s, T, B), generator=gen, device=dev) * 30.0
    beta_s = torch.randn((nb_s, T, B), generator=gen, device=dev) * 0.05
    msig_s = torch.rand((nb_s, T, B), generator=gen, device=dev) + 0.5
    nm1 = nonas - 1.0
    i2se = args[12]
    sweep = sk6.SerialScanSweep(
        nm1, per_block(lc_t), per_block(rd_t), per_block(sqb_t), beta_s,
        torch.randint(0, K, (nb_s, T, B), generator=gen, device=dev,
                      dtype=torch.int32),
        torch.rand((nb_s, T, B), generator=gen, device=dev),
        torch.rand((nb_s, T, B), generator=gen, device=dev),
        torch.randn((nb_s, T, B), generator=gen, device=dev), live_s,
        zerob_s, msig_s, i2se)
    err, drawn = 0.0, set()

    def held(name, got, want):
        nonlocal err, drawn
        if not torch.equal(got[2], want[2]):
            fail(f"serial_scan ({name}): comp differs from the plain "
                 f"version in {int((got[2] != want[2]).sum())} entries")
        err = max([err] + [close(f"serial_scan {name} {part}", g, w, 1e-5,
                                 1e-5)
                           for part, g, w in zip(
                               ("dbeta", "beta", "acum"),
                               (got[0], got[1], got[3]),
                               (want[0], want[1], want[3]))])

    for scale in (1.0, 40.0):
        for n in range(nb_s):
            c_n = (c_s[n] * scale).contiguous()
            sweep.step(n, c_n[None], gs_s, n)
            torch.cuda.synchronize()
            lc_n, rd_n, sqb_n = (x[n] for x in sweep.tables)
            want = sk6.serial_scan_plain(
                c_n + beta_s[n] * nm1[:, None], lc_n, rd_n, sqb_n, gs_s[n],
                *(x[n] for x in sweep.state), i2se)
            held(f"sweep arrays, block {n}, c x{scale}",
                 (sweep.dbeta[n], sweep.beta_new[n], sweep.comp_new[n],
                  sweep.acum_new[n]), want)
            if not torch.equal(sweep.d[n], msig_s[n] * sweep.dbeta[n]):
                fail("serial_scan: d is not msig * dbeta bit for bit")
            drawn |= set(want[2][live_s[n] != 0].tolist())
        if not torch.equal(sweep.beta_new[-1][:, B - 96:],
                           beta_s[-1][:, B - 96:]):
            fail("serial_scan: the last block's pad slots moved")
        c_1 = (c_s[1] * scale).contiguous()
        base_1 = c_1 + beta_s[1] * nm1[:, None]
        plain_1 = (base_1, *(x[1] for x in sweep.tables), gs_s[1],
                   *(x[1] for x in sweep.state), i2se)
        c_1n = c_1[None]
        timed("serial_scan", lambda: sweep.step(1, c_1n, gs_s, 1),
              lambda: sk6.serial_scan_plain(*plain_1), 200, 3)
    for scale in (1.0, 40.0):
        sargs = (args[0] * scale,) + args[1:]
        got = sk6.serial_scan(*sargs)
        want = sk6.serial_scan_plain(*sargs)
        held(f"one block, base x{scale}", got, want)
        drawn |= set(want[2][live != 0].tolist())
        timed("serial_scan", lambda: sk6.serial_scan(*sargs),
              lambda: sk6.serial_scan_plain(*sargs), 200, 3)
    if len(drawn) < 2:
        fail("serial_scan parity cases drew a single component")
    # The kernel's other branches, each against the plain version: more
    # traits than one pass over the lanes holds, 8 and 16 lanes a trait,
    # K below the lane count, tables or state left in global memory (plan
    # modes 1 and 0), and a B that rules out the bulk copies.
    for Tv, Bv, Kv, mode in ((8, 128, 8, 2), (8, 128, 16, 1), (8, 256, 8, 0),
                             (3, 30, 3, 2), (2, 64, 2, 2)):
        if sk6.scan_plan(Tv, Bv, Kv)[0] != mode:
            fail(f"serial_scan: plan {sk6.scan_plan(Tv, Bv, Kv)} at "
                 f"T={Tv}, B={Bv}, K={Kv}")
        vargs, _ = scan_case(dev, gen, Tv, Bv, Kv)
        held(f"T={Tv}, B={Bv}, K={Kv}", sk6.serial_scan(*vargs),
             sk6.serial_scan_plain(*vargs))
    out["serial_scan"] = err
    clk = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    notes["serial_scan"] = (
        "times in order: the sweep's arrays with |base| ~30 and ~1e3, one "
        "block's tensors likewise; shared memory plan (mode, rows per "
        f"group, groups) {sk6.scan_plan(T, B, K)}; "
        f"{times['serial_scan'][0][0] * 1e-3 * clk * 1e6 / B:.0f} cycles per "
        f"step at the SM clock of {clk:.0f} MHz read after the run")
    # Of the Gram only the entries i > j are read, and updated with.
    bounds["serial_scan"] = bound_of(
        scan_bytes + 2 * tb + T * B * (B - 1) // 2 * f4,
        (T * B * (B - 1) + T * B * K * K * 4, F32_OPS))
    return {name: (err, *times[name], bounds[name], notes.get(name, ""))
            for name, err in out.items()}


def sweep_operands(dev, gen, shared, mb=MB, mt=MT):
    """One sweep's operands at the anchor's shapes (or ``mb`` byte columns
    and ``mt`` markers): 157 blocks of B=128 (the last with 96 pad slots),
    G=3 groups, one of them adaV for trait 0, a standardized residual and
    the statistics of a random bed whose last 60 byte columns are pad."""
    import torch
    from gmrm_tpu_torch.ops import sweep_kernel as sk
    from gmrm_tpu_torch.ops.blockops import marker_stats
    from gmrm_tpu_torch.sampler.state import StaticInputs

    nblocks = -(-mt // B)
    m_pad = nblocks * B
    G = 3
    bed = torch.randint(0, 256, (m_pad, mb), generator=gen, device=dev,
                        dtype=torch.uint8)
    bed[mt:] = 0x55
    bed[:, mb - 60:] = 0x55
    na = torch.ones((T, 4, mb), device=dev)
    na[:, :, mb - 60:] = 0
    if not shared:
        na = na * (torch.rand((T, 4, mb), generator=gen, device=dev) > 0.03)
    nonas = na.sum(dim=(1, 2))
    mave, msig = marker_stats(bed, na, nonas)
    valid = (torch.arange(m_pad, device=dev) < mt)[None]
    mave = torch.where(valid, mave, 0.0).contiguous()
    msig = torch.where(valid, msig, 0.0).contiguous()
    eps = torch.randn((T, 4, mb), generator=gen, device=dev) * na
    eps = (eps * torch.sqrt((nonas - 1) / (eps * eps).sum(dim=(1, 2)))
           [:, None, None]).contiguous()
    cva = torch.tensor([[0.0, 1e-4, 1e-3, 1e-2]] * G, device=dev)
    cvai = torch.zeros_like(cva)
    cvai[:, 1:] = 1.0 / cva[:, 1:]
    group_of = torch.randint(0, G, (m_pad,), generator=gen, device=dev)
    static = StaticInputs(
        bed=bed, na=na.contiguous(), mave=mave, msig=msig, group_of=group_of,
        mtotgrp=torch.bincount(group_of[:mt], minlength=G), nonas=nonas,
        cva=cva, cvai=cvai, n_total=float(4 * mb - 240), m_local=mt,
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


def stamp_split(sk, run, nblocks):
    """Where a sweep's time goes: one launch with a stamp buffer, each CTA
    recording the global timer at the events of ``sk.SWEEP_STAMPS``; the
    mean microseconds between consecutive events over the inner blocks,
    for CTA 0 and averaged over the column CTAs."""
    import torch
    grid = sk.sweep_plan(T, B, MB, 1, K, W)["grid"]
    stamps = torch.zeros((grid, nblocks + 1, sk.NST), dtype=torch.int64,
                         device="cuda")
    run(stamps)
    torch.cuda.synchronize()
    full = stamps.cpu().double()
    s = full[:, 2:nblocks, :]                     # blocks 1 .. nblocks - 2
    period = float((s[0, 1:, 0] - s[0, :-1, 0]).mean()) / 1e3
    parts = [f"{period:.2f} us per block"]
    for role, rows in (("CTA 0", s[:1]), ("column CTAs", s[1:])):
        names = sk.SWEEP_STAMPS["scan" if role == "CTA 0" else "column"]
        d = (rows[:, :, 1:len(names) + 1] - rows[:, :, :len(names)])
        parts.append(f"{role}: " + ", ".join(
            f"{n} {float(x) / 1e3:.2f}"
            for n, x in zip(names, d.mean(dim=(0, 1)))))
    if hasattr(sk, "SWEEP_CHAIN"):
        # The critical chain: each checkpoint's time over blocks 1 ..
        # nblocks - 3, a column event at the last column CTA to reach it.
        def at(role, off, e):
            rows = full[0:1] if role == "scan" else full[1:]
            return rows[:, 2 + off:nblocks - 1 + off, e].max(dim=0).values
        times = [at(r, o, e) for r, o, e, _ in sk.SWEEP_CHAIN]
        parts.append("chain: " + ", ".join(
            f"{what} +{float((b - a).mean()) / 1e3:.2f}"
            for a, b, (_, _, _, what) in zip(times, times[1:],
                                              sk.SWEEP_CHAIN[1:])))
    return "; ".join(parts) + " (us)"


def sweep_kernel_phase(dev, gen, full=True):
    """Phase 2, the whole-sweep kernel: one sweep at the anchor's shapes
    against its plain version on the card, NT = 1 and NT = T, timed, its
    time split by the kernel's own stamps and, with ``full``, timed beside
    the plain version and the composed chain of kernels 2, 3, 4."""
    import torch
    from gmrm_tpu_torch.ops import sweep_kernel as sk
    from gmrm_tpu_torch.sampler.gibbs import _natural_cass, marker_sweep

    i32 = torch.int32
    err, ms, plain_ms, composed_ms, bound = 0.0, [], [], [], None
    splits = []
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

        def run(fn, eps, **kw):
            return fn(*ops[:5], eps, *ops[6:], wave=W, **kw)

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
        if hasattr(sk, "SWEEP_STAMPS"):
            splits.append(f"NT={nt}: " + stamp_split(
                sk, lambda stamps: run(sk.sweep_blocks, eps_t, stamps=stamps),
                nblocks))
        if not full:
            continue
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
    return (err, ms, plain_ms, composed_ms, bound), plan, splits


def shard_operands(dev, gen, static, st, n_shards):
    """``n_shards`` shards of kernel 9 over the operands of
    ``sweep_operands`` (one bed, Gram cache and set of statistics, which
    the shards share): each shard its own block order (step 0 of shard 0
    is the last block, with its 96 pad slots), row order, draws and marker
    state, and its own real marker count; at step 0 the fourth shard sweeps
    a block of pad slots only."""
    import collections
    import torch
    from gmrm_tpu_torch.ops import sweep_kernel as sk
    # A tree of the earlier design has no ShardOperands: the same fields.
    ops = getattr(sk, "ShardOperands", None) or collections.namedtuple(
        "ShardOperands", "blk win m_local bed gram mave msig beta comp acum "
        "grp u z")
    nblocks = static.bed.shape[0] // B
    m_pad = nblocks * B
    i32 = torch.int32
    mt = static.m_local
    m_locals = (mt, mt - mt // 20, mt - mt // 4, nblocks // 2 * B)
    shards = []
    for q in range(n_shards):
        blk = torch.randperm(nblocks, generator=gen, device=dev)
        first = {0: nblocks - 1, 3: nblocks - 2}.get(q)
        if first is not None:
            blk = torch.cat([blk.new_tensor([first]), blk[blk != first]])
        comp = torch.randint(0, K, (T, m_pad), generator=gen, device=dev,
                             dtype=i32)
        valid = (torch.arange(m_pad, device=dev) < m_locals[q])[None]
        shards.append(ops(
            blk.to(i32), torch.argsort(torch.rand(
                (nblocks, B), generator=gen, device=dev), dim=1).to(i32),
            m_locals[q], static.bed, static.gram_cache, static.mave,
            static.msig,
            (torch.randn((T, m_pad), generator=gen, device=dev) * 0.01
             * (comp > 0) * valid).contiguous(), comp,
            torch.rand((T, m_pad), generator=gen, device=dev),
            static.group_of.to(i32),
            torch.rand((nblocks, T, B), generator=gen, device=dev),
            torch.randn((nblocks, T, B), generator=gen, device=dev)))
    return shards


def copied(shards):
    """The shards with fresh copies of their marker state."""
    return [s._replace(beta=s.beta.clone(), comp=s.comp.clone(),
                       acum=s.acum.clone()) for s in shards]


def block_step_stamps(sk, sweep, b, grid, n_shards):
    """Where one launch's time goes: each CTA records the global timer at
    the events of ``sk.BLOCK_STEP_STAMPS``; mean microseconds between
    consecutive events over the scan CTAs and over the column CTAs, and
    the launch's span from the first CTA's start to the last CTA's end."""
    import torch
    stamps = torch.zeros((grid, sk.BS_NST), dtype=torch.int64, device="cuda")
    total = torch.empty_like(sweep.eps)
    sweep.step(b, out=total, stamps=stamps)
    torch.cuda.synchronize()
    s = stamps[:grid].cpu().double()
    parts = [f"span {float(s[:, -1].max() - s[:, 0].min()) / 1e3:.2f}"]
    for role, rows in (("scan CTAs", s[:n_shards]),
                       ("column CTAs", s[n_shards:])):
        names = sk.BLOCK_STEP_STAMPS["scan" if role == "scan CTAs"
                                     else "column"]
        d = (rows[:, 1:] - rows[:, :-1]).mean(dim=0)
        parts.append(f"{role}: " + ", ".join(
            f"{n} {float(x) / 1e3:.2f}" for n, x in zip(names, d)))
    t0 = float(s[:, 0].min())
    parts.append(
        "from the first CTA's start: groups' sums seen "
        f"{(float(s[:n_shards, 2].max()) - t0) / 1e3:.2f}, last wave "
        f"published {(float(s[:n_shards, 5].max()) - t0) / 1e3:.2f}, sum "
        f"written {(float(s[n_shards:, 5].max()) - t0) / 1e3:.2f}")
    return "; ".join(parts) + " (us)"


def block_sweep_phase(dev, gen, mb=MB, mt=MT, masks=(True, False)):
    """Phase 2, kernel 9: one block step of S_loc = 1, 2 and 4 shards of
    ``sweep_operands``'s operands at ``mb`` byte columns (an adaV group;
    the last block's 96 pad slots; a block of pad slots only; shards of
    different real marker counts), at the NA masks of ``masks`` (True:
    NT = 1), against its plain version on the card: comp exact, beta and
    the delta within 1e-4, acum within rtol 1e-5 and 1e-5 of its largest
    value, every element of the out-mode sum written, more than one
    component drawn; two launches bit-equal, out mode plus the add
    bit-equal to the in-place mode, launches of one shard each bit-equal to
    one launch, and the one-shard wrapper ``block_sweep`` equal to the
    one-shard launch, from the shard's whole arrays and from copies of the
    block's own slices.  Timed per launch by CUDA-graph replay, per eager
    step, by the host's clock per step, beside the plain version and a
    torch.matmul yardstick; one stamped launch per S_loc where the step is
    one launch."""
    import torch
    from gmrm_tpu_torch.ops import sweep_kernel as sk
    from gmrm_tpu_torch.ops.decode import decode_planes

    err, res, moved = 0.0, {}, {}
    for shared in masks:
        static, st, _, _, _ = sweep_operands(dev, gen, shared, mb, mt)
        nt = static.gram_cache.shape[1]
        nblocks = static.bed.shape[0] // B
        tables = sk.build_sweep_tables(st["sigmag"], st["sigmae"], st["pi"],
                                       static.cva, static.cvai, static.nonas,
                                       static.n_total)
        common = (static.na[:nt].contiguous(), st["sigmag"], *tables,
                  (1.0 / (2.0 * st["sigmae"])).contiguous(), static.nonas)
        eps = st["eps"]
        all_shards = shard_operands(dev, gen, static, st, max(SHARDS_PHASE2))
        drawn = set()
        for n_sh in SHARDS_PHASE2:
            shards = all_shards[:n_sh]
            name = f"block_sweep (S_loc={n_sh}, NT={nt}, mb={mb})"

            def kernel(sh, out=None, e=eps, b=0):
                sweep = sk.ShardedBlockSweep().sweep(sh, e, *common, wave=W)
                got = sweep.step(b, out=out)
                sweep.finish()
                return got

            for b in (0, nblocks // 2):
                got_sh, want_sh = copied(shards), copied(shards)
                # Poison the allocator's free block of the sum's size, so
                # an element the kernel leaves unwritten shows as NaN.
                del_me = torch.full_like(eps, float("nan"))
                del del_me
                got = kernel(got_sh, torch.empty_like(eps), b=b)
                torch.cuda.synchronize()
                want = sk.block_sweep_shards_plain(
                    b, want_sh, eps, *common, wave=W,
                    out=torch.empty_like(eps))
                if not torch.isfinite(got).all():
                    fail(f"{name}, step {b}: the sum has unwritten or "
                         f"non-finite elements")
                for q, (g, w) in enumerate(zip(got_sh, want_sh)):
                    if not torch.equal(g.comp, w.comp):
                        fail(f"{name}, step {b}, shard {q}: comp differs "
                             f"from the plain version in "
                             f"{int((g.comp != w.comp).sum())} entries")
                    d_beta = max_err(g.beta, w.beta)
                    if d_beta > 1e-4:
                        fail(f"{name}, step {b}, shard {q}: max|dbeta| "
                             f"{d_beta:.3e} exceeds 1e-4")
                    close(f"{name}, step {b}, shard {q}: acum", g.acum,
                          w.acum, 1e-5, 1e-5)
                    err = max(err, d_beta)
                    if q == 3 and b == 0 and not torch.equal(g.beta,
                                                             shards[3].beta):
                        fail(f"{name}: the block of pad slots moved beta")
                    blk = int(shards[q].blk[b])
                    drawn |= set(w.comp[:, blk * B:(blk + 1) * B]
                                 .reshape(-1).tolist())
                if b == nblocks // 2:
                    # The waves that moved a marker in this step: their
                    # folds are work the data asks for.
                    moved[n_sh] = sum(
                        int((g.beta[:, s.win[b].long() + int(s.blk[b]) * B]
                             != s.beta[:, s.win[b].long() + int(s.blk[b]) * B])
                            .reshape(T, B // W, W).any(dim=2).any(dim=0)[:-1]
                            .sum()) for g, s in zip(got_sh, shards))
                d_eps = max_err(got, want)
                if d_eps > 1e-4:
                    fail(f"{name}, step {b}: max|dsum| {d_eps:.3e} exceeds "
                         f"1e-4")
                if got[:, :, mb - 60:].abs().max() != 0:
                    fail(f"{name}, step {b}: pad columns of the sum are "
                         f"not 0")
                err = max(err, d_eps)
            # Two launches on the same inputs; out mode + add against the
            # in-place mode; one shard a launch against one launch.
            outs = bit_equal_twice(name, lambda: (
                kernel(copied(shards), torch.empty_like(eps)),))
            e_in = kernel(copied(shards), None, eps.clone())
            if not torch.equal(e_in, eps + outs[0]):
                fail(f"{name}: the in-place mode and out mode + add differ")
            if n_sh > 1:
                cap = sk.MAX_SHARDS
                sk.MAX_SHARDS = 1
                try:
                    split = kernel(copied(shards), torch.empty_like(eps))
                finally:
                    sk.MAX_SHARDS = cap
                if not torch.equal(split, outs[0]):
                    fail(f"{name}: launches of one shard each differ from "
                         f"one launch")
            if n_sh == 1:
                s0, s1 = copied(shards)[0], copied(shards)[0]
                one = sk.block_sweep(
                    s0.blk[:1], s0.m_local, s0.bed, s0.win[0], s0.gram, eps,
                    static.na, s0.mave, s0.msig, s0.beta, s0.comp, s0.acum,
                    s0.grp, s0.u[0], s0.z[0], *common[1:], wave=W)
                if not torch.equal(one[0], outs[0]):
                    fail(f"{name}: block_sweep differs from the launch")
                # The same block from copies of its own slices (nb = 1).
                blk = int(s1.blk[0])
                rows = slice(blk * B, (blk + 1) * B)
                sl = sk.block_sweep(
                    blk, s1.m_local, s1.bed[rows].contiguous(), s1.win[0],
                    s1.gram[blk:blk + 1].contiguous(), eps, static.na,
                    s1.mave[:, rows].contiguous(),
                    s1.msig[:, rows].contiguous(),
                    s1.beta[:, rows].contiguous(),
                    s1.comp[:, rows].contiguous(),
                    s1.acum[:, rows].contiguous(), s1.grp[rows].contiguous(),
                    s1.u[0], s1.z[0], *common[1:], wave=W)
                if not (torch.equal(sl[0], one[0])
                        and all(torch.equal(x, y[:, rows])
                                for x, y in zip(sl[1:], one[1:]))):
                    fail(f"{name}: the block's slices and the whole arrays "
                         f"give different results")

            # Timing at a middle step, from the same state each time (the
            # timed launches rewrite their blocks' state in place).
            b = nblocks // 2
            sh = copied(shards)
            total = torch.empty_like(eps)
            sweep = sk.ShardedBlockSweep().sweep(sh, eps, *common, wave=W)
            plan = sk.block_sweep_plan(T, B, mb, nt, K, W, n_sh)
            graph_ms = cuda_ms(lambda: sweep.step(b, out=total), 200)
            eager_ms = call_ms(lambda: sweep.step(b, out=total), 500)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                sweep.step(b, out=total)
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            split = (block_step_stamps(sk, sweep, b, plan["grid"], n_sh)
                     if plan["cap"] >= n_sh else "not taken: the step is "
                     f"{-(-n_sh // plan['cap'])} launches")
            sweep.finish()
            # The plain version's device time by graph replay: its real
            # marker counts as tensors on the card, so that nothing is
            # copied from the host inside the graph.
            p_sh = [s._replace(m_local=torch.tensor(
                [s.m_local], dtype=torch.int32, device=dev))
                for s in copied(shards)]
            p_out = torch.empty_like(eps)
            plain_ms = cuda_ms(lambda: sk.block_sweep_shards_plain(
                b, p_sh, eps, *common, wave=W, out=p_out), 5)
            # Bound: per shard the bytes moved once (its bed rows, raw
            # Gram, eps and the sum, na, marker state) and the operations
            # (A.eps, B.eps, the update, the Gram entries a later wave
            # reads, the draws, the fold of each wave that moved).
            nbytes, flops = 0, 0
            f4 = 4
            for _ in shards:
                nbytes += (B * mb + nt * (2 * B) ** 2 * f4
                           + nt * 4 * mb * f4 + 11 * T * B * f4 + 2 * B * f4)
                flops += (2 * 4 * T * B * 4 * mb
                          + 9 * T * (B * B - B * W) // 2 + T * B * K * 12)
            nbytes += 2 * T * 4 * mb * f4
            flops += moved[n_sh] * 2 * T * W * B
            bound = bound_of(nbytes, (flops, F32_OPS))
            # The yardstick that leaves the decode out: per shard,
            # torch.matmul of the c-dot (T, 4mb) @ (4mb, 2B) and the delta
            # (T, 2B) @ (2B, 4mb) on one block's pre-decoded operands.
            pa, pb = decode_planes(static.bed[
                (shards[0].win[b].long() + int(shards[0].blk[b]) * B)])
            ab = torch.cat([pa, pb], dim=0).reshape(2 * B, -1)
            e2 = eps.reshape(T, -1)
            dd = torch.randn((T, 2 * B), generator=gen, device=dev)
            yard = n_sh * cuda_ms(lambda: (e2 @ ab.T, dd @ ab), 50)
            del pa, pb, ab
            res[(n_sh, nt)] = dict(ms=graph_ms, eager_ms=eager_ms,
                                   host_us=host_us, plain_ms=plain_ms,
                                   bound=bound, matmul_ms=yard, plan=plan,
                                   split=split)
        if len(drawn) < 2:
            fail(f"block_sweep (NT={nt}, mb={mb}): the parity cases drew a "
                 f"single component")
    return err, res


# Kernel 9 on panels wider than the anchor's: the large-N panel's width
# (N=100,000) at NT=4, and N=240,000 at NT=1, four blocks each, the last
# with 96 pad slots.
WIDE_BLOCK_STEPS = ((MB_BIG, False), (60_000, True))
STEP_MT = 4 * B - 96


def wide_step_ms(dev, gen, mb, shared, n_sh):
    """Device ms per block step of ``n_sh`` shards at ``mb`` byte columns,
    for comparing two trees inside one call: the tree's own launches of
    one step (one launch for all shards, or the earlier design's launch per
    shard through ``block_sweep``), recorded once and repeated back to back
    between CUDA events.  Returns (ms, launches per step)."""
    import torch
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.ops import sweep_kernel as sk

    static, st, _, _, _ = sweep_operands(dev, gen, shared, mb, STEP_MT)
    nt = static.gram_cache.shape[1]
    tables = sk.build_sweep_tables(st["sigmag"], st["sigmae"], st["pi"],
                                   static.cva, static.cvai, static.nonas,
                                   static.n_total)
    tail = (st["sigmag"], *tables, (1.0 / (2.0 * st["sigmae"])).contiguous(),
            static.nonas)
    eps = st["eps"]
    shards = shard_operands(dev, gen, static, st, n_sh)
    b = 1
    recorded, keep = [], []
    real_launch = _build.launch
    _build.launch = lambda *a: recorded.append(a) or real_launch(*a)
    try:
        if hasattr(sk, "ShardedBlockSweep"):
            sweep = sk.ShardedBlockSweep().sweep(
                shards, eps, static.na[:nt].contiguous(), *tail, wave=W)
            keep += [sweep, sweep.step(b, out=torch.empty_like(eps))]
        else:
            for s in shards:
                keep.append(sk.block_sweep(
                    s.blk[b:b + 1], s.m_local, s.bed, s.win[b], s.gram, eps,
                    static.na, s.mave, s.msig, s.beta, s.comp, s.acum, s.grp,
                    s.u[b], s.z[b], *tail, wave=W))
    finally:
        _build.launch = real_launch
    torch.cuda.synchronize()

    def step():
        for a in recorded:
            real_launch(*a)

    ms = call_ms(step, 300)
    del keep
    return ms, len(recorded)


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


def one_thread():
    """A dataset worker's set-up, before it imports numpy."""
    os.environ.update(dict.fromkeys(
        ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"), "1"))


def anchor_options(sim, out_dir, wave=W, iterations=ITERS, dtype="float32"):
    """``wave`` None lets the plan pick the wave, as a user's run does."""
    from gmrm_tpu_torch.config import Options
    opt = Options(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                  group_index_file=sim.gri, group_mixture_file=sim.grm,
                  iterations=iterations, seed=42, out_dir=out_dir,
                  block_size=B, wave_size=wave, output_thin_rate=THIN,
                  dtype=dtype)
    opt.validate()
    opt.load_group_mixtures()
    return opt


def sweep_gate(sim, dev, wave, name, card, against="plain",
               dtype="float32"):
    """Phases 3, 3b, 3c and 7b: one sweep through the default marker_sweep
    on the card (the whole-sweep kernel at W>1; at W=1 kernels 5, 2, 6,
    the fused pass and 4, or at float64 kernels A, B and C) against the
    plain versions on the host CPU or, with ``against`` "composed",
    against the composed kernels 2, 3, 4 on the card.  ``wave`` None is
    the auto plan, which must resolve to W=1.  At float64 the draws are
    float64 and |dbeta|, |deps| are held to 1e-9 (1e-4 at float32)."""
    import numpy as np
    import torch
    from gmrm_tpu_torch import runner
    from gmrm_tpu_torch.config import resolve_plan
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.ops.sweep_kernel import sweep_plan
    from gmrm_tpu_torch.sampler.gibbs import marker_sweep

    opt = anchor_options(sim, "", wave, dtype=dtype)
    resolve_plan(opt, "cuda", sim.m)
    if (opt.wave_size > 1) != (wave is not None):
        fail(f"{name}: the plan resolved to W={opt.wave_size}")
    fdt = np.float64 if dtype == "float64" else np.float32
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
        rng.uniform(size=(nblocks, T, B)).astype(fdt),
        rng.normal(size=(nblocks, T, B)).astype(fdt))]
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
    nt = 1 if static.shared_na else T
    want_counts = ({"sweep_blocks": 1} if opt.wave_size > 1
                   else f64_counts(nblocks, nt) if dtype == "float64"
                   else serial_counts(nblocks, nt))
    if counts["kernels"] != want_counts or (
            against == "composed"
            and counts[against] != composed_counts(nblocks)):
        fail(f"{name}: launches {counts}")
    (ke, kb, kc, _, kcass), (pe, pb, pc, _, pcass) = (res["kernels"],
                                                      res[against])
    n_diff = int((kc != pc).sum())
    db = float((kb - pb).abs().max())
    de = float((ke - pe).abs().max())
    tol = 1e-9 if dtype == "float64" else 1e-4
    print(f"# {name} (W={opt.wave_size}, NT={nt}, {nblocks} blocks, "
          f"mb_pad={data.mb_pad}, {dtype}) against the {against} sweep: "
          f"comp mismatches {n_diff} of {kc.numel()}, cass equal "
          f"{torch.equal(kcass, pcass)}, max|dbeta| {db:.3e}, max|deps| "
          f"{de:.3e}; launches {counts['kernels']}", flush=True)
    if n_diff or not torch.equal(kcass, pcass) or db > tol or de > tol:
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


def training_phase(sim, dev, tmp, wave, iterations, check_launches=True,
                   dtype="float32", tag=""):
    """Phases 4 and 4b: run_training through the entry point.  In wave mode
    the Gram cache launches once per run and the whole-sweep kernel once per
    iteration; at W=1 (``serial_counts``) kernel 6 once per block, the
    fused update and c-dot once per block but the last, kernels 2 and 4
    once each, and kernel 5 once per run of blocks; at float64 (phase 7c,
    ``f64_counts``) kernels A, B and C.  The other paths' kernels launch
    not at all.  ``check_launches`` False skips that check, for a tree of
    another cadence.  ``tag`` names the out-dir of a repeated run.  Also
    returns the run's peak device memory
    (torch.cuda.max_memory_allocated)."""
    import numpy as np
    from gmrm_tpu_torch.io.writers import read_history
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.runner import check_finite_chain, run_training

    import torch
    f64 = dtype == "float64"
    out_dir = os.path.join(tmp, f"out_w{wave}{'_f64' if f64 else ''}{tag}")
    opt = anchor_options(sim, out_dir, wave, iterations, dtype)
    # The peak is the run's own: earlier phases' garbage is freed first.
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    res = run_training(opt, device=dev, verbose=False)
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    nblocks = -(-MT // B)
    # The anchor has no phenotype NAs: NT = 1.
    path = (launches if not check_launches
            else {"gram_cache": 1, "sweep_blocks": iterations} if wave > 1
            else f64_counts(nblocks, 1, sweeps=iterations) if f64
            else serial_counts(nblocks, 1, sweeps=iterations))
    for name, n in launches.items():
        want = path.get(name, 0)
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
    return res, launches, steady, sg / (sg + se), peak


def sharded_setup(sim, dev, n_shards, wave=W, dtype="float32"):
    """The per-shard static inputs, start states and RNG plans of ``sim``,
    as run_training_sharded builds them, every shard on ``dev``; ``wave``
    None is the auto plan."""
    from gmrm_tpu_torch.config import resolve_plan
    from gmrm_tpu_torch.parallel import runner as prunner
    from gmrm_tpu_torch.sampler.dists import RngPlan

    opt = anchor_options(sim, "", wave, dtype=dtype)
    resolve_plan(opt, "cuda", sim.m // n_shards, sharded=True)
    data = prunner.load_data_process(opt, n_shards,
                                     interleave=opt.wave_size > 1)
    return (opt, data, prunner.build_static_sharded(data, opt, dev),
            prunner.init_states_sharded(data, opt, dev),
            [RngPlan(opt.seed, dev, shard=i) for i in range(n_shards)])


def sharded_gate(sim, dev, card, n_shards, wave, name, dtype="float32"):
    """Phases 3d, 3e and 7e: one sharded sweep on the card, with the same
    injected order and draws per shard on both sides.  At W > 1 the fused
    per-block kernel against the composed kernels 2, 3 and 4 at the same
    cadence, both on the card; with ``wave`` None (the auto plan, which
    must resolve to W=1) kernels 5, 2, 6 and 4 (at float64 A, B and C)
    adding into a delta against their plain versions on the host CPU."""
    import numpy as np
    import torch
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.parallel.distributed import Communicator
    from gmrm_tpu_torch.sampler.gibbs import marker_sweep_sharded

    opt, data, statics, states, _ = sharded_setup(sim, dev, n_shards, wave,
                                                  dtype)
    if (opt.wave_size > 1) != (wave is not None):
        fail(f"{name}: the plan resolved to W={opt.wave_size}")
    fdt = np.float64 if dtype == "float64" else np.float32
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
    u = [rng.uniform(size=(nblocks, T, B)).astype(fdt)
         for _ in range(n_shards)]
    z = [rng.normal(size=(nblocks, T, B)).astype(fdt)
         for _ in range(n_shards)]
    first = states[0]
    sigmae = 0.5 * (first.eps * first.eps).sum(dim=(1, 2)) / statics[0].nonas
    n_launch = n_shards * nblocks
    if opt.wave_size > 1:
        # One launch per block step for all shards.
        sides = (("fused", dev, None, {"block_sweep": nblocks}),
                 ("composed", dev, False,
                  dict.fromkeys(COMPOSED_KERNELS, n_launch)))
    else:
        nt = 1 if statics[0].shared_na else T
        sides = (("kernels", dev, None,
                  f64_counts(nblocks, nt, shards=n_shards)
                  if dtype == "float64" else
                  serial_counts(nblocks, nt, shards=n_shards,
                                fused=False)),
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
    print(f"# {name} (S={n_shards}, W={opt.wave_size}, {dtype}, {nblocks} "
          f"blocks per shard, shards of {data.m_local} markers, "
          f"mb_pad={data.mb_pad}): "
          f"{sides[0][0]} against {sides[1][0]} at the same cadence: comp "
          f"mismatches {n_diff} of {n_shards * T * mps}, cass equal "
          f"{torch.equal(acass, bcass)}, max|dbeta| {db:.3e}, max|deps| "
          f"{de:.3e}; {timing} (CUDA events around eager calls)  [{card}]",
          flush=True)
    tol = 1e-9 if dtype == "float64" else 1e-4
    if (n_diff or not torch.equal(acass, bcass) or db > tol or de > tol
            or not moved):
        fail(f"{name}: the two sides disagree")


def sharded_training_phase(sim, dev, tmp, n_shards, wave, iterations,
                           nccl=False, check_launches=True,
                           dtype="float32"):
    """Phases 4d and 4e: run_training_sharded through the entry point, all
    shards on the one card; with ``nccl`` inside a one-rank NCCL process
    group.  The Gram cache launches once per shard, kernel 9 once per block
    step and iteration (all shards in one launch), nothing else; at
    float64 (phase 7f, W=1) kernels A, B and C per shard and block step
    (``f64_counts``).  ``check_launches`` False skips that check, for a
    tree of another cadence."""
    import numpy as np
    import torch.distributed as dist
    from gmrm_tpu_torch.io.writers import read_history
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.parallel.distributed import init_distributed
    from gmrm_tpu_torch.parallel.runner import run_training_sharded

    f64 = dtype == "float64"
    out_dir = os.path.join(tmp, f"out_s{n_shards}{'_nccl' if nccl else ''}"
                                f"{'_f64' if f64 else ''}")
    opt = anchor_options(sim, out_dir, wave, iterations, dtype)
    if nccl:
        init_distributed(f"file://{tmp}/rendezvous_s{n_shards}"
                         f"{'_f64' if f64 else ''}", 1, 0,
                         backend="nccl", timeout_seconds=120)
    try:
        _build.reset_launch_counts()
        res = run_training_sharded(opt, n_devices=n_shards, device=dev,
                                   verbose=False)
        launches = _build.launch_counts()
    finally:
        if nccl:
            dist.destroy_process_group()
    if opt.wave_size != (1 if f64 else W):
        fail(f"S={n_shards} training: the plan resolved to W={opt.wave_size}")
    nblocks = -(-(-(-MT // n_shards)) // B)     # ceil(ceil(MT / S) / B)
    want = (f64_counts(nblocks, 1, iterations, n_shards) if f64 else
            {"gram_cache": n_shards, "block_sweep": nblocks * iterations})
    for name, n in launches.items():
        if check_launches and n != want.get(name, 0):
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


def chain_setup(sim, dev, wave=W, dtype="float32"):
    """The anchor's data, static inputs, start state and RNG plan, as
    run_training builds them."""
    from gmrm_tpu_torch import runner
    from gmrm_tpu_torch.config import resolve_plan
    from gmrm_tpu_torch.sampler.dists import RngPlan

    opt = anchor_options(sim, "", wave, dtype=dtype)
    resolve_plan(opt, "cuda", sim.m)
    data = runner.load_data(opt)
    return (opt, runner.build_static(data, opt, dev),
            runner.init_sampler_state(data, opt, dev), RngPlan(opt.seed, dev))


def eager_gate(sim, dev, res, iterations=ITERS):
    """Phase 4's gate: the state run_training reached at W=32 (the
    whole-sweep iteration, its host work in CUDA graphs) equals, bit for
    bit, the state of the same number of eager gibbs_iteration calls from
    the same start and seed on this tree."""
    import torch
    from gmrm_tpu_torch.sampler.gibbs import gibbs_iteration

    opt, static, state, rng = chain_setup(sim, dev)
    for it in range(1, iterations + 1):
        state, _ = gibbs_iteration(state, static, it, rng, block_size=B,
                                   wave=opt.wave_size)
    torch.cuda.synchronize()
    names = ("eps", "betas", "comp", "acum", "cass", "sigmag", "sigmae",
             "pi_est", "mu")
    differ = [n for n in names
              if not torch.equal(getattr(res.state, n), getattr(state, n))]
    if differ:
        fail(f"W={W} training: after {iterations} iterations the state "
             f"differs from the eager gibbs_iteration chain in {differ}")
    return names


def counted(run):
    """``run()`` with the launch counts set to 0 just before it; returns
    (its result, the counts it launched)."""
    from gmrm_tpu_torch.ops import _build
    _build.reset_launch_counts()
    out = run()
    return out, {k: v for k, v in _build.launch_counts().items() if v}


def resume_phase(sim, dev, tmp, card):
    """Phase 4f: resume and the startup cache on the card, against phase
    4's, 4b's and 4d's uninterrupted runs.  W=32: 12 iterations with a
    checkpoint at 7 (not a thin boundary: the record at 10 is written past
    it) and a fresh --cache-dir (cold: kernel 1 once), then the resume to
    20 from the warm cache (kernel 1 not at all); the warm statistics and
    Gram cache equal to a build without the cache.  W=1: a checkpoint at 3,
    the chain on to 5 (its record at 5 written past it), the resume to 10.
    Sharded S=2 (auto plan): the same, with a cache per shard.  Each run's .csv/.bet/.cpn bytes equal
    the uninterrupted run's.  Times one checkpoint save at the anchor, the
    cold and warm startups and the cache key's digest.  Returns the
    launches of its runs."""
    import numpy as np
    import torch
    from gmrm_tpu_torch import checkpoint, runner
    from gmrm_tpu_torch.config import resolve_plan
    from gmrm_tpu_torch.parallel.runner import run_training_sharded

    t_phase = time.perf_counter()
    nblocks = -(-MT // B)
    total = {}

    def run(name, opt, want, sharded=0):
        res, launches = counted(
            lambda: run_training_sharded(opt, n_devices=sharded, device=dev,
                                         verbose=False) if sharded
            else runner.run_training(opt, device=dev, verbose=False))
        if launches != want:
            fail(f"{name}: launches {launches}, expected {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return res

    def chain(name, wave, ref, iterations, every, stop, sharded=0,
              cache=False, want_cold=None, want_warm=None):
        out = os.path.join(tmp, f"resume_{name}")
        cache_dir = os.path.join(tmp, f"cache_{name}") if cache else ""
        opt = anchor_options(sim, out, wave, stop)
        opt.checkpoint_every, opt.cache_dir = every, cache_dir
        cold = run(f"{name} to {stop}", opt, want_cold, sharded)
        opt = anchor_options(sim, out, wave, iterations)
        opt.checkpoint_every, opt.cache_dir = every, cache_dir
        opt.resume = True
        warm = run(f"{name} resumed", opt, want_warm, sharded)
        if warm.iters_run != iterations - every:
            fail(f"{name}: the resume ran {warm.iters_run} iterations")
        if not same_artifacts(sim, ref, out):
            fail(f"{name}: the resumed chain wrote other bytes than the "
                 f"uninterrupted run in {ref}")
        if cache and not (all(c.warm for c in warm.caches)
                          and not any(c.warm for c in cold.caches)):
            fail(f"{name}: the startup cache was not cold, then warm")
        return cold, warm

    cold, warm = chain(
        f"w{W}", W, os.path.join(tmp, f"out_w{W}"), ITERS, 7, 12, cache=True,
        want_cold={"gram_cache": 1, "sweep_blocks": 12},
        want_warm={"sweep_blocks": ITERS - 7})
    chain("w1", 1, os.path.join(tmp, "out_w1"), ITERS_SERIAL, 3, 5,
          want_cold=serial_counts(nblocks, 1, sweeps=5),
          want_warm=serial_counts(nblocks, 1, sweeps=ITERS_SERIAL - 3))
    s0, w0, n0 = SHARDED_RUNS[0]
    nb_s = -(-(-(-MT // s0)) // B)
    chain(f"s{s0}", w0, os.path.join(tmp, f"out_s{s0}"), n0, 3, 5,
          sharded=s0, cache=True,
          want_cold={"gram_cache": s0, "block_sweep": nb_s * 5},
          want_warm={"block_sweep": nb_s * (n0 - 3)})

    # The warm statistics and Gram cache against a build without the cache,
    # each step of the startup timed alone.
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    opt = anchor_options(sim, "", W)
    opt.cache_dir = os.path.join(tmp, f"cache_w{W}")
    resolve_plan(opt, "cuda", sim.m)
    data, load_s = timed(lambda: runner.load_data(opt))
    built, build_s = timed(lambda: runner.build_static(data, opt, dev))
    entry, digest_s = timed(lambda: runner.startup_cache(data, opt))
    loaded, read_s = timed(lambda: runner.build_static(data, opt, dev,
                                                       entry))
    if not entry.warm:
        fail("the startup cache entry of the W=32 run was not found")
    for name in ("mave", "msig", "gram_cache"):
        if not torch.equal(getattr(built, name), getattr(loaded, name)):
            fail(f"the warm {name} differs from the cold one")

    # One checkpoint save at the anchor: the resumed state on the card.
    path = os.path.join(tmp, "checkpoint_timed.npz")
    beta_acc = np.zeros((T, MT))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(path, warm.state, ITERS, beta_acc,
                               ITERS // THIN, 42,
                               checkpoint.layout_of(opt, MT))
    save_s = time.perf_counter() - t0
    cache_bytes = os.path.getsize(cold.caches[0].path)
    print(f"# resume and startup cache (phase 4f): W={W} 12 iterations with "
          f"a checkpoint at 7 and a cold --cache-dir, resumed to {ITERS} "
          f"warm; W=1 checkpoint at 3, 5 iterations, resumed to "
          f"{ITERS_SERIAL}; S={s0} checkpoint at 3, 5 iterations, resumed "
          f"to {n0} (a cache entry per shard): the bytes of phases 4, 4b and "
          f"4d, the warm mave, msig and Gram cache equal to the cold ones; "
          f"launches {total}  [{card}]", flush=True)
    print(f"# checkpoint save at the anchor (W={W}, {T} traits, Mt={MT}): "
          f"{save_s:.4f} s, {os.path.getsize(path)} bytes  [{card}]",
          flush=True)
    print(f"# startup at the anchor, W={W}: cold with --cache-dir "
          f"{cold.startup_seconds:.4f} s (load, digest, statistics, Gram "
          f"cache, the entry of {cache_bytes} bytes written); warm "
          f"{warm.startup_seconds:.4f} s (load, digest, the entry read and "
          f"uploaded)  [{card}]", flush=True)
    print(f"# startup cache key at the anchor: blake2b digest of the "
          f"{data.bed.nbytes} loaded bed bytes and the phen files "
          f"{warm.caches[0].digest_seconds:.4f} s (cold run "
          f"{cold.caches[0].digest_seconds:.4f} s)  [{card}]", flush=True)
    print(f"# startup steps at the anchor, W={W}, each synchronized: "
          f"load_data {load_s:.4f} s; build_static without the cache "
          f"(statistics and Gram cache on the card) {build_s:.4f} s; the "
          f"cache key {digest_s:.4f} s; build_static from the warm entry "
          f"(read and upload) {read_s:.4f} s; phase 4f's wall "
          f"{time.perf_counter() - t_phase:.1f} s  [{card}]", flush=True)
    return total


# Predict's sums: float32 sums that the kernel and the plain version take in
# other orders, so xty is held to PREDICT_RTOL * sum|val*y| + PREDICT_ATOL
# per marker; xtx, a sum of integers below 2^24, bit for bit.
PREDICT_RTOL, PREDICT_ATOL = 1e-5, 1e-6


# At float64 (kernel D): xty within PREDICT_F64_RTOL * sum|val*y| +
# PREDICT_F64_ATOL, float64 sums in another order.
PREDICT_F64_RTOL, PREDICT_F64_ATOL = 1e-11, 1e-12


def predict_planes(ph, dev, pitch, dtype="float32"):
    """One trait's na and y planes as run_predict makes them (float32, or
    float64, from the float64 host vectors, padded to the kernel's row
    pitch)."""
    import torch
    from gmrm_tpu_torch.ops.decode import to_phase_planes
    from gmrm_tpu_torch.ops.predict_sums import pad_columns
    return [torch.from_numpy(pad_columns(
        to_phase_planes(v).astype(dtype), pitch, 0.0)).to(dev)
        for v in (ph.na_vector_padded(), ph.epsilon_padded())]


def predict_case(name, bed_d, na_d, y_d, n, card, reps=40):
    """Phase 6a: the predict kernel on one trait's planes against its plain
    version on the card: xtx bit-equal, xty within the bound, two launches
    bit-equal; kernel and plain ms by graph replay, beside torch.mv on the
    pre-decoded float32 val (M, 4L) and y, the xty half (a yardstick: no
    PyTorch call decodes and reduces).  Returns the row's numbers."""
    import torch
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.ops.decode import decode_planes
    from gmrm_tpu_torch.ops.predict_sums import (
        predict_sums, predict_sums_plain,
    )
    m, pitch = bed_d.shape
    mb = (n + 3) // 4
    got = [torch.stack(predict_sums(bed_d, na_d, y_d)) for _ in range(2)]
    want = torch.stack(predict_sums_plain(bed_d, na_d, y_d))
    # sum|val*y| = sum val*|y|, since val = a*na >= 0.
    scale = predict_sums_plain(bed_d, na_d, y_d.abs())[1].double()
    dxty = (got[0][1].double() - want[1].double()).abs()
    if not torch.equal(got[0], got[1]):
        fail(f"predict_sums {name}: two launches differ")
    if not torch.equal(got[0][0], want[0]):
        fail(f"predict_sums {name}: xtx differs from the plain version")
    f64 = y_d.dtype == torch.float64
    rtol, atol = ((PREDICT_F64_RTOL, PREDICT_F64_ATOL) if f64
                  else (PREDICT_RTOL, PREDICT_ATOL))
    if (dxty > rtol * scale + atol).any():
        fail(f"predict_sums {name}: xty off by {float(dxty.max()):.3e}")
    ms = cuda_ms(lambda: predict_sums(bed_d, na_d, y_d), reps)
    plain_ms = cuda_ms(lambda: predict_sums_plain(bed_d, na_d, y_d), 2)
    val = torch.empty((m, 4 * pitch), device=bed_d.device, dtype=y_d.dtype)
    for s in range(0, m, 512):
        a, _ = decode_planes(bed_d[s:s + 512], y_d.dtype)
        val[s:s + 512] = (a * na_d).reshape(a.shape[0], -1)
    y_flat = y_d.reshape(-1)
    mv_ms = cuda_ms(lambda: torch.mv(val, y_flat), reps)
    del val
    # The bed once, na and y once, the sums once; xty's multiply-add per
    # individual at the float rate of y's type.  xtx is integer popcounts,
    # two a word of 16 individuals, and is not counted.
    es = y_d.element_size()
    bound = bound_of(m * mb + 2 * 4 * mb * es + 2 * m * es,
                     (2 * m * n, F64_OPS if f64 else F32_OPS))
    team = _build.library().gmrm_predict_sums_team(pitch)
    print(f"# predict_sums{'_f64' if f64 else ''}, {name} (M={m}, mb={mb}, "
          f"row pitch {pitch}, "
          f"{team} warp(s) a group of 4 rows): xtx bit-equal to the plain "
          f"version, max |dxty| {float(dxty.max()):.3e} (bound "
          f"{rtol:g} sum|val*y| + {atol:g}), two launches "
          f"bit-equal; kernel ms {ms:.5f}, plain ms {plain_ms:.4f} (CUDA "
          f"graph replay); torch.mv yardstick on pre-decoded "
          f"{'f64' if f64 else 'f32'} ({m} x {4 * pitch}) {mv_ms:.4f} ms; "
          f"bound {bound[0]:.5f} ms by {bound[1]}  [{card}]", flush=True)
    return dict(err=float(dxty.max()), ms=ms, plain_ms=plain_ms,
                mv_ms=mv_ms, bound=bound)


def mlma_fields(path):
    import numpy as np
    rows = [ln.split() for ln in open(path).read().splitlines()]
    return ([(r[0], int(r[1]), int(r[2])) for r in rows],
            np.array([[float(v) for v in r[3:]] for r in rows]))


def predict_phase(sim, big, dev, tmp, card):
    """Phase 6: predict.  (a) The kernel alone (``predict_case``) at the
    anchor's bed with its NA-free trait and with a 2% NA mask, and on the
    large-N panel's bed (N=100,000, 4,096 markers) with its 2% NAs.  (b)
    The path: run_predict on phase 4's W=32 .bet files (bim = ref bim), on
    the card (one launch per trait: the anchor's bed is one chunk), again
    on the card through the command line (``--predict``; the same bytes
    and launches), and on the CPU (the plain version): ids,
    mglo, rmglo and line count equal, beta, t, se and p within what the
    xty bound allows each.  Returns the row and the path's numbers."""
    import shutil
    import numpy as np
    import torch
    from gmrm_tpu_torch import cli
    from gmrm_tpu_torch.config import Options
    from gmrm_tpu_torch.io.bed import read_bed
    from gmrm_tpu_torch.io.phen import read_phen
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.ops.predict_sums import (
        padded_chunk, pitch_of, predict_sums_plain,
    )
    from gmrm_tpu_torch.predict import run_predict

    pitch = pitch_of((N + 3) // 4)
    bed_d = padded_chunk(read_bed(sim.bed, N, MT), 0, MT, dev)
    phens = [read_phen(p, N) for p in sim.phens]
    na_d, y_d = predict_planes(phens[0], dev, pitch)
    row = predict_case("anchor, NT=1", bed_d, na_d, y_d, N, card)
    rng = np.random.default_rng(5)
    keep = torch.from_numpy(
        (rng.uniform(size=(4, pitch)) > 0.02).astype(np.float32)).to(dev)
    cases = [row, predict_case("anchor, 2% NAs", bed_d, na_d * keep,
                               y_d * keep, N, card)]
    big_pitch = pitch_of((N_BIG + 3) // 4)
    big_bed = padded_chunk(read_bed(big.bed, N_BIG, MT_BIG), 0, MT_BIG, dev)
    cases.append(predict_case(
        "large-N panel, 2% NAs", big_bed,
        *predict_planes(read_phen(big.phens[0], N_BIG), dev, big_pitch),
        N_BIG, card))
    del big_bed
    row = dict(row, err=max(c["err"] for c in cases))

    train = os.path.join(tmp, f"out_w{W}")
    runs = {}
    for key, device in (("card", dev), ("cli", dev), ("cpu", "cpu")):
        out = os.path.join(tmp, f"predict_{key}")
        os.makedirs(out)
        for p in sim.phens:
            bet = os.path.splitext(os.path.basename(p))[0] + ".bet"
            shutil.copy(os.path.join(train, bet), os.path.join(out, bet))
        opt = Options(bed_file=sim.bed, dim_file=sim.dim,
                      phen_files=sim.phens, bim_file=sim.bim,
                      ref_bim_file=sim.bim, out_dir=out, predict=True)
        argv = ["--predict", "--bed-file", sim.bed, "--dim-file", sim.dim,
                "--phen-files", ",".join(sim.phens), "--bim-file", sim.bim,
                "--ref-bim-file", sim.bim, "--out-dir", out,
                "--verbosity", "-1"]
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        if key != "cli":
            split = run_predict(opt, device=device, verbose=False)
        elif cli.main(argv, device=device) == 0:     # the command line
            split = {}
        else:
            fail("predict: python -m gmrm_tpu_torch --predict failed")
        runs[key] = (out, time.perf_counter() - t0, split,
                     _build.launch_counts())
    for key in ("card", "cli"):
        for name, n in runs[key][3].items():
            if n != (T if name == "predict_sums" else 0):
                fail(f"predict ({key}): kernel {name} launched {n} times, "
                     f"expected {T if name == 'predict_sums' else 0}")
    if any(runs["cpu"][3].values()):
        fail(f"predict on the CPU launched {runs['cpu'][3]}")
    worst = np.zeros(4)
    for t, p in enumerate(sim.phens):
        name = os.path.splitext(os.path.basename(p))[0] + ".mlma"
        card_, again, cpu = (os.path.join(runs[k][0], name)
                             for k in ("card", "cli", "cpu"))
        if open(card_, "rb").read() != open(again, "rb").read():
            fail(f"predict: two runs on the card wrote other bytes ({name})")
        ids_k, f_k = mlma_fields(card_)
        ids_c, f_c = mlma_fields(cpu)
        if ids_k != ids_c or len(ids_k) != MT:
            fail(f"predict: ids, mglo, rmglo or line count differ ({name})")
        na_t, y_t = predict_planes(phens[t], dev, pitch)
        xtx = predict_sums_plain(bed_d, na_t, y_t)[0].double().cpu().numpy()
        d = (PREDICT_RTOL * predict_sums_plain(bed_d, na_t, y_t.abs())[1]
             .double().cpu().numpy() + PREDICT_ATOL)
        y = phens[t].epsilon_padded()
        sigma = float(y @ y) / phens[t].nonas
        # se = sqrt(sigma / xtx) does not depend on xty; |dp/dt| <=
        # sqrt(2 / pi); the lines print 15 decimals.
        with np.errstate(divide="ignore", invalid="ignore"):
            dt = d / np.sqrt(sigma * xtx)
            tol = np.stack([d / xtx, dt, np.full_like(d, 1e-12), 0.8 * dt],
                           axis=1) + 2e-15
        diff = np.abs(f_k - f_c)
        live = ~np.isnan(f_c)
        if (np.isnan(f_k) != np.isnan(f_c)).any() or (
                diff[live] > tol[live]).any():
            fail(f"predict: {name} on the card and on the CPU disagree "
                 f"beyond the xty bound")
        worst = np.maximum(worst, np.where(live, diff, 0).max(axis=0))
    return row, runs, worst


def composed_phase(sim, dev, check_launches=True):
    """Phase 4c: the composed wave path (megakernel=False) for a few
    iterations of gibbs_iteration, so the earlier path stays driven; per
    sweep the c-dot of block 0, the wave scan per block, the fused update
    and next c-dot for every block but the last and the last block's
    update (``composed_counts``).  ``check_launches`` False skips that
    check, for a tree of another cadence."""
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
    want = composed_counts(-(-MT // B), ITERS_COMPOSED)
    for name, n in launches.items():
        if check_launches and n != want.get(name, 0):
            fail(f"composed path: kernel {name} launched {n} times, "
                 f"expected {want.get(name, 0)}")
    check_finite_chain(state.sigmag.cpu().numpy(),
                       state.sigmae.cpu().numpy(), ITERS_COMPOSED)
    return launches, sum(seconds[1:]) / (ITERS_COMPOSED - 1)


def profile_phase(sim, dev, n_shards=0, wave=W, composed=False,
                  dtype="float32"):
    """Phase 5: torch.profiler over 5 iterations at the anchor after 2 of
    warm-up, on the single-device path of ``wave`` (the whole-sweep kernel,
    or the exact serial path at 1, also at ``dtype`` float64 for phase 7),
    with ``composed`` on the composed path
    (eager gibbs_iteration with megakernel=False), or, with ``n_shards``, on
    the sharded path, as run_training runs it.  Returns the device-busy and
    wall milliseconds per iteration, host-issued launches (kernels and graph
    replays) per iteration and the busiest device kernels."""
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
        from gmrm_tpu_torch import runner
        opt, static, state, rng = chain_setup(sim, dev, wave, dtype)
        if composed:

            def step(state, it):
                return gibbs_iteration(state, static, it, rng, block_size=B,
                                       wave=opt.wave_size,
                                       megakernel=False)[0]
        elif hasattr(runner, "iteration_step"):   # what run_training runs
            one = runner.iteration_step(state, static, rng, opt)

            def step(state, it):
                return one(it)[0]
        else:

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
    # Host-issued calls that start device work: kernel launches and graph
    # replays.
    launches = sum(1 for e in events
                   if e.name.startswith(("cudaLaunch", "cudaGraphLaunch")))
    by_name, count = {}, {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + device_us(e)
        count[e.name] = count.get(e.name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    # (name, device ms per iteration, launches per iteration)
    return (busy_us / 1e3 / n, wall * 1e3 / n, launches / n,
            [(k[:48], round(v / 1e3 / n, 3), count[k] / n) for k, v in top])


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
    "update_cdot": ("gmrm_tpu_torch/csrc/update_cdot.cu",
                    "gmrm_tpu/ops/pallas_kernels.py:352"),
}
# The whole-sweep kernel also stands for the N-tiled TPU kernel; the fused
# pass for kernel 4 followed by kernel 2.
ALSO_REPLACES = {"sweep_blocks": "gmrm_tpu/ops/sweep_kernel.py:576",
                 "update_cdot": "gmrm_tpu/ops/pallas_kernels.py:275"}


def sharded_host_us(sim, dev, n_shards, reps=3):
    """Host microseconds per block step of one sharded sweep at the anchor,
    all shards on the card: the time marker_sweep_sharded takes to return
    (the device still working), the sweep's set-up included, over its
    block steps; the least of ``reps`` sweeps."""
    import torch
    from gmrm_tpu_torch.parallel.distributed import Communicator
    from gmrm_tpu_torch.sampler.gibbs import _sweep_draws, marker_sweep_sharded

    opt, data, statics, states, rngs = sharded_setup(sim, dev, n_shards)
    first = states[0]
    sigmae = 0.5 * (first.eps * first.eps).sum(dim=(1, 2)) / statics[0].nonas
    draws = [_sweep_draws(st, sta, 1, rng, B, opt.wave_size, True)
             for st, sta, rng in zip(states, statics, rngs)]
    nblocks = draws[0][0].shape[0]
    comm = Communicator(dev)
    best = float("inf")
    for _ in range(reps):
        eps = first.eps.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        marker_sweep_sharded(
            eps, [(st.betas, st.comp, st.acum) for st in states],
            first.sigmag, sigmae, first.pi_est, statics,
            [d[0] for d in draws], [d[1] for d in draws],
            [d[2] for d in draws], wave=opt.wave_size, comm=comm)
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / nblocks * 1e6


def sharded_only(dev, reps, card, repo):
    """Phase 4d (S=2 and S=4) and the sharded profiler windows (S=1, 2, 4)
    ``reps`` times on one simulated anchor, with the host microseconds per
    block step of a sharded sweep, and kernel 9's device time per block
    step of 1, 2 and 4 shards at the anchor's width and on the wide panels
    of phase 2, for comparing two trees inside one call.  The launch counts are checked only for this
    script's own tree."""
    import torch
    own = os.path.abspath(repo) == REPO
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    with tempfile.TemporaryDirectory() as tmp:
        sim = anchor_dataset(os.path.join(tmp, "data"))
        for rep in range(reps):
            for mb, shared in ((MB, True),) + WIDE_BLOCK_STEPS:
                for n_sh in SHARDS_PHASE2:
                    ms, n_launch = wide_step_ms(dev, gen, mb, shared, n_sh)
                    print(f"# {repo}: block_sweep at mb_pad={mb}, "
                          f"NT={1 if shared else T}, S_loc={n_sh}, run "
                          f"{rep + 1}: {ms:.5f} ms per block step, "
                          f"{n_launch} launch(es), back to back  [{card}]",
                          flush=True)
            for n_sh, wave, iters in SHARDED_RUNS:
                run_dir = os.path.join(tmp, f"run{rep}_s{n_sh}")
                os.makedirs(run_dir)
                _, launches, steady, span, _, _ = sharded_training_phase(
                    sim, dev, run_dir, n_sh, wave, iters,
                    check_launches=own)
                print(f"# {repo}: sharded training S={n_sh}, run {rep + 1}: "
                      f"{steady * 1e3:.2f} ms/iteration over {span}; "
                      f"launches {launches}  [{card}]", flush=True)
            for n_sh in (1, 2, 4):
                busy, wall, calls, top = profile_phase(sim, dev,
                                                       n_shards=n_sh)
                host = sharded_host_us(sim, dev, n_sh)
                print(f"# {repo}: profiler sharded S={n_sh}, run {rep + 1}: "
                      f"device busy {busy:.3f} of {wall:.3f} ms/iteration, "
                      f"idle share {1 - busy / wall:.3f}, {calls:.1f} "
                      f"host-issued launches per iteration; busiest kernels "
                      f"(name, ms and launches per iteration) {top}; host "
                      f"{host:.1f} us per block step of a sweep  [{card}]",
                      flush=True)


def f32_chains(sim_pkl, out, card, repo):
    """``--f32-chains SIM OUT``: phase 4's and 4b's float32 configurations
    (W=32 for 20 iterations, W=1 for 10, thinned output) through
    run_training of the tree at ``repo``, writing into OUT; prints each
    run's ms/iteration."""
    import pickle
    import torch
    from gmrm_tpu_torch.runner import run_training
    with open(sim_pkl, "rb") as fh:
        sim = pickle.load(fh)
    for wave, iters in ((W, ITERS), (1, ITERS_SERIAL)):
        opt = anchor_options(sim, os.path.join(out, f"w{wave}"), wave, iters)
        res = run_training(opt, device=torch.device("cuda"), verbose=False)
        steady = sum(res.iter_seconds[THIN:]) / (iters - THIN)
        print(f"# {repo}: float32 W={wave} {steady * 1e3:.2f} ms/iteration "
              f"over iterations {THIN + 1}-{iters}  [{card}]", flush=True)
    f32_kernel_bytes(os.path.join(out, "kernels"))


def f32_kernel_bytes(out):
    """The float32 block Gram (kernel 5, a run of 16 blocks at NT=1 and
    NT=4) and predict sums (a (4,096, 2,560) bed, one trait with NAs) on
    inputs drawn from one seed on the card, their raw bytes written into
    OUT: the kernels the float64 work instantiates from shared templates,
    compared across two trees by ``same_bytes``."""
    import torch
    from gmrm_tpu_torch.ops.block_gram import blocks_gram_scaled
    from gmrm_tpu_torch.ops.predict_sums import predict_sums
    os.makedirs(out)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    nb = 16
    bed = torch.randint(0, 256, (nb * B, MB), generator=gen, device=dev,
                        dtype=torch.uint8)
    rows = torch.randperm(nb * B, generator=gen, device=dev).to(
        torch.int32).reshape(nb, B).contiguous()
    na = (torch.rand((T, 4, MB), generator=gen, device=dev) > 0.03).float()
    mave = torch.rand((nb, T, B), generator=gen, device=dev) * 1.6 + 0.2
    msig = torch.rand((nb, T, B), generator=gen, device=dev) + 0.5
    y = torch.randn((4, MB), generator=gen, device=dev) * na[0]
    outs = {f"block_gram_nt{nt}": blocks_gram_scaled(
        bed, rows, na[:nt].contiguous(), mave, msig) for nt in (1, T)}
    outs["predict_sums"] = torch.stack(predict_sums(
        bed[:4096].contiguous(), na[0].contiguous(), y.contiguous()))
    for name, x in outs.items():
        with open(os.path.join(out, name + ".bin"), "wb") as fh:
            fh.write(x.cpu().numpy().tobytes())


def same_bytes(tree, card):
    """``--same-bytes TREE``: phase 4's and 4b's float32 chains written by
    the tree at TREE and by this one, each in its own process on the one
    card, in the order TREE, this, this, TREE (``f32_chains``), with the
    float32 kernel outputs of ``f32_kernel_bytes``; the files of the first
    two runs must be equal byte for byte."""
    import filecmp
    import pickle
    with tempfile.TemporaryDirectory() as tmp:
        sim = anchor_dataset(os.path.join(tmp, "data"))
        pkl = os.path.join(tmp, "sim.pkl")
        with open(pkl, "wb") as fh:
            pickle.dump(sim, fh)
        order = (("a", tree), ("b", REPO), ("b2", REPO), ("a2", tree))
        for name, repo in order:
            run = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--f32-chains", pkl,
                                  os.path.join(tmp, name), "--repo", repo])
            if run.returncode:
                fail(f"--f32-chains in {repo} failed")
        for w in (f"w{W}", "w1", "kernels"):
            a, b = os.path.join(tmp, "a", w), os.path.join(tmp, "b", w)
            names = sorted(os.listdir(a))
            _, differ, errors = filecmp.cmpfiles(a, b, names, shallow=False)
            if differ or errors or names != sorted(os.listdir(b)):
                fail(f"float32 {w}: {tree} and {REPO} wrote other bytes "
                     f"({differ or errors})")
            what = ("kernel outputs'" if w == "kernels"
                    else f"{w} chain's")
            print(f"# same bytes: the float32 {what} {len(names)} "
                  f"files of {tree} and {REPO} are equal  [{card}]",
                  flush=True)


def training_only(dev, reps, card, repo):
    """Phases 4, 4b and 4c ``reps`` times on one simulated anchor: the
    steady ms/iteration of every run and phase 5's profiler windows on the
    W=32, W=1 and composed paths, for comparing two trees inside one call.
    The launch counts are checked only for this script's own tree."""
    own = os.path.abspath(repo) == REPO
    with tempfile.TemporaryDirectory() as tmp:
        sim = anchor_dataset(os.path.join(tmp, "data"))
        for rep in range(reps):
            for wave, iters in ((W, ITERS), (1, ITERS_SERIAL)):
                run_dir = os.path.join(tmp, f"run{rep}_w{wave}")
                os.makedirs(run_dir)
                res, _, steady, _, _ = training_phase(
                    sim, dev, run_dir, wave, iters, check_launches=own)
                print(f"# {repo}: training W={wave}, run {rep + 1}: "
                      f"{steady * 1e3:.2f} ms/iteration, startup "
                      f"{res.startup_seconds:.3f} s  [{card}]", flush=True)
            launches, composed_s = composed_phase(sim, dev,
                                                  check_launches=own)
            print(f"# {repo}: composed W={W}, run {rep + 1}: "
                  f"{composed_s * 1e3:.2f} ms/iteration; launches "
                  f"{ {k: v for k, v in launches.items() if v} }  [{card}]",
                  flush=True)
            for wave, comp in ((W, False), (1, False), (W, True)):
                busy, wall, calls, top = profile_phase(sim, dev, wave=wave,
                                                       composed=comp)
                print(f"# {repo}: profiler {'composed ' if comp else ''}"
                      f"W={wave}, run {rep + 1}: device "
                      f"busy {busy:.3f} of {wall:.3f} ms/iteration, idle "
                      f"share {1 - busy / wall:.3f}, {calls:.1f} host-issued "
                      f"launches and graph replays per iteration; {top}  "
                      f"[{card}]", flush=True)


def close64(name, got, want):
    """Float64 kernels against their plain versions: within 1e-10 of
    max|want| (a sum of at most 4 mb float64 terms in another order)."""
    err = max_err(got, want)
    if err > 1e-10 * float(want.abs().max()):
        fail(f"{name}: kernel disagrees with its float64 plain version "
             f"(max abs err {err:.3e}, max|want| "
             f"{float(want.abs().max()):.3e})")
    return err


def float64_kernel_phase(dev, gen, card):
    """Phase 7a: kernels A, B and C against their float64 plain versions
    on the card, at the anchor's shapes (T=4, B=128, K=4, mb_pad=2560,
    157 blocks, the last with 96 pad slots), with the shared (NT=1) and a
    per-trait (NT=4) NA mask, an adaV group; each launched twice on the
    same inputs (bit-equal) and timed beside its plain version by graph
    replay, with a float64 torch.matmul yardstick on pre-decoded operands
    for A and B.  Kernel A's gs bit-equal (the same roundings as the plain
    version); B's c and eps and C's betas and acum within 1e-10 of their
    largest magnitude, C's comp exact, with |c| of order 30 and of order
    1e3 (where some live steps must take the |dlogl| > 700 guard).
    Returns {name: (max abs err, kernel ms, plain ms, library ms or None,
    bound)}."""
    import torch
    from gmrm_tpu_torch.ops import block_gram as bg
    from gmrm_tpu_torch.ops import block_kernels as bk
    from gmrm_tpu_torch.ops import scan_kernel as sk6
    from gmrm_tpu_torch.ops import scan_kernel_wave as sw
    from gmrm_tpu_torch.ops import sweep_kernel as sk
    from gmrm_tpu_torch.ops.decode import decode_planes

    f64 = torch.float64
    nblocks = -(-MT // B)
    m_pad = nblocks * B
    bed = torch.randint(0, 256, (m_pad, MB), generator=gen, device=dev,
                        dtype=torch.uint8)
    bed[MT:] = 0x55                                      # pad rows
    bed[:, MB - 60:] = 0x55                              # pad columns
    na_shared = torch.ones((T, 4, MB), device=dev, dtype=f64)
    na_shared[:, :, MB - 60:] = 0
    na_trait = na_shared * (torch.rand((T, 4, MB), generator=gen, device=dev,
                                       dtype=f64) > 0.03)
    # The W=1 order: the real markers shuffled, the pad rows last.
    rows_all = torch.cat([torch.randperm(MT, generator=gen, device=dev),
                          torch.arange(MT, m_pad, device=dev)]).to(
        torch.int32).reshape(nblocks, B).contiguous()
    real = (rows_all < MT)[:, None, :]
    mave_p = ((torch.rand((nblocks, T, B), generator=gen, device=dev,
                          dtype=f64) * 1.6 + 0.2) * real).contiguous()
    msig_p = ((torch.rand((nblocks, T, B), generator=gen, device=dev,
                          dtype=f64) * 1.5 + 0.5) * real).contiguous()
    res = {}
    ms_of = {}

    # Kernel A: a run of blocks that ends with the last one, at NT=1 (all
    # 157 blocks, one run) and NT=4 (the run the byte budget allows).
    gram_ops = 2 * (2 * (B * (B + 1) // 2) + B * B) * 4 * (MB - 60)
    err_a, a_ms = 0.0, []
    for na in (na_shared, na_trait):
        nt = 1 if na is na_shared else T
        na_in = (na[:1] if nt == 1 else na).to(torch.float32).contiguous()
        nb = bg.gram_run_blocks(T, B, nt, nblocks, 8)
        s = slice(nblocks - nb, nblocks)
        args = (bed, rows_all[s].contiguous(), na_in,
                mave_p[s].contiguous(), msig_p[s].contiguous())
        got = bit_equal_twice(f"block_gram_f64 (NT={nt})", lambda: (
            bg.blocks_gram_scaled(*args),))[0]
        want = bg.blocks_gram_scaled_plain(*args)
        if got.dtype != f64 or not torch.equal(got, want):
            fail(f"block_gram_f64 (NT={nt}): gs is not bit-equal to its "
                 f"plain version (max abs err {max_err(got, want):.3e})")
        del got, want
        a_ms.append((nb, cuda_ms(lambda: bg.blocks_gram_scaled(*args), 5)
                     / nb, cuda_ms(lambda: bg.blocks_gram_scaled_plain(
                         *args), 1) / nb))
    # One block's scaled Gram from pre-decoded float64 operands (NT=1).
    pa, pb = decode_planes(bed[rows_all[0].long()], f64)
    ab = torch.cat([pa, pb]).reshape(2 * B, -1)
    abn = ab * na_shared[0].reshape(1, -1)
    lib_a = cuda_ms(lambda: abn @ ab.T, 20)
    del pa, pb, abn
    res["block_gram_f64"] = (
        err_a, a_ms[0][1], a_ms[0][2], lib_a,
        bound_of(B * MB + T * B * B * 8 + 2 * T * B * 8,
                 (gram_ops, INT8_OPS), (8 * T * B * B, F64_OPS)))
    ms_of["block_gram_f64"] = ", ".join(
        f"NT={nt}: {k:.5f} per block in a run of {nb} (plain {p:.4f})"
        for (nb, k, p), nt in zip(a_ms, (1, T)))

    # Kernel B: the c-dot and the update of one block through the one-block
    # wrappers (the update from a zero residual: the compared values are
    # the update itself), then through BlockPasses on the sweep's arrays
    # and a block index, bit-equal to the wrappers, and timed there.
    bm = nblocks // 2
    rows = rows_all[bm].contiguous()
    eps = torch.randn((T, 4, MB), generator=gen, device=dev, dtype=f64)
    d_all = (torch.randn((nblocks, T, B), generator=gen, device=dev,
                         dtype=f64) * 0.01).contiguous()
    err_c = err_u = 0.0
    for na in (na_shared, na_trait):
        e = (eps * na).contiguous()
        mave, msig, d = mave_p[bm], msig_p[bm], d_all[bm]
        where = f"{mask_name(na)}, one block"
        c = bit_equal_twice(f"block_cdot_f64 ({where})", lambda: (
            bk.block_cdot(bed, rows, e, mave, msig),))[0]
        err_c = max(err_c, close64(f"block_cdot_f64 ({where})", c,
                                   bk.block_cdot_plain(bed, rows, e, mave,
                                                       msig)))

        def upd():
            t = torch.zeros_like(e)
            bk.block_eps_update_(bed, rows, d, mave, na, t)
            return (t,)
        u = bit_equal_twice(f"eps_update_f64 ({where})", upd)[0]
        want = bk.block_eps_update_plain_(bed, rows, d, mave, na,
                                          torch.zeros_like(e))
        err_u = max(err_u, close64(f"eps_update_f64 ({where})", u, want))
        if not u.abs().sum() > 0:
            fail(f"eps_update_f64 ({where}) is zero")
        passes = bk.BlockPasses(bed, rows_all, mave_p, msig_p, na)
        passes.cdot(bm, e)
        target = torch.zeros_like(e)
        passes.update_(bm, d_all, target)
        if not (torch.equal(passes.c[bm], c) and torch.equal(target, u)):
            fail(f"BlockPasses at float64 ({mask_name(na)}): the sweep "
                 f"interface and the one-block wrappers differ")
    e = (eps * na_shared).contiguous()
    target = torch.zeros_like(e)
    c_ms = cuda_ms(lambda: passes.cdot(bm, e), 200)
    u_ms = cuda_ms(lambda: passes.update_(bm, d_all, target), 200)
    c_plain = cuda_ms(lambda: bk.block_cdot_plain(
        bed, rows, e, mave_p[bm], msig_p[bm]), 20)
    u_plain = cuda_ms(lambda: bk.block_eps_update_plain_(
        bed, rows, d_all[bm], mave_p[bm], na_shared, target), 20)
    pa, pb = decode_planes(bed[rows.long()], f64)
    ab = torch.cat([pa, pb]).reshape(2 * B, -1)
    e2 = e.reshape(T, -1)
    dd = torch.cat([d_all[bm], mave_p[bm] * d_all[bm]], dim=1)
    lib_c = cuda_ms(lambda: e2 @ ab.T, 200)
    lib_u = cuda_ms(lambda: dd @ ab, 200)
    del pa, pb, ab
    plane, tb = T * 4 * MB * 8, T * B * 8
    blk = B * MB + B * 4
    block_ops = 4 * T * B * 4 * MB
    res["block_cdot_f64"] = (err_c, c_ms, c_plain, lib_c,
                             bound_of(blk + plane + 3 * tb,
                                      (block_ops, F64_OPS)))
    res["eps_update_f64"] = (err_u, u_ms, u_plain, lib_u,
                             bound_of(blk + 3 * plane + 2 * tb,
                                      (block_ops, F64_OPS)))

    # Kernel C on the sweep's (157, ..., B) float64 arrays and a block
    # index: a middle block and the last (its 96 pad slots), twice
    # (bit-equal), against serial_scan_plain on the card (a few blocks
    # only: about 10 ms a block), the one-block wrapper bit-equal to the
    # sweep interface.
    G = 3
    cva = torch.tensor([[0.0, 1e-3, 1e-2, 5e-2]] * G, device=dev, dtype=f64)
    cvai = torch.zeros_like(cva)
    cvai[:, 1:] = 1.0 / cva[:, 1:]
    sigmag = torch.rand((T, G), generator=gen, device=dev, dtype=f64) * 0.4
    sigmag += 0.1
    sigmag[0, 1] = 0.0                                   # an adaV group
    sigmae = torch.rand((T,), generator=gen, device=dev, dtype=f64) * 0.4
    sigmae += 0.5
    pi = torch.rand((T, G, K), generator=gen, device=dev, dtype=f64) + 0.1
    pi = pi / pi.sum(-1, keepdim=True)
    nonas = torch.full((T,), 490.0, device=dev, dtype=f64)
    lc_t, rd_t, sqb_t = sk.build_sweep_tables(sigmag, sigmae, pi, cva, cvai,
                                              nonas, 500.0, dtype=f64)
    grp_n = torch.randint(0, G, (nblocks, B), generator=gen, device=dev)
    valid_n = rows_all < MT
    live_n, zerob_n = (x.movedim(0, 1).contiguous()
                       for x in sw.scan_masks(grp_n, valid_n, sigmag))

    def blocks_of(tab):                       # (K, T, G) -> (nb, K, T, B)
        return tab[:, :, grp_n].movedim(2, 0).contiguous()

    xg = torch.randn((nblocks, B, 600), generator=gen, device=dev, dtype=f64)
    gs_n = torch.bmm(xg, xg.transpose(1, 2))[:, None].expand(
        nblocks, T, B, B).contiguous()
    del xg
    c_n = torch.randn((nblocks, T, B), generator=gen, device=dev,
                      dtype=f64) * 30.0
    nm1 = nonas - 1.0
    i2se = (1.0 / (2.0 * sigmae)).contiguous()

    def rnd(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=f64)
    ops = (nm1, blocks_of(lc_t), blocks_of(rd_t), blocks_of(sqb_t),
           torch.randn((nblocks, T, B), generator=gen, device=dev,
                       dtype=f64) * 0.05,
           torch.randint(0, K, (nblocks, T, B), generator=gen, device=dev,
                         dtype=torch.int32),
           rnd(nblocks, T, B), rnd(nblocks, T, B),
           torch.randn((nblocks, T, B), generator=gen, device=dev,
                       dtype=f64), live_n, zerob_n,
           rnd(nblocks, T, B) + 0.5, i2se)
    sweep = sk6.SerialScanSweep(*ops)

    def plain_block(b):
        base = (c_n[b] + ops[4][b] * nm1[:, None]).contiguous()
        return (base, *(x[b] for x in ops[1:4]), gs_n[b],
                *(x[b] for x in ops[4:11]), i2se)

    def guarded_steps(b, c, dbeta):
        """Live steps of block b where some |L_k - L_i| > 700, the base of
        each step rebuilt from the plain version's dbeta."""
        base = c[b] + ops[4][b] * nm1[:, None]
        num = base + (dbeta[:, :, None] * torch.triu(gs_n[b], 1)).sum(1)
        logl = ops[1][b] + ops[2][b] * num * (num * i2se[:, None])
        spread = logl.max(0).values - logl.min(0).values
        return int(((spread > 700.0) & (live_n[b] != 0)).sum())

    # |base| of order 30, then of order 1e3, where the 700 guards fire.
    err_s, drawn, guarded = 0.0, set(), 0
    c_big = c_n * 40.0
    for c_in, b in ((c_n, bm), (c_n, nblocks - 1), (c_big, bm),
                    (c_big, nblocks - 1)):
        where = f"block {b}, |c| ~{'1e3' if c_in is c_big else '30'}"

        def step(b=b, c_in=c_in):
            sweep.step(b, c_in, gs_n, b, bc=b)
            return tuple(x[b].clone() for x in (
                sweep.dbeta, sweep.beta_new, sweep.comp_new, sweep.acum_new,
                sweep.d))
        got = bit_equal_twice(f"serial_scan_f64 ({where})", step)
        base = (c_in[b] + ops[4][b] * nm1[:, None]).contiguous()
        want = sk6.serial_scan_plain(base, *plain_block(b)[1:])
        if not torch.equal(got[2], want[2]):
            fail(f"serial_scan_f64 ({where}): comp differs from the plain "
                 f"version in {int((got[2] != want[2]).sum())} entries")
        for part, g, w in zip(("dbeta", "beta", "acum"),
                              (got[0], got[1], got[3]),
                              (want[0], want[1], want[3])):
            err_s = max(err_s, close64(f"serial_scan_f64 ({where}) {part}",
                                       g, w))
        if not torch.equal(got[4], ops[11][b] * got[0]):
            fail("serial_scan_f64: d is not msig * dbeta bit for bit")
        drawn.update(want[2][live_n[b] != 0].tolist())
        if c_in is c_big:
            guarded += guarded_steps(b, c_in, want[0])
        elif b == bm:
            mid = got
    if not guarded:
        fail("serial_scan_f64: no step at |c| ~1e3 took the 700 guard")
    ms_of["serial_scan_f64"] = (f"{guarded} live steps of the two blocks "
                                f"at |c| ~1e3 took the 700 guard")
    if len(drawn) < 2:
        fail(f"serial_scan_f64: the blocks drew components {drawn} only")
    if not torch.equal(sweep.beta_new[-1][:, B - 96:], ops[4][-1][:, B - 96:]):
        fail("serial_scan_f64: the last block's pad slots moved")
    one = sk6.serial_scan(*plain_block(bm))
    if not all(torch.equal(x, y) for x, y in zip(one, mid)):
        fail("serial_scan_f64: the one-block wrapper and the sweep "
             "interface wrote different bits for the same block")
    plain_m = plain_block(bm)
    s_ms = cuda_ms(lambda: sweep.step(bm, c_n, gs_n, bm, bc=bm), 20)
    s_plain = cuda_ms(lambda: sk6.serial_scan_plain(*plain_m), 1)
    # The Gram entries i > j a block reads, its operands and results once.
    res["serial_scan_f64"] = (err_s, s_ms, s_plain, None, bound_of(
        T * B * (B - 1) // 2 * 8 + (3 * K + 10) * tb + T * 16, ))
    for name, (err, k_ms, p_ms, lib, bound) in res.items():
        print(f"# {name}: max abs err {err:.3e}; kernel ms {k_ms:.5f}, "
              f"plain ms {p_ms:.4f} (CUDA graph replay"
              f"{'; per block' if name == 'block_gram_f64' else ''}); "
              f"float64 torch.matmul yardstick on pre-decoded operands "
              f"{'n/a' if lib is None else f'{lib:.5f}'} ms; bound "
              f"{bound[0]:.5f} ms by {bound[1]}"
              f"{'; ' + ms_of[name] if name in ms_of else ''}  [{card}]",
              flush=True)
    return res


def float64_phase(sim, small, dev, tmp, card, gen):
    """Phase 7: --dtype float64 (the W=1 path on kernels A-D).  (a) the
    kernels alone (``float64_kernel_phase``); (b) one float64 sweep on the
    small panel (auto plan W=1) on the card against the plain float64
    sweep on the host CPU, same order and draws; (c) run_training at the
    anchor, twice from one seed (byte-equal), launches per ``f64_counts``
    and no float32 kernel, h2 in (0.05, 0.95), peak memory, ms/iteration,
    and a profiler window over 5 float64 iterations; (d) the chain cut at 5 (a checkpoint at 3) and resumed to the end,
    byte-equal; (e) one S=2 sharded float64 sweep on the small panel
    against the plain one on the host CPU; (f) run_training_sharded at
    S=2, and the same inside a one-rank NCCL group, byte-equal; (g) the
    predict kernel (kernel D) against its plain version at the anchor's
    bed, and run_predict at float64 on (c)'s .bet files on the card and on
    the CPU.  Returns (the kernels' rows, the main path's launches, the
    phase's numbers)."""
    import shutil
    import numpy as np
    import torch
    import torch.distributed as dist
    from gmrm_tpu_torch.config import Options
    from gmrm_tpu_torch.io.bed import read_bed
    from gmrm_tpu_torch.io.phen import read_phen
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.ops.predict_sums import (
        padded_chunk, pitch_of, predict_sums_plain,
    )
    from gmrm_tpu_torch.predict import run_predict
    from gmrm_tpu_torch.runner import run_training

    t_phase = time.perf_counter()
    rows = float64_kernel_phase(dev, gen, card)
    sweep_gate(small, dev, None, "float64 W=1 sweep gate", card,
               dtype="float64")
    nblocks = -(-MT // B)
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    runs = [training_phase(sim, dev, tmp, 1, ITERS_F64, dtype="float64",
                           tag=tag) for tag in ("", "_again")]
    res, counts, steady, h2, peak = runs[0]
    add(counts)
    add(runs[1][1])
    f32_kernels = {k for k, v in counts.items()
                   if v and not k.endswith("_f64")}
    if f32_kernels:
        fail(f"float64 training launched float32 kernels {f32_kernels}")
    if res.state.eps.dtype != torch.float64 or not (
            np.isfinite(h2).all() and (h2 > 0.05).all()
            and (h2 < 0.95).all()):
        fail(f"float64 training: dtype {res.state.eps.dtype}, h2 {h2}")
    ref = os.path.join(tmp, "out_w1_f64")
    if not same_artifacts(sim, ref, ref + "_again"):
        fail("float64 training: two runs of one seed wrote other bytes")
    prof = profile_phase(sim, dev, wave=1, dtype="float64")

    # (d) cut at 5 with a checkpoint at 3, resumed to the end.
    out = os.path.join(tmp, "resume_f64")
    for stop, resume in ((5, False), (ITERS_F64, True)):
        opt = anchor_options(sim, out, None, stop, "float64")
        opt.checkpoint_every, opt.resume = 3, resume
        _, c = counted(lambda: run_training(opt, device=dev, verbose=False))
        want = f64_counts(nblocks, 1, sweeps=5 if not resume
                          else ITERS_F64 - 3)
        if c != want:
            fail(f"float64 resume: launches {c}, expected {want}")
        add(c)
    if not same_artifacts(sim, ref, out):
        fail("float64 resume: the resumed chain wrote other bytes than the "
             "uninterrupted one")

    # (e), (f): sharded.
    sharded_gate(small, dev, card, 2, None, "float64 sharded W=1 sweep gate",
                 dtype="float64")
    sh = {}
    for nccl in (False, True):
        sh[nccl] = sharded_training_phase(sim, dev, tmp, 2, None, ITERS_F64,
                                          nccl=nccl, dtype="float64")
        if not nccl:
            add(sh[nccl][1])
    if not same_artifacts(sim, sh[False][5], sh[True][5]):
        fail("float64 S=2: the run inside a one-rank NCCL group wrote other "
             "bytes than the run without a group")

    # (g) predict: kernel D alone, then the path on (c)'s .bet files.
    pitch = pitch_of((N + 3) // 4)
    bed_d = padded_chunk(read_bed(sim.bed, N, MT), 0, MT, dev)
    phens = [read_phen(p, N) for p in sim.phens]
    na_d, y_d = predict_planes(phens[0], dev, pitch, "float64")
    prow = predict_case("anchor, NT=1, float64", bed_d, na_d, y_d, N, card)
    keep = (torch.rand((4, pitch), generator=gen, device=dev,
                       dtype=torch.float64) > 0.02).to(torch.float64)
    p2 = predict_case("anchor, 2% NAs, float64", bed_d, na_d * keep,
                      y_d * keep, N, card)
    prow = dict(prow, err=max(prow["err"], p2["err"]))
    pruns = {}
    for key, device in (("card", dev), ("cpu", "cpu")):
        pout = os.path.join(tmp, f"predict_f64_{key}")
        os.makedirs(pout)
        for p in sim.phens:
            bet = os.path.splitext(os.path.basename(p))[0] + ".bet"
            shutil.copy(os.path.join(ref, bet), os.path.join(pout, bet))
        opt = Options(bed_file=sim.bed, dim_file=sim.dim,
                      phen_files=sim.phens, bim_file=sim.bim,
                      ref_bim_file=sim.bim, out_dir=pout, predict=True,
                      dtype="float64")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        split, c = counted(lambda: run_predict(opt, device=device,
                                               verbose=False))
        pruns[key] = (pout, time.perf_counter() - t0, split, c)
    if pruns["card"][3] != {"predict_sums_f64": T} or pruns["cpu"][3]:
        fail(f"float64 predict: launches {pruns['card'][3]} on the card, "
             f"{pruns['cpu'][3]} on the CPU")
    add(pruns["card"][3])
    for t, p in enumerate(sim.phens):
        name = os.path.splitext(os.path.basename(p))[0] + ".mlma"
        ids_k, f_k = mlma_fields(os.path.join(pruns["card"][0], name))
        ids_c, f_c = mlma_fields(os.path.join(pruns["cpu"][0], name))
        if ids_k != ids_c or len(ids_k) != MT:
            fail(f"float64 predict: ids or line count differ ({name})")
        na_t, y_t = predict_planes(phens[t], dev, pitch, "float64")
        xtx = predict_sums_plain(bed_d, na_t, y_t)[0].cpu().numpy()
        d = (PREDICT_F64_RTOL * predict_sums_plain(bed_d, na_t, y_t.abs())[1]
             .cpu().numpy() + PREDICT_F64_ATOL)
        y = phens[t].epsilon_padded()
        sigma = float(y @ y) / phens[t].nonas
        with np.errstate(divide="ignore", invalid="ignore"):
            dt = d / np.sqrt(sigma * xtx)
            tol = np.stack([d / xtx, dt, np.full_like(d, 1e-12), 0.8 * dt],
                           axis=1) + 2e-15
        live = ~np.isnan(f_c)
        if (np.isnan(f_k) != np.isnan(f_c)).any() or (
                np.abs(f_k - f_c)[live] > tol[live]).any():
            fail(f"float64 predict: {name} on the card and on the CPU "
                 f"disagree beyond the xty bound")
    del bed_d

    numbers = dict(steady=steady, h2=h2, peak=peak, profile=prof,
                   startup=res.startup_seconds, sharded=sh[False],
                   predict=pruns, seconds=time.perf_counter() - t_phase)
    rows["predict_sums_f64"] = (prow["err"], prow["ms"], prow["plain_ms"],
                                prow["mv_ms"], prow["bound"])
    return rows, launches, numbers


# Kernels A-D: source, the TPU kernel whose float64 side each is, and the
# JAX package's float64 route that it replaces.
F64_SOURCES = {
    "block_gram_f64": ("gmrm_tpu_torch/csrc/block_gram.cu",
                       "gmrm_tpu/ops/pallas_kernels.py:135",
                       "gmrm_tpu/ops/blockops.py:131"),
    "block_cdot_f64": ("gmrm_tpu_torch/csrc/passes_f64.cu",
                       "gmrm_tpu/ops/pallas_kernels.py:275",
                       "gmrm_tpu/ops/blockops.py:131"),
    "eps_update_f64": ("gmrm_tpu_torch/csrc/passes_f64.cu",
                       "gmrm_tpu/ops/pallas_kernels.py:352",
                       "gmrm_tpu/ops/blockops.py:141"),
    "serial_scan_f64": ("gmrm_tpu_torch/csrc/serial_scan_f64.cu",
                        "gmrm_tpu/ops/scan_kernel.py:61",
                        "gmrm_tpu/sampler/scan.py:33"),
    "predict_sums_f64": ("gmrm_tpu_torch/csrc/predict_sums.cu",
                         "gmrm_tpu/predict.py:43", "gmrm_tpu/predict.py:43"),
}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--training-only", type=int, default=0,
                        metavar="REPS")
    parser.add_argument("--sweep-only", type=int, default=0,
                        metavar="REPS")
    parser.add_argument("--sharded-only", type=int, default=0,
                        metavar="REPS")
    parser.add_argument("--same-bytes", default="", metavar="TREE")
    parser.add_argument("--f32-chains", nargs=2, metavar=("SIM", "OUT"))
    parser.add_argument("--repo", default=REPO)
    args = parser.parse_args()
    t_start = time.perf_counter()
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
    if args.f32_chains:
        f32_chains(*args.f32_chains, card, args.repo)
        return
    if args.same_bytes:
        same_bytes(args.same_bytes, card)
        if not (args.training_only or args.sharded_only):
            return
    if args.training_only or args.sharded_only:
        _build.library()
        if args.training_only:
            training_only(dev, args.training_only, card, args.repo)
        if args.sharded_only:
            sharded_only(dev, args.sharded_only, card, args.repo)
        return
    if args.sweep_only:
        _build.library()
        gen = torch.Generator(device=dev)
        gen.manual_seed(20261016)
        for rep in range(args.sweep_only):
            (err, t_k, _, _, _), _, splits = sweep_kernel_phase(
                dev, gen, full=False)
            print(f"# {args.repo}: sweep_blocks run {rep + 1}: ms per sweep "
                  f"{t_k} (NT=1, NT={T}), max abs err {err:.3e}  [{card}]",
                  flush=True)
            for split in splits:
                print(f"# {args.repo}: sweep_blocks stamps, {split}  "
                      f"[{card}]", flush=True)
        return

    # The three datasets are simulated by worker processes, one thread each,
    # while the kernels build and phase 2 runs.
    datasets = (("data", anchor_dataset), ("small", small_dataset),
                ("big", big_dataset))
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ProcessPoolExecutor(
                len(datasets),
                mp_context=multiprocessing.get_context("spawn"),
                initializer=one_thread) as pool:
        sims = [pool.submit(make, os.path.join(tmp, name))
                for name, make in datasets]
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
        for name, (err, t_k, t_p, t_call, bound, note) in kernels.items():
            print(f"# {name}: max abs err {err:.3e}; kernel ms {t_k}, plain ms "
                  f"{t_p} (CUDA graph replay); kernel ms per eager call "
                  f"{t_call}; bound {bound[0]:.5f} ms by {bound[1]}"
                  f"{'; ' + note if note else ''}  [{card}]", flush=True)
        print(f"# block_cdot, eps_update beside their earlier design (a CTA "
              f"per marker row; a thread per plane and byte column): "
              f"{EARLIER_PASSES_MS} ms per launch as recorded in PERF.md on "
              f"an NVIDIA H100 80GB HBM3 at 700 W; this run "
              f"{ {k: [round(x, 4) for x in kernels[k][1]] for k in PASSES} }"
              f" (update_cdot: one launch for both)", flush=True)
        (err, t_k, t_p, t_c, bound), plan, splits = sweep_kernel_phase(
            dev, gen)
        kernels["sweep_blocks"] = (err, t_k, t_p, None, bound)
        nbl = -(-MT // B)
        chain = (nbl * kernels["wave_scan"][1][0]
                 + (nbl - 1) * kernels["update_cdot"][1][0]
                 + kernels["block_cdot"][1][0] + kernels["eps_update"][1][0])
        print(f"# sweep_blocks, one sweep of {-(-MT // B)} blocks at NT=1 and "
              f"NT={T}: comp and cass equal to the plain version, max abs err of "
              f"beta and eps {err:.3e}; kernel ms per sweep {t_k}, plain ms "
              f"{t_p}, composed chain (kernels 2+3+4 and their torch glue) ms "
              f"{t_c}, all by CUDA events around eager calls (a cooperative "
              f"launch; one launch is a whole sweep); the composed kernels "
              f"alone by graph replay (c-dot, {nbl} wave scans, {nbl - 1} "
              f"fused updates and c-dots, update): {chain:.3f} ms per "
              f"sweep; bound "
              f"{bound[0]:.5f} ms by {bound[1]}; grid {plan['grid']} CTAs x "
              f"{plan['cols']} byte columns, eps {plan['eps_bytes_per_cta']} "
              f"bytes per CTA, resident in shared memory: "
              f"{', '.join(plan['resident'])}  [{card}]", flush=True)
        for split in splits:
            print(f"# sweep_blocks stamps, {split}  [{card}]", flush=True)
        print(f"# sweep_blocks beside its earlier design (three grid syncs "
              f"a block): {EARLIER_SWEEP_MS} ms per sweep at "
              f"NT=1, NT={T} as recorded in PERF.md on an NVIDIA H100 80GB "
              f"HBM3 at 700 W; this run {[round(x, 3) for x in t_k]}.  To "
              f"time both in one call: --sweep-only N --repo PARENT_TREE",
              flush=True)

        err, bs = block_sweep_phase(dev, gen)
        wide = {mb: block_sweep_phase(dev, gen, mb, STEP_MT, (shared,))
                for mb, shared in WIDE_BLOCK_STEPS}
        rows9 = [(MB, k, r) for k, r in bs.items()]
        rows9 += [(mb, k, r) for mb, (_, res) in wide.items()
                  for k, r in res.items()]
        for mb, (n_sh, nt), r in sorted(rows9, key=lambda x: x[:2]):
            plan = r["plan"]
            print(f"# block_sweep, one block step of S_loc={n_sh} shards, "
                  f"NT={nt}, mb_pad={mb}: kernel ms per step "
                  f"{r['ms']:.5f} (CUDA graph replay), {r['eager_ms']:.5f} "
                  f"per eager step, host {r['host_us']:.1f} us per step; "
                  f"plain ms {r['plain_ms']:.4f}; torch.matmul yardstick "
                  f"(c-dot and delta of {n_sh} block(s), pre-decoded f32) "
                  f"{r['matmul_ms']:.5f} ms; bound {r['bound'][0]:.5f} ms "
                  f"by {r['bound'][1]}; {plan['cap']} shard(s) a launch, "
                  f"grid {plan['column_ctas'] + min(n_sh, plan['cap'])} "
                  f"CTAs ({plan['column_ctas']} column CTAs of "
                  f"{plan['span']} byte columns in {plan['tiles']} tile(s) "
                  f"of {plan['cols']}), {plan['smem_bytes']} bytes of "
                  f"shared memory, resident: "
                  f"{', '.join(plan['resident']) or 'nothing extra'}  "
                  f"[{card}]", flush=True)
            print(f"# block_sweep stamps, S_loc={n_sh}, NT={nt}, mb_pad={mb}"
                  f": {r['split']}  [{card}]", flush=True)
        err = max([err] + [e for e, _ in wide.values()])
        print(f"# block_sweep: comp equal to the plain version, every "
              f"element of the sum written, max abs err of the sum and beta "
              f"{err:.3e}; two launches, out mode + add against in place, "
              f"one shard a launch against one launch, the block's slices "
              f"against the whole arrays: bit-equal.  Beside its earlier "
              f"design (one launch per shard and step): "
              f"{EARLIER_BLOCK_SWEEP_MS} ms per launch of one shard's block "
              f"(NT=1, NT={T}) and per eager wrapper call, as recorded in "
              f"PERF.md on an NVIDIA H100 80GB HBM3 at 700 W.  To time both "
              f"in one call, the wide panels too: --sharded-only N --repo "
              f"PARENT_TREE", flush=True)
        # The row: two local shards at NT=1, the cadence of phase 4d's S=2.
        r = bs[(2, 1)]
        kernels["block_sweep"] = (err, [r["ms"]], [r["plain_ms"]],
                                  [r["eager_ms"]], r["bound"])

        t0 = time.perf_counter()
        sim, small, big = (f.result() for f in sims)
        print(f"# anchor, small and large-N datasets: waited "
              f"{time.perf_counter() - t0:.1f} s more for the worker "
              f"processes", flush=True)
        cache_bytes = sweep_gate(sim, dev, W, "sweep gate", card)
        sweep_gate(small, dev, None, "W=1 sweep gate", card)
        sweep_gate(big, dev, W, "large-N sweep gate", card,
                   against="composed")
        runs = {w: training_phase(sim, dev, tmp, w, iters)
                for w, iters in ((W, ITERS), (1, ITERS_SERIAL))}
        gated = eager_gate(sim, dev, runs[W][0])
        predict_row, predict_runs, predict_worst = predict_phase(
            sim, big, dev, tmp, card)
        composed_launches, composed_s = composed_phase(sim, dev)
        busy_ms, wall_ms, n_launch, top = profile_phase(sim, dev)
        w1_prof = profile_phase(sim, dev, wave=1)
        composed_prof = profile_phase(sim, dev, composed=True)
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
        resume_launches = resume_phase(sim, dev, tmp, card)
        sh_prof = profile_phase(sim, dev, n_shards=s0)
        f64_rows, f64_launches, f64 = float64_phase(sim, small, dev, tmp,
                                                    card, gen)
    torch.cuda.synchronize()
    for w, (res, launches, steady, h2, peak) in runs.items():
        startup = ("load + stats + Gram cache of "
                   f"{cache_bytes / 2**20:.1f} MiB" if w > 1
                   else "load + stats")
        print(f"# training W={w}: startup {res.startup_seconds:.2f} s "
              f"({startup}); steady {steady * 1e3:.2f} ms/iteration = "
              f"{MT / steady:.0f} markers/s over iterations {THIN + 1}-"
              f"{res.iters_run}; chain {res.chain_seconds:.2f} s for "
              f"{res.iters_run} iterations; h2 "
              f"{[round(float(x), 3) for x in h2]}; launches {launches}; "
              f"peak device memory {peak / 2**20:.1f} MiB  [{card}]",
              flush=True)
    print(f"# training W={W}: the state after {ITERS} iterations ("
          f"{', '.join(gated)}) is bit-equal to {ITERS} eager "
          f"gibbs_iteration calls from the same start and seed  [{card}]",
          flush=True)
    where = {"card": "the card (run_predict)",
             "cli": "the card (python -m gmrm_tpu_torch --predict)",
             "cpu": "the CPU (run_predict, plain version)"}
    for key, (_, wall, split, launches) in predict_runs.items():
        parts = " = " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        print(f"# predict at the anchor on {where[key]} ({T} traits on "
              f"phase 4's W={W} .bet files): wall {wall:.3f} s"
              f"{parts if split else ''}; {wall / T:.3f} s a trait; launches "
              f"{ {k: v for k, v in launches.items() if v} }  [{card}]",
              flush=True)
    print(f"# predict: the card's .mlma bytes equal across the two runs; "
          f"equal ids, mglo, rmglo and line count to the CPU's, and beta, "
          f"t, se, p within the xty bound (max |d| "
          f"{', '.join(f'{x:.3e}' for x in predict_worst)})  [{card}]",
          flush=True)
    print(f"# composed wave path (megakernel=False), W={W}: "
          f"{composed_s * 1e3:.2f} ms/iteration = {MT / composed_s:.0f} "
          f"markers/s over iterations 2-{ITERS_COMPOSED}, each ended by a "
          f"synchronize; launches {composed_launches}  [{card}]", flush=True)
    print(f"# profiler, whole-sweep path (as run_training runs it: two CUDA "
          f"graphs around the eager sweep launch), 5 iterations: device busy "
          f"{busy_ms:.3f} ms/iteration, wall {wall_ms:.3f} ms/iteration, "
          f"idle share {1 - busy_ms / wall_ms:.3f}, {n_launch:.1f} "
          f"host-issued launches and graph replays per iteration; busiest "
          f"kernels (ms/iteration) {top}  [{card}]", flush=True)

    busy_1, wall_1, launch_1, top_1 = w1_prof
    print(f"# profiler, W=1 path, 5 iterations: device busy {busy_1:.3f} "
          f"ms/iteration, wall {wall_1:.3f} ms/iteration, idle share "
          f"{1 - busy_1 / wall_1:.3f}, {launch_1:.1f} launches per iteration; "
          f"busiest kernels (ms/iteration) {top_1}  [{card}]", flush=True)

    busy_c, wall_c, launch_c, top_c = composed_prof
    print(f"# profiler, composed path (megakernel=False), W={W}, 5 "
          f"iterations: device busy {busy_c:.3f} ms/iteration, wall "
          f"{wall_c:.3f} ms/iteration, idle share {1 - busy_c / wall_c:.3f}, "
          f"{launch_c:.1f} launches per iteration; busiest kernels "
          f"(ms/iteration) {top_c}  [{card}]", flush=True)

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
    # whole-sweep and W=1 training runs, the composed iterations, the
    # sharded training runs without a process group and phase 4f's runs).
    # library_ms: no single PyTorch call computes any of these functions
    # (each fuses the 2-bit decode with a product, or is a serial scan).
    rows = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": (sum(r[1][name] for r in runs.values())
                          + composed_launches[name]
                          + sum(r[1][name] for (_, nccl), r
                                in sharded.items() if not nccl)
                          + resume_launches.get(name, 0)),
             "max_abs_err": kernels[name][0],
             "ms": kernels[name][1][0], "plain_ms": kernels[name][2][0],
             "bound_ms": kernels[name][4][0], "bound_by": kernels[name][4][1],
             "library_ms": None,
             **({"also_replaces": ALSO_REPLACES[name]}
                if name in ALSO_REPLACES else {})}
            for name, (src, rep) in SOURCES.items()]
    # Predict's sums (not a TPU kernel: gmrm_tpu/predict.py:43 is an XLA
    # scan), launched by the predict path; library_ms is torch.mv on the
    # pre-decoded operands, the xty half.
    rows.append({"name": "predict_sums", "route": "cuda",
                 "source": "gmrm_tpu_torch/csrc/predict_sums.cu",
                 "replaces": "gmrm_tpu/predict.py:43",
                 "launches": predict_runs["card"][3]["predict_sums"],
                 "max_abs_err": predict_row["err"], "ms": predict_row["ms"],
                 "plain_ms": predict_row["plain_ms"],
                 "bound_ms": predict_row["bound"][0],
                 "bound_by": predict_row["bound"][1],
                 "library_ms": predict_row["mv_ms"]})
    # Phase 7: the float64 path; launches from its runs (training twice,
    # the cut and resumed chain, S=2 without a group, predict on the card).
    res_sh, launch_sh, steady_sh, span_sh, h2_sh, _ = f64["sharded"]
    busy_f, wall_f, launch_f, top_f = f64["profile"]
    print(f"# profiler, float64 W=1 path, 5 iterations: device busy "
          f"{busy_f:.3f} ms/iteration, wall {wall_f:.3f} ms/iteration, idle "
          f"share {1 - busy_f / wall_f:.3f}, {launch_f:.1f} launches per "
          f"iteration; busiest kernels (ms/iteration) {top_f}  [{card}]",
          flush=True)
    print(f"# float64 training W=1 (auto plan) at the anchor: startup "
          f"{f64['startup']:.2f} s; steady {f64['steady'] * 1e3:.2f} "
          f"ms/iteration = {MT / f64['steady']:.0f} markers/s over iterations "
          f"{THIN + 1}-{ITERS_F64}; h2 "
          f"{[round(float(x), 3) for x in f64['h2']]}; peak device memory "
          f"{f64['peak'] / 2**20:.1f} MiB; two runs of one seed and the "
          f"chain cut at 5 and resumed byte-equal; no float32 kernel "
          f"launched  [{card}]", flush=True)
    print(f"# float64 sharded training S=2 (W=1, all shards on the one "
          f"card): {steady_sh * 1e3:.2f} ms/iteration over {span_sh}; h2 "
          f"{[round(float(x), 3) for x in h2_sh]}; launches {launch_sh}; "
          f"byte-equal inside a one-rank NCCL group  [{card}]", flush=True)
    for key, (_, wall, split, launches) in f64["predict"].items():
        parts = ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        print(f"# float64 predict at the anchor on the {key} ({T} traits, "
              f"the float64 run's .bet files): wall {wall:.3f} s = {parts}; "
              f"launches {launches}  [{card}]", flush=True)
    print(f"# phase 7 (float64) wall {f64['seconds']:.1f} s; launches "
          f"{f64_launches}", flush=True)
    for name, (src, rep, route) in F64_SOURCES.items():
        err, k_ms, p_ms, lib, bound = f64_rows[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "float64_route": route,
                     "launches": f64_launches.get(name, 0),
                     "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": lib})
    print(f"# the whole run: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
