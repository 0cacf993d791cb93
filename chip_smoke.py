#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (gmrm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. build the host I/O library (csrc/io_native.cpp, the host compiler, no
   nvcc), then the CUDA kernels of gmrm_tpu_torch/csrc with nvcc (sm_90a),
   one nvcc per source, all started together; meanwhile worker processes
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
   (kernel 5) builds all 157 blocks in one launch at NT=1 and NT=4 (twice,
   bit-equal; its launch plan and one stamped launch: main loop against
   epilogue), then B=64, 192, 512, 203, 37, 1, mb=203 and mb_pad=25,088
   at NT=1 and NT=4 (GRAM_GATE_SHAPES), and one block
   alone; the serial scan (kernel 6) runs on the sweep's arrays
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
   the same again on four blocks of three wide panels, mb_pad=25,088
   (NT=4), 60,000 (NT=1) and the UK Biobank shard's 100,352 (NT=4), whose
   column passes run on the tensor cores (the launches counted under
   ``block_sweep_mma`` must be the launches there and none at the
   anchor); timed per launch by graph replay, per eager step and by the
   host's clock, beside a torch.matmul yardstick, with one stamped launch
   each;
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
3f. the wide regime (seeded operands at N=400,000, mb_pad=100,352, 32
   blocks, per-trait NA masks: each column CTA streams its bed slice from
   global memory): one sweep through the whole-sweep kernel against the
   composed kernels on the card, same order and draws (comp and cass equal
   but for ties, max|dbeta| and max|deps| within 1e-4), its plan (the
   column passes' design) and its ms per sweep with one stamped launch;
   then, held the same way and not timed, the shapes that take the other
   branches of the tensor-core passes: T=8 with NT=8, T=1, and W=64;
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
   csrc/block_gram.cu's float64 scaling, the column-slice passes of
   csrc/block_passes.cuh at double (the c-dot, the update and the fused
   update + next c-dot), csrc/serial_scan.cu at double,
   csrc/predict_sums.cu's float64 kernel): each against its float64 plain
   version at the anchor's shapes (A bit-equal, all 157 blocks in one
   launch at NT=1 and NT=4 and at GRAM_GATE_SHAPES, each twice; B, C
   within 1e-10 of the
   largest magnitude, C's comp exact and d bit-equal; D's xtx bit-equal,
   xty within 1e-11 sum|val*y| + 1e-12, also at N=100,000 x 4,096 with
   NAs), timed by graph replay beside
   float64 torch.matmul / torch.mv yardsticks; B's three launches also
   twice (bit-equal), through BlockPasses (bit-equal to the one-block
   wrappers), with one stamped launch each and again at mb_pad=25,088;
   C twice (bit-equal) with per-trait Grams at the anchor and at shapes
   that take other plans and more CTAs (F64_SCAN_SHAPES), its one-block
   wrapper bit-equal to the sweep interface, one stamped launch, and its
   written-out reciprocal and exponential bit-equal to the IEEE division
   and the library's exp on 10^7 seeded x each and the edges
   (math_gate); one float64 sweep on
   the small panel against the plain float64 sweep on the host CPU;
   run_training at the anchor (W=1, 10 iterations) twice from one seed,
   byte-equal, with no float32 kernel launched, a profiler window over 5
   float64 iterations, and the chain cut at 5 and resumed,
   byte-equal; one S=2 sharded float64 sweep against the plain one;
   run_training_sharded at S=2, and inside a one-rank NCCL group,
   byte-equal; run_predict at float64 on the card and on the CPU;
   7h: float64 at W=32 (``--dtype float64 --wave-size 32``: the composed
   wave path on kernels A, B and E, csrc/wave_scan.cu at double): kernel
   E against its plain version at the anchor's 157-block arrays (NT=1 and
   NT=4, an adaV group, the last block's 96 pad slots, |c| ~30 and ~1e3)
   and at E_SHAPES and E_SHAPES_MORE (one trait a CTA with the tables and
   every wave's Gram rows staged at T=2, 8, 16 and 33; value-sized
   copies at B=36, W=6; K=16; B=256 with four of seven waves staged),
   comp exact, values within 1e-10 of the largest magnitude, twice
   bit-equal, and the anchor block through the raw entry point at two and
   three traits a CTA, the parent design's one CTA and one CTA with
   nothing staged (E_GATE_PLANS), each trait's bytes equal at every plan;
   timed by graph replay beside kernel 3 on the same block in float32,
   and per plan of E_TIMED_PLANS at T=4 and 16 alone, in sweep order
   against a rewritten Gram run and by one stamped launch (its chain in
   cycles); one float64 W=32 sweep on the small panel against the plain
   one on the host CPU, on one device and at S=2; run_training at the
   anchor twice (byte-equal, no Gram cache, no float32 kernel), a
   profiler window, the chain cut at 5 and resumed (byte-equal), and
   run_training_sharded at S=2.  ``--wave64-only`` runs phase 7h
   alone;
8. any number of traits (ops/trait_chunks.py): (a) sweep gates at T=16
   at the anchor's shapes (16 of 32 phenotypes simulated with seed
   171014, NT=1; 16 with 2% NAs, NT=16): W=32 (kernels 7/8 in two
   launches of 8) over the anchor's 157 blocks, and composed W=32, sharded
   S=2 at W=32 (kernel 9 in two launches a block step), W=1 and float64
   W=1 over 32 blocks of the anchor's N, B and traits (the small panel
   with 16 phenotypes, NT=1, or 16 of its 33, NT=16), each against its plain
   version on the host CPU (comp and cass equal, max|dbeta|, max|deps| <=
   1e-4, 1e-9 at float64), and at T=33 on the small panel (NT=33) at W=1
   (kernel 6 as a grid of trait groups) against the plain version and at
   W=32 bit-equal to the sweep of each trait chunk alone (the plain
   comparison printed beside it); kernels 7/8 at launch widths 5, 6 and 7
   against the plain sweep; (b) every chunked
   launch bit-equal to its kernel on that chunk's traits alone (kernels
   7/8 and 9 at 16 traits, NT=1 and NT=16; the passes at 48 traits, float32
   and float64; kernel 6 at 33 and kernel 3 at 48 traits, grids of trait
   groups); (c) kernels 1, 5 and A at T=16, NT=16, bit-equal; (d)
   run_training at T = 8, 16 and 32, W=32 and W=1, 10 iterations each:
   ms/iteration, launches an iteration (each kernel's count checked with
   its trait chunks) and peak device memory.  ``--traits-only REPS`` runs
   phase 8 alone (the timing runs REPS times).
9. the host I/O library (gmrm_tpu_torch/io/native.py) on every load path,
   against the readers' NumPy routes (``route="numpy"``): the anchor's bed
   (50 MB) and the large-N panel's (102 MB) read by both, byte-equal, best
   of 5 with a warm page cache (MB/s, host time); the anchor's phens parsed
   by both, bit-equal, none sent back to the NumPy route; load_data and
   load_data_process (S=2) timed by each route, equal arrays; run_training
   at W=32 and W=1, 5 iterations, by each route: byte-equal chains, the
   library's call counters non-zero on the native route and 0 on the
   other, kernels 1 and 7 (W=32) and 5, 6 and the passes (W=1) launched;
   run_predict on the W=32 chain by each route, byte-equal .mlma, its wall
   split.  ``--io-only`` runs phase 9 alone.
10. whole chains (``--chains-only`` runs it alone): (a) every training
   path for CHAIN_ITERS=3 whole iterations from one start, every random
   number scripted from a numpy seed (ChainScript: the order, u and z, the
   intercept's normal and one uniform a gamma variate, whose variate is
   gamma_quantile, held to scipy.special.gammaincinv first), with the
   kernels on the card (the default path through its CUDA graphs) and
   with the plain versions on the host CPU: W=32 default, composed W=32,
   W=1, S=2 at W=32 and W=1, float64 W=1 and W=32, NT=4 (four phenotypes
   with 2% NAs) and the anchor's bed with 300 annotation groups; comp,
   cass and m0 equal after every iteration, max|dbeta|, max|deps| <=
   1e-4 (1e-9 at float64), the hyperparameters within rtol 1e-4 (1e-10);
   each path's peak device memory; the paths whose plain versions loop
   over markers (W=1, S=2 W=1, float64) on the small panel; (b) the
   anchor-scale dataset of benchmarking/EQUIVALENCE.md regenerated with
   the port's simulator, its digest (phenotypes at float32) against the
   JAX package's, W=32 chains at three seeds and a W=1 control of 400
   iterations each, every trait's pooled h2 and sigmaE held to the
   compiled reference's rows by that file's criterion.
11. any number of mixture components (``--any-k-only`` runs it alone):
   (a) kernels 6, C, 3 and E against their plain versions on the card at
   K = 17 and 33 on the anchor's 157-block arrays and at K = 65 on the
   small panel's 32 blocks (a quarter of the draws past the 700 guard,
   per-trait Grams, each launch twice bit-equal), and kernel 6's one-CTA
   routes and kernel C's tables in global memory, comp exact but for a
   tie (TIE_ULPS), the rest within the phases' gates, each kernel's ms a
   block at K = 4, 17, 33 and 65 beside its plain version and bound;
   (b) kernels 7/8 and 9 through one sweep against the plain sweep on the
   host CPU (W=32 and S=2 at W=32, tie-aware) with a K-column .grm at
   K = 17 and 33 at the anchor and K = 65 on the small panel; (c) python
   -m gmrm_tpu_torch at the anchor with a 17-column .grm at W=32, W=1,
   S=2 and float64 W=1 and W=32, and on the small panel with a 65-column
   .grm at W=32 and W=1; (d) phase 10(a)'s W=32 default,
   composed, W=1, S=2 W=32 and float64 W=1 and W=32 paths with that .grm
   on the small panel;
   (e) run_training at the anchor at W=32 and W=1 at K = 4, 17 and 33,
   ms/iteration; and the ptxas registers, stack and spills of every
   instance that takes any K.

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
the tree's kernel records them, its stamps; and phase 3f.  ``--sharded-only REPS [--repo
TREE]`` runs phase 4d (2 and 4 shards) and the sharded profiler windows
(1, 2 and 4 shards) with the host's microseconds per block step of a
sharded sweep, and kernel 9's device time per block step of 1, 2 and 4
shards on phase 2's wide panels (a tree of the earlier design launches
once per shard); with ``--training-only`` in the same process.
``--f64-only REPS [--repo TREE]`` times kernels A and 5 (all 157 anchor
blocks a launch, NT=1 and NT=4, split by kernel name under the profiler
and, where the tree records them, by stamps; the widened gate in the
first rep) and D beside the float32 predict kernel on one bed (with the
int-to-float conversions in their SASS), holds kernel C against its plain
version (phase 7a's gate), then times kernel B's launches alone at the
anchor (NT=1, NT=4) beside their float64 torch.matmul yardsticks, kernel
C alone on a middle block (NT=1, NT=4, one stamped launch) and runs phase
7c's float64 W=1 training and a float64 profiler window, REPS times.
``--predict-only REPS [--repo TREE]`` times the float32 predict kernel
alone on a seeded anchor-shaped bed (2% NAs) and at N=100,000 x 4,096,
held to its plain version beside torch.mv, its launch's two kernels split
by the profiler, and, where the tree has the probe entry point, the
%globaltimer and cycle split of one stamped launch per CTA, with its SASS
counts.  ``--predict-pairs N --against TREE`` loads TREE's kernel library
beside this tree's and times the float32 predict kernel and D of both in
N alternating pairs in one process, on that seeded bed, the anchor
dataset's own bed and at N=100,000 (``predict_pairs``).
``--wave64-pairs N --against TREE`` (repeatable) builds csrc/wave_scan.cu
of this tree and of each TREE alone and times kernel E (where the tree
has it; this tree's also at two and three traits a CTA) and kernel 3, each
at its own tree's plan, in N alternating pairs in one process: E at the
anchor (NT=1, NT=4) and at T=16, a block alone and in sweep order against
a rewritten Gram run, kernel 3 alone, with one stamped launch of each
(``wave64_pairs``); with ``--wave64-only``, after phase 7h.
``--same-bytes TREE`` runs phase 4's and 4b's float32 chains and phase
7c's float64 W=1 chain in TREE and in this tree (TREE, this, this, TREE;
a process each) and requires equal ``.bet/.cpn/.csv`` bytes, and equal
bytes from the block Gram and predict sums kernels, float32 and float64,
and kernel 3 (float32), on seeded inputs; then every kernel instance of
TREE must have equal ptxas registers, stack frame and spills here.
"""

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import multiprocessing
import os
import re
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
# memory bytes/s, float32 outside the tensor cores, int8 tensor cores, and
# float64 at the card's peak, through its FP64 tensor cores (IEEE double,
# as cuBLAS runs the float64 yardsticks; 34 TFLOP/s outside them): the
# products a float64 kernel does could run there, so its bound counts them
# at that rate whether or not it uses them.
HBM_BPS, F32_OPS, INT8_OPS, F64_OPS = 3.35e12, 67e12, 1979e12, 67e12
ITERS_F64 = 10          # the float64 anchor run (phase 7)
IO_REPS, IO_ITERS = 5, 5   # phase 9: reads timed best of, iterations a chain
IO_THREADS = (1, 2, 4, 8, 16)   # phase 9: the pread's threads asked
# The phases of a stamped scan step that form its dependent chain (the
# others wait for the helper warps and hand the result over).
CHAIN_PHASES = ("L", "exp", "rcp", "comp", "dbeta")
# Kernels 6 and C: their chain bound, ms a block (scan_stamp_split), for
# the kernels line beside the bytes bound.
CHAIN_BOUND_MS = {}


def bound_of(nbytes, *ops_and_rates):
    """The least milliseconds the card could take: the larger of the bytes
    the function must move over the memory rate and its operations, each
    type over its peak rate.  Returns (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BPS
    t_ops = sum(ops / rate for ops, rate in ops_and_rates)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def pass_chunks(traits, es=4, mb=MB):
    """Launches of one pass (kernels 2, 4, the fused pass, B) at
    ``traits`` traits: one, or one a trait chunk where the traits' slices
    do not fit one launch (ops/trait_chunks.py)."""
    from gmrm_tpu_torch.ops.trait_chunks import trait_chunks
    return len(trait_chunks("passes", traits, B, mb=mb, es=es))


def sweep_chunks(traits, kernel="sweep_blocks"):
    """Launches of kernels 7/8 a sweep (or of kernel 9 a block step) at
    ``traits`` traits: one a chunk of at most 8."""
    from gmrm_tpu_torch.ops.trait_chunks import trait_chunks
    return len(trait_chunks(kernel, traits, B))


def serial_counts(nblocks, sweeps=1, shards=1, fused=True, traits=T,
                  mb=MB):
    """Launches of ``sweeps`` W=1 sweeps of ``shards`` shards of ``nblocks``
    blocks: kernel 6 once per block (its trait groups are one grid) and
    kernel 5 once per run of blocks under the Gram byte budget; on one
    device (``fused``) kernel 2 once for the first block, the fused pass
    once for each block but the last and kernel 4 once for the last, on a
    sharded run kernels 2 and 4 once per block; each pass once a trait
    chunk (``pass_chunks``)."""
    from gmrm_tpu_torch.ops.block_gram import gram_run_blocks
    runs = -(-nblocks // gram_run_blocks(traits, B, nblocks))
    per_sweep = ({"block_cdot": 1, "serial_scan": nblocks,
                  "update_cdot": nblocks - 1, "eps_update": 1} if fused
                 else dict.fromkeys(SERIAL_KERNELS, nblocks))
    pc = pass_chunks(traits, 4, mb)
    per_sweep = {k: v * (1 if k == "serial_scan" else pc)
                 for k, v in per_sweep.items()}
    per_sweep["block_gram"] = runs
    return {k: v * sweeps * shards for k, v in per_sweep.items() if v}


def f64_counts(nblocks, sweeps=1, shards=1, fused=True, traits=T, mb=MB,
               wave=1):
    """Launches of ``sweeps`` float64 sweeps of ``shards`` shards of
    ``nblocks`` blocks: the scan once per block (kernel C at W=1, kernel E
    at ``wave`` > 1), kernel A once per run of blocks under the Gram byte
    budget (8-byte entries); kernel B on one device (``fused``) as the
    c-dot of the first block, the fused pass for each block but the last
    and the update of the last, on a sharded run the c-dot and the update
    once per block each; B once a trait chunk."""
    from gmrm_tpu_torch.ops.block_gram import gram_run_blocks
    runs = -(-nblocks // gram_run_blocks(traits, B, nblocks, 8))
    per_sweep = ({"block_cdot_f64": 1, "update_cdot_f64": nblocks - 1,
                  "eps_update_f64": 1} if fused else
                 {"block_cdot_f64": nblocks, "eps_update_f64": nblocks})
    pc = pass_chunks(traits, 8, mb)
    per_sweep = {k: v * pc for k, v in per_sweep.items()}
    per_sweep["block_gram_f64"] = runs
    per_sweep["wave_scan_f64" if wave > 1 else "serial_scan_f64"] = nblocks
    return {k: v * sweeps * shards for k, v in per_sweep.items() if v}


def composed_counts(nblocks, sweeps=1, traits=T, mb=MB):
    """Launches of ``sweeps`` composed W>1 sweeps on one device: per sweep
    kernel 2 for the first block, kernel 3 per block (its trait groups are
    one grid), the fused update and next c-dot for every block but the
    last and kernel 4 for the last; each pass once a trait chunk."""
    pc = pass_chunks(traits, 4, mb)
    return {"block_cdot": sweeps * pc, "wave_scan": nblocks * sweeps,
            "update_cdot": (nblocks - 1) * sweeps * pc,
            "eps_update": sweeps * pc}


def fail(msg):
    print(f"FATAL: {msg}", file=sys.stderr)
    sys.exit(1)


def launch_counts():
    """The kernels' launches since the last reset (``_build
    .launch_counts``), without the counts of the launches of kernels 7/8
    and 9 that ran their column passes on the tensor cores (subsets of
    "sweep_blocks" and "block_sweep", which the plans pick by shape;
    phases 3f and 2 check them)."""
    from gmrm_tpu_torch.ops import _build
    counts = _build.launch_counts()
    for sub, kernel in (("sweep_blocks_mma", "sweep_blocks"),
                        ("block_sweep_mma", "block_sweep")):
        mma = counts.pop(sub, 0)
        if mma > counts[kernel]:
            fail(f"{mma} tensor-core launches of {kernel} out of "
                 f"{counts[kernel]}")
    return counts


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


def to_device(obj, dev, copy=False):
    """A state/static dataclass with every tensor moved to ``dev`` (copied
    even where it is there already, with ``copy``)."""
    import torch
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(dev, copy=copy)
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
                        d_all, errs, f64=False):
    """Phase 2 (and 7a with ``f64``): kernels 2 and 4 and the fused pass
    (kernel B's three at float64) through ``BlockPasses`` (the sweep's whole
    arrays and a block index) at a middle block and the last one, against
    the plain versions on those blocks' slices (``close64`` at float64); the
    fused pass updates with the block before and dots the block.  Each
    launched twice, bit-equal.  Returns the largest errors so far."""
    import torch
    sfx = "_f64" if f64 else ""

    def held(name, got, want):
        return (close64(name, got, want) if f64
                else close(name, got, want, 1e-5, 1e-5))
    errs = dict(errs)
    eps = eps * na
    nb = rows_all.shape[0]
    for b in (nb // 2, nb - 1):
        where = f"{mask_name(na)}, block {b} of the sweep's arrays"

        def cdot():
            passes.cdot(b, eps)
            return (passes.c[b].clone(),)
        got = bit_equal_twice(f"block_cdot{sfx} ({where})", cdot)[0]
        want = bk.block_cdot_plain(bed, rows_all[b], eps, mave_p[b],
                                   msig_p[b])
        errs["block_cdot"] = max(errs["block_cdot"], held(
            f"block_cdot{sfx} ({where})", got, want))

        def update():
            e = torch.zeros_like(eps)
            passes.update_(b, d_all, e)
            return (e,)
        got = bit_equal_twice(f"eps_update{sfx} ({where})", update)[0]
        want = bk.block_eps_update_plain_(bed, rows_all[b], d_all[b],
                                          mave_p[b], na,
                                          torch.zeros_like(eps))
        errs["eps_update"] = max(errs["eps_update"], held(
            f"eps_update{sfx} ({where})", got, want))
        if not got.abs().sum() > 0:
            fail(f"eps_update{sfx} ({where}) is zero")
        for start, what in ((torch.zeros_like(eps), "zero"), (eps, "random")):
            def fused():
                e = start.clone()
                passes.update_cdot_(b - 1, d_all, e)
                return e, passes.c[b].clone()
            got = bit_equal_twice(f"update_cdot{sfx} ({where})", fused)
            e = start.clone()
            want = (e, bk.block_update_cdot_plain_(
                bed, rows_all[b - 1], d_all[b - 1], mave_p[b - 1], na, e,
                rows_all[b], mave_p[b], msig_p[b]))
            for part, g, w in zip(("eps", "c"), got, want):
                errs["update_cdot"] = max(errs["update_cdot"], held(
                    f"update_cdot{sfx} ({where}, {what} residual) {part}",
                    g, w))
    return errs


def passes_big(bk, dev, gen, dtype=None):
    """Phase 2 (and 7a at float64): kernels 2 and 4 and the fused pass at
    the large-N panel's width (mb = 25,088) on a bed of 32 blocks with a
    per-trait mask: checked as ``passes_sweep_arrays`` does, then timed at
    a middle block by CUDA-graph replay beside their bounds and a
    torch.matmul yardstick on pre-decoded operands (the c-dot (T, 4mb) @
    (4mb, 2B), the update (T, 2B) @ (2B, 4mb), the fused pass both)."""
    import torch
    from gmrm_tpu_torch.ops.decode import decode_planes
    dtype = dtype or torch.float32
    f64 = dtype == torch.float64
    nb, mb = MT_BIG // B, N_BIG // 4 + 88        # 32 blocks, mb_pad 25,088
    bed = torch.randint(0, 256, (nb * B, mb), generator=gen, device=dev,
                        dtype=torch.uint8)
    bed[:, mb - 88:] = 0x55
    na = torch.ones((T, 4, mb), device=dev, dtype=dtype)
    na[:, :, mb - 88:] = 0
    na = na * (torch.rand((T, 4, mb), generator=gen, device=dev,
                          dtype=dtype) > 0.03)
    rows_all = torch.randperm(nb * B, generator=gen, device=dev).to(
        torch.int32).reshape(nb, B).contiguous()
    mave_p = torch.rand((nb, T, B), generator=gen, device=dev,
                        dtype=dtype) * 1.6 + 0.2
    msig_p = torch.rand((nb, T, B), generator=gen, device=dev,
                        dtype=dtype) * 1.5 + 0.5
    d_all = torch.randn((nb, T, B), generator=gen, device=dev,
                        dtype=dtype) * 0.01
    eps = torch.randn((T, 4, mb), generator=gen, device=dev,
                      dtype=dtype) * na
    passes = bk.BlockPasses(bed, rows_all, mave_p, msig_p, na)
    res = {"errs": passes_sweep_arrays(
        bk, passes, bed, rows_all, mave_p, msig_p, na, eps, d_all,
        dict.fromkeys(PASSES, 0.0), f64)}
    b, e1 = nb // 2, eps.clone()
    es = 8 if f64 else 4
    plane, tb, blk = T * 4 * mb * es, T * B * es, B * mb + B * 4
    ops = 4 * T * B * 4 * mb
    plan = bk.pass_plan(T, B, mb, es)
    pa, pb = decode_planes(bed[rows_all[b].long()], dtype)
    ab = torch.cat([pa, pb]).reshape(2 * B, -1)
    del pa, pb
    e2 = eps.reshape(T, -1)
    dd = torch.cat([d_all[b], mave_p[b] * d_all[b]], dim=1)
    for name, fn, nbytes, flops, lib in (
            ("block_cdot", lambda: passes.cdot(b, eps), blk + plane + 3 * tb,
             ops, lambda: e2 @ ab.T),
            ("eps_update", lambda: passes.update_(b, d_all, e1),
             blk + 3 * plane + 2 * tb, ops, lambda: dd @ ab),
            ("update_cdot", lambda: passes.update_cdot_(b, d_all, e1),
             2 * blk + 3 * plane + 5 * tb, 2 * ops,
             lambda: (dd @ ab, e2 @ ab.T))):
        ms = cuda_ms(fn, 100)
        bound = bound_of(nbytes, (flops, F64_OPS if f64 else F32_OPS))
        res[name] = (f"{ms:.4f} ms (NT={T}), bound {bound[0]:.5f} ms by "
                     f"{bound[1]}, torch.matmul yardstick "
                     f"{cuda_ms(lib, 100):.4f} ms, {plan.grid} CTAs x "
                     f"{plan.S} byte columns, {plan.groups} groups")
    del ab
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


# The block Gram's gate beyond the anchor (phases 2 and 7a), (B, mb,
# blocks): B of one band, of bands outside their tile (192) and of four
# tiles (512); odd B (scalar stores, a last column alone): 203 (a band's
# rows and a consumer group's columns past B), 37 (one band, one live
# group) and 1; rows not on 16 bytes (mb=203, the byte loads) and the
# large-N panel's mb_pad=25,088 (two segments of keep words); each at
# NT=1 and NT=4, the last block of each run partly pad slots (B=1: the
# last block is one).
GRAM_GATE_SHAPES = ((64, MB, 6), (192, MB, 4), (512, MB, 2), (B, 203, 5),
                    (B, MB_BIG, 3), (203, MB, 3), (37, 203, 4), (1, MB, 5))


def gram_case(dev, gen, Bv, mb, nb, dtype):
    """A run of ``nb`` blocks of ``Bv`` markers on a seeded bed of mb byte
    columns: the real markers shuffled, min(37, Bv - 1) pad rows (0x55)
    last (one at Bv = 1), so the last block ends with pad slots (mave =
    msig = 0 there); the last 7 byte columns 0x55 and unobserved; a
    shared (NT=1) and a per-trait (NT=4) float32 NA mask; mave, msig in
    ``dtype``."""
    import torch
    m_pad = nb * Bv
    m_real = m_pad - (1 if Bv == 1 else min(37, Bv - 1))
    bed = torch.randint(0, 256, (m_pad, mb), generator=gen, device=dev,
                        dtype=torch.uint8)
    bed[m_real:] = 0x55
    bed[:, mb - 7:] = 0x55
    na1 = torch.ones((1, 4, mb), device=dev)
    na1[:, :, mb - 7:] = 0
    na4 = (na1 * (torch.rand((T, 4, mb), generator=gen, device=dev)
                  > 0.03)).contiguous()
    rows = torch.cat([torch.randperm(m_real, generator=gen, device=dev),
                      torch.arange(m_real, m_pad, device=dev)]).to(
        torch.int32).reshape(nb, Bv).contiguous()
    real = (rows < m_real)[:, None, :]
    mave = ((torch.rand((nb, T, Bv), generator=gen, device=dev, dtype=dtype)
             * 1.6 + 0.2) * real).contiguous()
    msig = ((torch.rand((nb, T, Bv), generator=gen, device=dev, dtype=dtype)
             * 1.5 + 0.5) * real).contiguous()
    return bed, rows, na1, na4, mave, msig


def gram_plan_text(bg, Bv, nt, nb):
    """The plan ``blocks_gram_scaled`` launches on this card, as one
    line."""
    p = bg.device_gram_plan(Bv, nt, nb, 0)
    return (f"B={Bv} NT={nt} {nb} blocks: {p['bands']} bands x {p['tiles']} "
            f"tiles a block and mask, {p['items']} items on {p['grid']} CTAs"
            f" ({p['rounds']} rounds), {p['stages']} stages of "
            f"{p['panels']} panels, {p['smem']} B of shared memory")


def gram_gate(bg, dev, gen, dtype):
    """Kernel 5 (float32) or A (float64) at GRAM_GATE_SHAPES, NT=1 and
    NT=4: two launches bit-equal to each other and to the plain version.
    Returns the plans' lines."""
    import torch
    lines = []
    for Bv, mb, nb in GRAM_GATE_SHAPES:
        bed, rows, na1, na4, mave, msig = gram_case(dev, gen, Bv, mb, nb,
                                                    dtype)
        for na in (na1, na4):
            args = (bed, rows, na, mave, msig)
            what = f"block_gram {dtype} (B={Bv}, mb={mb}, NT={na.shape[0]})"
            got = bit_equal_twice(what, lambda: (
                bg.blocks_gram_scaled(*args),))[0]
            want = bg.blocks_gram_scaled_plain(*args)
            if got.dtype != dtype or not torch.equal(got, want):
                fail(f"{what}: gs is not bit-equal to its plain version "
                     f"(max abs err {max_err(got, want):.3e})")
            if not (got[-1 if Bv > 1 else -2].abs().sum() > 0
                    and (got[-1][:, -1] == 0).all()):
                fail(f"{what}: the last block's pad slots")
            lines.append(gram_plan_text(bg, Bv, na.shape[0], nb))
            del got, want
    return lines


def gram_stamp_split(bg, args):
    """One stamped launch of the block Gram on ``args``: per CTA the ns of
    its main loops and of its epilogues over its items; returns the means
    over the CTAs, the launch's span and the main loops' share."""
    import torch
    nb, _, Bv = args[3].shape
    plan = bg.device_gram_plan(Bv, args[2].shape[0], nb, args[0].device)
    stamps = torch.zeros((plan["grid"], bg.NSTAMP), dtype=torch.int64,
                         device=args[0].device)
    bg.blocks_gram_scaled(*args, stamps=stamps)
    torch.cuda.synchronize()
    st = stamps.cpu().double()
    span = (st[:, 3].max() - st[:, 0].min()) / 1e3
    loop, epi = st[:, 1].mean() / 1e3, st[:, 2].mean() / 1e3
    return (f"span {span:.1f} us; per CTA ({plan['rounds']} rounds of "
            f"items at most) main loops {loop:.1f} us, epilogues {epi:.1f} "
            f"us (max {st[:, 2].max() / 1e3:.1f}), main loops' share "
            f"{loop / (loop + epi):.3f}; consumers waited for full stages "
            f"{st[:, 4].mean() / 1e3:.1f} us, producers for empty ones "
            f"{st[:, 5].mean() / 1e3:.1f} us")


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
    # bit-equal, twice: all 157 blocks at NT=1 and NT=4 (one run each; pad
    # rows last, so the last block has pad slots), then GRAM_GATE_SHAPES;
    # then one block with its c (the public counterpart, nb = 1).
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
        nb = bg.gram_run_blocks(T, B, nblocks)
        if nb != nblocks:
            fail(f"block_gram: a run of {nb} blocks at NT={nt}")
        run = (rows_all, na_in, mave_p.contiguous(), msig_p.contiguous())
        got = bit_equal_twice(f"block_gram (NT={nt})", lambda: (
            bg.blocks_gram_scaled(bed, *run),))[0]
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
            f"products the function needs; plan "
            f"{gram_plan_text(bg, B, nt, nb)}; stamps "
            f"{gram_stamp_split(bg, (bed, *run))}")
    extra["gate"] = ("bit-equal twice at (B, mb, blocks) "
                     f"{GRAM_GATE_SHAPES}, NT=1 and NT={T}; plans: "
                     + " | ".join(gram_gate(bg, dev, gen, torch.float32)))
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
        if scale == 1.0:
            split6 = scan_stamp_split(sweep, c_1n, gs_s, 1, bc=0)
            CHAIN_BOUND_MS["serial_scan"] = split6["chain_ms"]
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
        f"step at the SM clock of {clk:.0f} MHz read after the run; stamps "
        f"(block 1, |base| ~30): {split6['text']}")
    # Of the Gram only the entries i > j are read, and updated with.
    bounds["serial_scan"] = bound_of(
        scan_bytes + 2 * tb + T * B * (B - 1) // 2 * f4,
        (T * B * (B - 1) + T * B * K * K * 4, F32_OPS))
    return {name: (err, *times[name], bounds[name], notes.get(name, ""))
            for name, err in out.items()}


def sweep_operands(dev, gen, shared, mb=MB, mt=MT, traits=T):
    """One sweep's operands at the anchor's shapes (or ``mb`` byte columns,
    ``mt`` markers and ``traits`` traits): 157 blocks of B=128 (the last
    with 96 pad slots), G=3 groups, one of them adaV for trait 0, a
    standardized residual and the statistics of a random bed whose last 60
    byte columns are pad."""
    T = traits
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


def stamp_split(sk, run, nblocks, mb=MB, nt=1):
    """Where a sweep's time goes: one launch with a stamp buffer, each CTA
    recording the global timer at the events of ``sk.SWEEP_STAMPS``; the
    mean microseconds between consecutive events over the inner blocks,
    for CTA 0 and averaged over the column CTAs, and the chain's segments
    (``sk.stamp_summary``; a tree without it reduces none)."""
    import torch
    if not hasattr(sk, "stamp_summary"):
        return "not reduced (the tree has no sweep_kernel.stamp_summary)"
    grid = sk.sweep_plan(T, B, mb, nt, K, W)["grid"]
    stamps = torch.zeros((grid, nblocks + 1, sk.NST), dtype=torch.int64,
                         device="cuda")
    run(stamps)
    torch.cuda.synchronize()
    s = sk.stamp_summary(stamps.cpu())
    parts = [f"{s['block_us']:.2f} us per block"]
    for role, key in (("CTA 0", "scan"), ("column CTAs", "column")):
        parts.append(f"{role}: " + ", ".join(
            f"{n} {x:.2f}" for n, x in s[key].items()))
    if hasattr(sk, "SWEEP_CHAIN"):
        parts.append("chain: " + ", ".join(
            f"{what} +{x:.2f}" for what, x in s["chain"].items()))
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


# The wide gate's panel: N = 400,000 (one card's share of a biobank, its
# mb_pad), 32 blocks, per-trait NA masks: the bed slice of a column CTA is
# streamed from global memory, eps and na stay in shared memory.
MB_WIDE, MT_WIDE = 100_352, 32 * B - 40


def wide_sweep_gate(dev, gen, card, reps=3, traits=T, wave=W):
    """Phase 3f: one sweep of the whole-sweep kernel at the wide panel
    (seeded operands, ``sweep_operands``; NT = T) against the composed
    kernels 2, 3 and 4 on the card, same order and draws: comp and cass
    equal but for ties (``tied_traits``: a trait whose comp differs must
    first differ within TIE_ULPS of its CDF boundary and is left out),
    max|dbeta| and max|deps| within 1e-4.  Prints the plan (its column
    passes where the tree reports them), the kernel's ms per sweep (CUDA
    events around ``reps`` eager launches) and one stamped launch's split;
    ``reps`` = 0: the gate alone.  ``traits`` traits with as many masks,
    waves of ``wave``.  Returns the ms per sweep (None untimed)."""
    import torch
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.ops import sweep_kernel as sk
    from gmrm_tpu_torch.sampler.gibbs import marker_sweep

    t_gate = time.perf_counter()
    T, W = traits, wave
    name = f"wide sweep gate (N={4 * MB_WIDE - 240}, NT={T})"
    static, st, blk, win, (u, z) = sweep_operands(dev, gen, False, MB_WIDE,
                                                  MT_WIDE, traits=T)
    nblocks = blk.numel()
    blocks = blk[:, None] * B + win
    eps = st["eps"].clone()
    plan = sk.sweep_plan(T, B, MB_WIDE, T, K, W)
    res, counts = {}, {}
    for key, mega in (("kernel", None), ("composed", False)):
        eps.copy_(st["eps"])
        _build.reset_launch_counts()
        res[key] = [x.cpu() for x in marker_sweep(
            eps, st["betas"], st["comp"], st["acum"], st["sigmag"],
            st["sigmae"], st["pi"], static, blocks, u, z, wave=W,
            megakernel=mega)]
        counts[key] = {k: v for k, v in _build.launch_counts().items() if v}
    # A tree that reports the passes' design counts the tensor-core launches.
    want = {"sweep_blocks": 1}
    if plan.get("passes") == "tensor cores":
        want["sweep_blocks_mma"] = 1
    if counts["kernel"] != want:
        fail(f"{name}: launches {counts}")
    tied, ties = tied_traits(
        name, [(res["kernel"][2], res["kernel"][3])],
        [(res["composed"][2], res["composed"][3])], [blocks.cpu()],
        [u.cpu().numpy()])
    keep = [t for t in range(T) if t not in tied]
    (ke, kb, kc, _, kcass), (pe, pb, pc, _, pcass) = (
        [x[keep] for x in res["kernel"]], [x[keep] for x in res["composed"]])
    db = float((kb - pb).abs().max())
    de = float((ke - pe).abs().max())
    print(f"# {name}, W={W}, {nblocks} blocks, mb_pad={MB_WIDE}: the "
          f"whole-sweep kernel against the composed kernels: comp "
          f"mismatches {int((kc != pc).sum())} of {kc.numel()}, cass equal "
          f"{torch.equal(kcass, pcass)}, max|dbeta| {db:.3e}, max|deps| "
          f"{de:.3e}; {'; '.join(ties) + ' (left out); ' if ties else ''}"
          f"column passes: {plan.get('passes', 'CUDA cores (not reported)')}"
          f"; {time.perf_counter() - t_gate:.1f} s", flush=True)
    if not torch.equal(kc, pc) or not torch.equal(kcass, pcass) or (
            db > 1e-4 or de > 1e-4):
        fail(f"{name}: the kernel disagrees with the composed kernels")
    if not reps:
        return None
    tables = sk.build_sweep_tables(st["sigmag"], st["sigmae"], st["pi"],
                                   static.cva, static.cvai, static.nonas,
                                   static.n_total)

    def run(stamps=None):
        eps.copy_(st["eps"])
        return sk.sweep_blocks(
            static.bed, blk.to(torch.int32), win.to(torch.int32).contiguous(),
            static.m_local, static.gram_cache, eps, static.na, static.mave,
            static.msig, st["betas"], st["comp"], st["acum"],
            static.group_of, u, z, st["sigmag"], *tables,
            1.0 / (2.0 * st["sigmae"]), static.nonas, wave=W, stamps=stamps)

    ms = call_ms(run, reps)
    split = stamp_split(sk, run, nblocks, MB_WIDE, T)
    print(f"# {name}: whole-sweep kernel grid {plan['grid']} CTAs x "
          f"{plan['cols']} byte columns, {plan['smem_bytes']} bytes of "
          f"shared memory, resident: {', '.join(plan['resident'])}; column "
          f"passes: {plan.get('passes', 'CUDA cores (not reported)')}; "
          f"{ms:.3f} ms per sweep ({ms / nblocks * 1e3:.1f} us a block; "
          f"CUDA events around eager calls); stamps: {split}  [{card}]",
          flush=True)
    return ms


def wide_sweep_branches(dev, gen, card):
    """Phase 3f's gate, untimed, at the shapes that take the other branches
    of the tensor-core passes: T=8 with NT=8 (a lane holds every part of
    two traits), T=1 (fewer traits than the instance's) and W=64 (two k
    steps a wave)."""
    for traits, wave in ((8, W), (1, W), (T, 64)):
        wide_sweep_gate(dev, gen, card, 0, traits, wave)


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
    from gmrm_tpu_torch.ops import _build
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
            # The column passes' design the plan reports, and the
            # launches that ran it.
            plan = sk.block_sweep_plan(T, B, mb, nt, K, W, n_sh)
            want_design = ("tensor cores" if mb == MB_WIDE
                           else "CUDA cores" if mb == MB else None)
            if want_design and plan.get("passes") != want_design:
                fail(f"{name}: the plan runs the column passes on the "
                     f"{plan.get('passes')}, not the {want_design}")
            before = _build.launch_counts()
            kernel(copied(shards), torch.empty_like(eps))
            after = _build.launch_counts()
            n_launch = after["block_sweep"] - before["block_sweep"]
            n_mma = (after["block_sweep_mma"] - before["block_sweep_mma"])
            if n_mma != (n_launch if plan["passes"] == "tensor cores"
                         else 0):
                fail(f"{name}: {n_mma} of {n_launch} launches counted on "
                     f"the tensor cores, the plan's passes "
                     f"{plan['passes']}")
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
# (N=100,000) at NT=4, N=240,000 at NT=1 and the UK Biobank shard's
# N=400,000 at NT=4, four blocks each, the last with 96 pad slots.
WIDE_BLOCK_STEPS = ((MB_BIG, False), (60_000, True), (MB_WIDE, False))
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


def anchor_options(sim, out_dir, wave=W, iterations=ITERS, dtype="float32",
                   phens=None):
    """``wave`` None lets the plan pick the wave, as a user's run does;
    ``phens`` trains a subset of the simulated phenotypes."""
    from gmrm_tpu_torch.config import Options
    opt = Options(bed_file=sim.bed, dim_file=sim.dim,
                  phen_files=list(phens or sim.phens),
                  group_index_file=sim.gri, group_mixture_file=sim.grm,
                  iterations=iterations, seed=42, out_dir=out_dir,
                  block_size=B, wave_size=wave, output_thin_rate=THIN,
                  dtype=dtype)
    opt.validate()
    opt.load_group_mixtures()
    return opt


def tied_traits(name, kern, plain, orders, us):
    """The traits whose comp differs between two float32 sweeps, each
    allowed only as a tie: per shard, (comp, acum) of the kernels and of
    the plain versions (T, slots), the order (nblocks, B) of the slots
    drawn and u (nblocks, T, B) in that order.  In such a trait the first
    differing draws (the earliest block step over the shards, each shard's
    first there: ``first_flip``) must have u within TIE_ULPS ulps of the
    nearer of the two CDF values drawn; the trait's chain differs from
    there on.  Returns (the tied traits, a line for each); fails
    otherwise."""
    import torch
    nT = kern[0][0].shape[0]
    tied, msgs = [], []
    for t in range(nT):
        firsts = []
        for s, ((kc, ka), (pc, pa), order, u) in enumerate(zip(
                kern, plain, orders, us)):
            o = order.reshape(-1).long()
            if bool((kc[t, o] != pc[t, o]).any()):
                u_nat = torch.empty_like(pa)
                u_nat[:, o] = torch.as_tensor(u).movedim(1, 0).reshape(
                    nT, -1).to(u_nat.dtype)
                flip = first_flip((None, None, kc, ka), (None, None, pc, pa),
                                  u_nat, o, t)
                firsts.append((flip[0] // order.shape[1], s, flip))
        if not firsts:
            continue
        step = min(f[0] for f in firsts)
        for st, s, (_, r, u, margin, ulps) in firsts:
            if st != step:
                continue
            msg = (f"trait {t}: comp differs first at block step {step}, "
                   f"shard {s}, slot {r} ({int(kern[s][0][t, r])} against "
                   f"{int(plain[s][0][t, r])}): u {u:.9g}, |u - cdf| "
                   f"{margin:.3e} = {ulps:.2f} ulps")
            if ulps > TIE_ULPS:
                fail(f"{name}: {msg}; more than {TIE_ULPS} ulps from its CDF "
                     f"boundary")
            msgs.append(msg)
        tied.append(t)
    if len(tied) == nT:
        fail(f"{name}: every trait tied")
    return tied, msgs


def sweep_gate(sim, dev, wave, name, card, against="plain",
               dtype="float32", phens=None, mega=None, timed=True,
               tie_aware=False):
    """Phases 3, 3b, 3c, 7b, 7h and 8a: one sweep through the default
    marker_sweep on the card (the whole-sweep kernel at W>1; at W=1
    kernels 5, 2, 6, the fused pass and 4, or at float64 kernels A, B and
    C, and A, B and E at float64 W>1 in a uniform order; with ``mega``
    False the composed kernels 2, 3, 4) against the plain
    versions on the host CPU or, with ``against`` "composed", against the
    composed kernels 2, 3, 4 on the card.  ``wave`` None is the auto plan,
    which must resolve to W=1.  ``phens``: a subset of the phenotypes (the
    launches counted with the kernels' trait chunks).  At float64 the draws
    are float64 and |dbeta|, |deps| are held to 1e-9 (1e-4 at float32).
    ``tie_aware`` (phase 11): a trait whose comp differs is allowed as a
    tie (``tied_traits``) and left out of the other comparisons.
    Returns the Gram cache's bytes."""
    import numpy as np
    import torch
    from gmrm_tpu_torch import runner
    from gmrm_tpu_torch.config import resolve_plan
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.ops.sweep_kernel import sweep_plan
    from gmrm_tpu_torch.sampler.gibbs import marker_sweep

    t_gate = time.perf_counter()
    opt = anchor_options(sim, "", wave, dtype=dtype, phens=phens)
    resolve_plan(opt, "cuda", sim.m)
    if (opt.wave_size > 1) != (wave is not None and wave > 1):
        fail(f"{name}: the plan resolved to W={opt.wave_size}")
    fdt = np.float64 if dtype == "float64" else np.float32
    nT = len(opt.phen_files)
    data = runner.load_data(opt)
    static = runner.build_static(data, opt, dev)
    state = runner.init_sampler_state(data, opt, dev)
    nblocks = data.m_pad // B
    rng = np.random.default_rng(7)
    if opt.wave_size > 1 and dtype == "float32":
        blocks = (rng.permutation(nblocks)[:, None] * B
                  + np.argsort(rng.uniform(size=(nblocks, B)), axis=1))
    else:
        blocks = np.concatenate([rng.permutation(data.m_local),
                                 np.arange(data.m_local, data.m_pad)])
    inj = [torch.from_numpy(a) for a in (
        blocks.reshape(nblocks, B),
        rng.uniform(size=(nblocks, nT, B)).astype(fdt),
        rng.normal(size=(nblocks, nT, B)).astype(fdt))]
    sigmae = 0.5 * (state.eps * state.eps).sum(dim=(1, 2)) / static.nonas
    if against == "plain":
        other = (torch.device("cpu"), to_device(state, "cpu"),
                 to_device(static, "cpu"), mega)
    else:
        other = (dev, state, static, False)
    res, counts = {}, {}
    for key, (d, st, sta, mg) in (("kernels", (dev, state, static, mega)),
                                  (against, other)):
        _build.reset_launch_counts()
        out = marker_sweep(
            st.eps.clone(), st.betas, st.comp, st.acum, st.sigmag,
            sigmae.to(d), st.pi_est, sta, *[x.to(d) for x in inj],
            wave=opt.wave_size, megakernel=mg)
        res[key] = [x.cpu() for x in out]
        counts[key] = {k: v for k, v in launch_counts().items() if v}
    nt = 1 if static.shared_na else nT
    mb = data.mb_pad
    want_counts = (
        composed_counts(nblocks, traits=nT, mb=mb) if mega is False
        else f64_counts(nblocks, traits=nT, mb=mb, wave=opt.wave_size)
        if dtype == "float64"
        else {"sweep_blocks": sweep_chunks(nT)} if opt.wave_size > 1
        else serial_counts(nblocks, traits=nT, mb=mb))
    if counts["kernels"] != want_counts or (
            against == "composed"
            and counts[against] != composed_counts(nblocks, traits=nT,
                                                   mb=mb)):
        fail(f"{name}: launches {counts}")
    ties = []
    if tie_aware:
        tied, ties = tied_traits(
            name, [(res["kernels"][2], res["kernels"][3])],
            [(res[against][2], res[against][3])], [inj[0]],
            [inj[1].numpy()])
        keep = [t for t in range(nT) if t not in tied]
        res = {k: [x[keep] for x in v] for k, v in res.items()}
    (ke, kb, kc, _, kcass), (pe, pb, pc, _, pcass) = (res["kernels"],
                                                      res[against])
    n_diff = int((kc != pc).sum())
    db = float((kb - pb).abs().max())
    de = float((ke - pe).abs().max())
    tol = 1e-9 if dtype == "float64" else 1e-4
    print(f"# {name} (T={nT}, W={opt.wave_size}, NT={nt}, {nblocks} "
          f"blocks, mb_pad={data.mb_pad}, {dtype}) against the {against} "
          f"sweep: comp mismatches {n_diff} of {kc.numel()}, cass equal "
          f"{torch.equal(kcass, pcass)}, max|dbeta| {db:.3e}, max|deps| "
          f"{de:.3e}; launches {counts['kernels']}; "
          f"{'; '.join(ties) + ' (left out); ' if ties else ''}"
          f"{time.perf_counter() - t_gate:.1f} s", flush=True)
    if n_diff or not torch.equal(kcass, pcass) or db > tol or de > tol:
        where = (kc != pc).nonzero()
        least = 0.0
        if n_diff:          # (tie_aware leaves no comp difference)
            u_nat = torch.empty_like(res[against][3])
            u_nat[:, inj[0].reshape(-1).long()] = inj[1].movedim(
                1, 0).reshape(nT, -1).to(u_nat.dtype)
            least = float(torch.minimum(
                (u_nat - res["kernels"][3]).abs(),
                (u_nat - res[against][3]).abs())[kc != pc].min())
        fail(f"{name}: the kernels disagree with the {against} sweep; comp "
             f"differs at (trait, slot) {where[:12].tolist()}; least margin "
             f"|u - acum| there {least:.3e}")
    if opt.wave_size > 1 and mega is None and timed and dtype == "float32":
        plan = sweep_plan(nT, B, data.mb_pad, nt, int(static.cva.shape[1]),
                         opt.wave_size)
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
    ``f64_counts``) kernels A, B and C, and A, B and E at W>1 (phase 7h).
    The other paths' kernels launch
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
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    nblocks = -(-MT // B)
    # The anchor has no phenotype NAs: NT = 1.
    path = (launches if not check_launches
            else f64_counts(nblocks, sweeps=iterations, wave=wave) if f64
            else {"gram_cache": 1, "sweep_blocks": iterations} if wave > 1
            else serial_counts(nblocks, sweeps=iterations))
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


def sharded_setup(sim, dev, n_shards, wave=W, dtype="float32", phens=None):
    """The per-shard static inputs, start states and RNG plans of ``sim``,
    as run_training_sharded builds them, every shard on ``dev``; ``wave``
    None is the auto plan."""
    from gmrm_tpu_torch.config import resolve_plan
    from gmrm_tpu_torch.parallel import runner as prunner
    from gmrm_tpu_torch.sampler.dists import RngPlan

    opt = anchor_options(sim, "", wave, dtype=dtype, phens=phens)
    resolve_plan(opt, "cuda", sim.m // n_shards)
    data = prunner.load_data_process(opt, n_shards,
                                     interleave=opt.wave_size > 1)
    return (opt, data, prunner.build_static_sharded(data, opt, dev),
            prunner.init_states_sharded(data, opt, dev),
            [RngPlan(opt.seed, dev, shard=i) for i in range(n_shards)])


def sharded_gate(sim, dev, card, n_shards, wave, name, dtype="float32",
                 phens=None, against="composed", tie_aware=False):
    """Phases 3d, 3e, 7e and 8a: one sharded sweep on the card, with the
    same injected order and draws per shard on both sides.  At float32
    W > 1 the fused per-block kernel against the composed kernels 2, 3 and
    4 at the same cadence, both on the card, or (``against`` "plain")
    against its plain version on the host CPU; with ``wave`` None (the
    auto plan, which must resolve to W=1) kernels 5, 2, 6 and 4 (at
    float64 A, B and C), and at float64 W > 1 kernels A, B and E, adding
    into a delta against their plain versions on the host CPU.
    ``phens``: a subset of the phenotypes.  ``tie_aware`` as in
    sweep_gate."""
    import numpy as np
    import torch
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.parallel.distributed import Communicator
    from gmrm_tpu_torch.sampler.gibbs import marker_sweep_sharded

    t_gate = time.perf_counter()
    opt, data, statics, states, _ = sharded_setup(sim, dev, n_shards, wave,
                                                  dtype, phens)
    if (opt.wave_size > 1) != (wave is not None):
        fail(f"{name}: the plan resolved to W={opt.wave_size}")
    fdt = np.float64 if dtype == "float64" else np.float32
    nT = len(opt.phen_files)
    mps = data.layout.m_pad_shard
    nblocks = mps // B
    rng = np.random.default_rng(11)
    fused = opt.wave_size > 1 and dtype == "float32"
    if fused:
        orders = [rng.permutation(nblocks)[:, None] * B
                  + np.argsort(rng.uniform(size=(nblocks, B)), axis=1)
                  for _ in range(n_shards)]
    else:
        orders = [np.concatenate([rng.permutation(ln), np.arange(ln, mps)])
                  .reshape(nblocks, B) for ln in data.m_local]
    u = [rng.uniform(size=(nblocks, nT, B)).astype(fdt)
         for _ in range(n_shards)]
    z = [rng.normal(size=(nblocks, nT, B)).astype(fdt)
         for _ in range(n_shards)]
    first = states[0]
    sigmae = 0.5 * (first.eps * first.eps).sum(dim=(1, 2)) / statics[0].nonas
    n_launch = n_shards * nblocks
    mb = data.mb_pad
    if fused:
        # One launch per block step for all shards (and trait chunk).
        pc = pass_chunks(nT, 4, mb)
        sides = (("fused", dev, None,
                  {"block_sweep": nblocks * sweep_chunks(nT, "block_sweep")}),
                 ("composed", dev, False,
                  {k: n_launch * (1 if k == "wave_scan" else pc)
                   for k in COMPOSED_KERNELS})
                 if against == "composed" else
                 ("plain", torch.device("cpu"), None, {}))
    else:
        sides = (("kernels", dev, None,
                  f64_counts(nblocks, shards=n_shards, fused=False,
                             traits=nT, mb=mb, wave=opt.wave_size)
                  if dtype == "float64" else
                  serial_counts(nblocks, shards=n_shards, fused=False,
                                traits=nT, mb=mb)),
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
        counts = {k: v for k, v in launch_counts().items() if v}
        if counts != want:
            fail(f"{name}, {key}: launches {counts}, expected {want}")
        res.append((out[0].cpu(), [[x.cpu() for x in ms_] for ms_ in out[1]],
                    out[2].cpu()))
        ms.append(call_ms(sweep, 2) if d.type == "cuda" else None)
    (ae, a_st, acass), (be, b_st, bcass) = res
    ties = []
    if tie_aware:
        tied, ties = tied_traits(
            name, [(x[1], x[2]) for x in a_st], [(x[1], x[2]) for x in b_st],
            [torch.from_numpy(o) for o in orders], u)
        keep = [t for t in range(nT) if t not in tied]
        ae, be, acass, bcass = ae[keep], be[keep], acass[keep], bcass[keep]
        a_st, b_st = ([[x[keep] for x in ms_] for ms_ in st_]
                      for st_ in (a_st, b_st))
    n_diff = sum(int((a[1] != b[1]).sum()) for a, b in zip(a_st, b_st))
    db = max(max_err(a[0], b[0]) for a, b in zip(a_st, b_st))
    de = max_err(ae, be)
    moved = sum(int((a[1] != 0).sum()) for a in a_st)
    timing = "; ".join(f"{t:.3f} ms per sharded sweep {side[0]}"
                       for side, t in zip(sides, ms) if t is not None)
    print(f"# {name} (T={nT}, S={n_shards}, W={opt.wave_size}, {dtype}, "
          f"{nblocks} blocks per shard, shards of {data.m_local} markers, "
          f"mb_pad={data.mb_pad}): "
          f"{sides[0][0]} against {sides[1][0]} at the same cadence: comp "
          f"mismatches {n_diff} of {n_shards * nT * mps}, cass equal "
          f"{torch.equal(acass, bcass)}, max|dbeta| {db:.3e}, max|deps| "
          f"{de:.3e}; {timing} (CUDA events around eager calls); "
          f"{'; '.join(ties) + ' (left out); ' if ties else ''}"
          f"{time.perf_counter() - t_gate:.1f} s  [{card}]", flush=True)
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
    (``f64_counts``), and A, B and E at float64 W>1 (phase 7h).  ``check_launches`` False skips that check, for a
    tree of another cadence."""
    import numpy as np
    import torch.distributed as dist
    from gmrm_tpu_torch.io.writers import read_history
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.parallel.distributed import init_distributed
    from gmrm_tpu_torch.parallel.runner import run_training_sharded

    f64 = dtype == "float64"
    tag = (f"{'_nccl' if nccl else ''}{'_f64' if f64 else ''}"
           f"{f'_w{wave}' if f64 and wave else ''}")
    out_dir = os.path.join(tmp, f"out_s{n_shards}{tag}")
    opt = anchor_options(sim, out_dir, wave, iterations, dtype)
    if nccl:
        init_distributed(f"file://{tmp}/rendezvous_s{n_shards}{tag}", 1, 0,
                         backend="nccl", timeout_seconds=120)
    try:
        _build.reset_launch_counts()
        res = run_training_sharded(opt, n_devices=n_shards, device=dev,
                                   verbose=False)
        launches = launch_counts()
    finally:
        if nccl:
            dist.destroy_process_group()
    if opt.wave_size != (wave or (1 if f64 else W)):
        fail(f"S={n_shards} training: the plan resolved to W={opt.wave_size}")
    nblocks = -(-(-(-MT // n_shards)) // B)     # ceil(ceil(MT / S) / B)
    want = (f64_counts(nblocks, iterations, n_shards, fused=False,
                       wave=opt.wave_size) if f64
            else
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
    return out, {k: v for k, v in launch_counts().items() if v}


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
          want_cold=serial_counts(nblocks, sweeps=5),
          want_warm=serial_counts(nblocks, sweeps=ITERS_SERIAL - 3))
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


def big_predict_operands(dev, gen, dtype):
    """A seeded bed of the large-N panel's shape for predict (4,096 rows
    of N=100,000 individuals at the kernel's row pitch, the pad bytes
    0x55) with one trait's planes: 2% NAs, y zero where missing and past
    N."""
    import torch
    from gmrm_tpu_torch.ops.predict_sums import pitch_of
    mb = (N_BIG + 3) // 4
    pitch = pitch_of(mb)
    bed = torch.randint(0, 256, (MT_BIG, pitch), generator=gen, device=dev,
                        dtype=torch.uint8)
    bed[:, mb:] = 0x55
    na = (torch.rand((4, pitch), generator=gen, device=dev) > 0.02).to(dtype)
    col = torch.arange(pitch, device=dev)
    na = na * (col[None, :] * 4 + torch.arange(4, device=dev)[:, None]
               < N_BIG)
    y = torch.randn((4, pitch), generator=gen, device=dev, dtype=dtype) * na
    return bed, na.contiguous(), y.contiguous()


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
                     launch_counts())
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
    launches = launch_counts()
    want = (composed_counts(-(-MT // B), ITERS_COMPOSED) if check_launches
            else {})
    for name, n in launches.items():
        if check_launches and n != want.get(name, 0):
            fail(f"composed path: kernel {name} launched {n} times, "
                 f"expected {want.get(name, 0)}")
    check_finite_chain(state.sigmag.cpu().numpy(),
                       state.sigmae.cpu().numpy(), ITERS_COMPOSED)
    return launches, sum(seconds[1:]) / (ITERS_COMPOSED - 1)


def profile_phase(sim, dev, n_shards=0, wave=W, composed=False,
                  dtype="float32", top_n=4):
    """Phase 5: torch.profiler over 5 iterations at the anchor after 2 of
    warm-up, on the single-device path of ``wave`` (the whole-sweep kernel,
    or the exact serial path at 1, also at ``dtype`` float64 for phase 7),
    with ``composed`` on the composed path
    (eager gibbs_iteration with megakernel=False), or, with ``n_shards``, on
    the sharded path, as run_training runs it.  Returns the device-busy and
    wall milliseconds per iteration, host-issued launches (kernels and graph
    replays) per iteration and the ``top_n`` busiest device kernels."""
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
    # The device's copies of the program's spans (gmrm.*) are no device
    # work.
    kernels = [e for e in events
               if "cuda" in str(e.device_type).lower() and e.name != ""
               and not e.name.startswith("gmrm.")]
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
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
    (W=32 for 20 iterations, W=1 for 10, thinned output) and phase 7c's
    float64 W=1 one (10 iterations) through run_training of the tree at
    ``repo``, writing into OUT; prints each run's ms/iteration."""
    import pickle
    import torch
    from gmrm_tpu_torch.runner import run_training
    with open(sim_pkl, "rb") as fh:
        sim = pickle.load(fh)
    for wave, iters, dtype in ((W, ITERS, "float32"),
                               (1, ITERS_SERIAL, "float32"),
                               (1, ITERS_F64, "float64")):
        tag = "_f64" if dtype == "float64" else ""
        opt = anchor_options(sim, os.path.join(out, f"w{wave}{tag}"), wave,
                             iters, dtype)
        res = run_training(opt, device=torch.device("cuda"), verbose=False)
        steady = sum(res.iter_seconds[THIN:]) / (iters - THIN)
        print(f"# {repo}: {dtype} W={wave} {steady * 1e3:.2f} ms/iteration "
              f"over iterations {THIN + 1}-{iters}  [{card}]", flush=True)
    kernel_bytes(os.path.join(out, "kernels"))


def kernel_bytes(out):
    """The block Gram (kernels 5 and A, a run of 16 blocks at NT=1 and
    NT=4) and predict sums (the predict kernel and D, a (4,096, 2,560)
    bed, one trait with NAs) in float32 and float64, and kernel 3 (the
    wave scan's float32 instance, a block of the anchor's shapes), on
    inputs drawn from one seed on the card, their raw bytes written into
    OUT: the kernels that share templates across the two types, compared
    across two trees by ``same_bytes``."""
    import torch
    from gmrm_tpu_torch.ops.block_gram import blocks_gram_scaled
    from gmrm_tpu_torch.ops.predict_sums import predict_sums
    from gmrm_tpu_torch.ops.scan_kernel_wave import WaveScanSweep
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
    outs = {}
    for dtype in (torch.float32, torch.float64):
        tag = "" if dtype == torch.float32 else "_f64"
        for nt in (1, T):
            outs[f"block_gram_nt{nt}{tag}"] = blocks_gram_scaled(
                bed, rows, na[:nt].contiguous(), mave.to(dtype),
                msig.to(dtype))
        outs["predict_sums" + tag] = torch.stack(predict_sums(
            bed[:4096].contiguous(), na[0].to(dtype).contiguous(),
            y.to(dtype).contiguous()))
    ops, c, gs, _ = f64_scan_operands(dev, gen, T, B, K, 2, 96)
    f32 = [x.float() if x.is_floating_point() else x for x in ops]
    sweep = WaveScanSweep(*f32, wave=W)
    sweep.step(1, c.float(), gs["NT=4"].float(), 1, bc=1)
    for name in ("dbeta", "d", "beta_new", "comp_new", "acum_new"):
        outs["wave_scan_" + name] = getattr(sweep, name)[1]
    for name, x in outs.items():
        with open(os.path.join(out, name + ".bin"), "wb") as fh:
            fh.write(x.cpu().numpy().tobytes())


def same_bytes(tree, card):
    """``--same-bytes TREE``: phase 4's and 4b's float32 chains and phase
    7c's float64 W=1 chain written by the tree at TREE and by this one,
    each in its own process on the one card, in the order TREE, this,
    this, TREE (``f32_chains``), with the kernel outputs of
    ``kernel_bytes``; the files of the first two runs must be equal byte
    for byte.  Then every kernel instance of TREE must compile here to the
    same registers, stack frame and spills (``ptxas_resources`` of both
    trees' build logs); and prints how many compile to the same SASS."""
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
        for w in (f"w{W}", "w1", "w1_f64", "kernels"):
            a, b = os.path.join(tmp, "a", w), os.path.join(tmp, "b", w)
            names = sorted(os.listdir(a))
            _, differ, errors = filecmp.cmpfiles(a, b, names, shallow=False)
            if differ or errors or names != sorted(os.listdir(b)):
                fail(f"{w}: {tree} and {REPO} wrote other bytes "
                     f"({differ or errors})")
            what = ("float32 and float64 kernel outputs'" if w == "kernels"
                    else "float64 W=1 chain's" if w == "w1_f64"
                    else f"float32 {w} chain's")
            print(f"# same bytes: the {what} {len(names)} "
                  f"files of {tree} and {REPO} are equal  [{card}]",
                  flush=True)
    # Every kernel instance of TREE compiles to the same resources here.
    logs = [os.path.join(root, "gmrm_tpu_torch", "_build", "build.log")
            for root in (tree, REPO)]
    old, new = (ptxas_resources(open(x).read()) for x in logs)
    differ = {n: (r, new.get(n)) for n, r in old.items() if new.get(n) != r}
    if not old or differ:
        fail(f"ptxas: instances of {tree} whose registers, stack or spills "
             f"differ here: {differ or 'no instance read'}")
    print(f"# same ptxas resources: all {len(old)} kernel instances of "
          f"{tree} have equal registers, stack frame and spills in "
          f"{REPO}; {len(new) - len(old)} instances are new here: "
          f"{sorted(set(new) - set(old))}  [{card}]", flush=True)
    # And their instructions (printed, not gated: the gates are the bytes
    # and the resources above).
    import glob
    old, new = (sass_of(sorted(glob.glob(os.path.join(
        root, "gmrm_tpu_torch", "_build", "libgmrm_kernels_*.so")))[-1])
        for root in (tree, REPO))
    same = [n for n, code in old.items() if new.get(n) == code]
    print(f"# SASS: {len(same)} of the {len(old)} kernels of {tree} compile "
          f"to the same instructions in {REPO}; differ: "
          f"{sorted(set(old) - set(same))}  [{card}]", flush=True)


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


def f64_only(dev, reps, card, repo):
    """``--f64-only REPS``: kernel C's gate (``scan_f64_gate``) once, then
    kernel B's launches alone at the anchor (the c-dot, the update and the
    fused step of a middle block, NT=1 and NT=4, each held against its
    float64 plain version first, ``f64_passes``) beside their float64
    torch.matmul yardsticks, kernel C alone on a middle block (NT=1, NT=4)
    with one stamped launch (``scan_stamp_split``) and kernel 6 on the same
    block's operands cast to float32, then phase 7c's float64
    W=1 run (10 iterations) and a profiler window over 5 float64 W=1
    iterations, ``reps`` times, for comparing two trees inside one call (a
    tree whose float64 fused step is two launches is timed as it runs).
    The launch counts are checked only for this script's own tree."""
    import torch
    from gmrm_tpu_torch.ops import block_kernels as bk
    from gmrm_tpu_torch.ops import scan_kernel as sk6
    own = os.path.abspath(repo) == REPO
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    bed, rows_all, mave_p, msig_p, na1, na4 = f64_anchor_operands(dev, gen)
    nblocks = rows_all.shape[0]
    d_all = (torch.randn((nblocks, T, B), generator=gen, device=dev,
                         dtype=torch.float64) * 0.01).contiguous()
    eps = torch.randn((T, 4, MB), generator=gen, device=dev,
                      dtype=torch.float64)
    err_c, note_c, (sweep, c_n, gs_n) = scan_f64_gate(dev, gen)
    if own:
        note_c += "; " + math_gate(dev, gen)
    print(f"# {repo}: kernel C held against its plain version: max abs err "
          f"{err_c:.3e}; {note_c}  [{card}]", flush=True)
    # Kernel 6, C's float32 twin, on the same operands cast to float32.
    f32 = [x.float() if x.is_floating_point() else x
           for x in (sweep.nm1, *sweep.tables, *sweep.state, sweep.msig_p,
                     sweep.i2se)]
    sweep6 = sk6.SerialScanSweep(f32[0], *f32[1:4], *f32[4:11], f32[11],
                                 f32[12])
    c6, gs6 = c_n.float(), gs_n["NT=1"].float()
    with tempfile.TemporaryDirectory() as tmp:
        sim = anchor_dataset(os.path.join(tmp, "data"))
        for rep in range(reps):
            ad_times(dev, gen, card, repo, rep)
            *_, times = f64_passes(bk, bed, rows_all, mave_p, msig_p, d_all,
                                   eps, (na1, na4), (nblocks // 2,))
            for nt, by in times.items():
                print(f"# {repo}: kernel B {nt}, run {rep + 1} (ms, graph "
                      f"replay: kernel / float64 torch.matmul): " + ", ".join(
                          f"{name} {k:.5f} / {lib:.5f}"
                          for name, (k, _, lib) in by.items())
                      + f"  [{card}]", flush=True)
            bm = nblocks // 2
            c_ms, c_plain = scan_f64_times(sweep, c_n, gs_n, bm)
            split = scan_stamp_split(sweep, c_n, gs_n["NT=1"], bm)
            k6_ms = cuda_ms(lambda: sweep6.step(bm, c6, gs6, bm, bc=bm), 20)
            print(f"# {repo}: kernel C, run {rep + 1} (ms a block, graph "
                  f"replay): NT=1 {c_ms['NT=1']:.5f}, NT={T} "
                  f"{c_ms['NT=4']:.5f}, plain {c_plain:.4f}; kernel 6 on the "
                  f"same block in float32 {k6_ms:.5f}; stamps (NT=1): "
                  f"{split['text']}  [{card}]", flush=True)
            run_dir = os.path.join(tmp, f"run{rep}")
            os.makedirs(run_dir)
            _, launches, steady, _, _ = training_phase(
                sim, dev, run_dir, 1, ITERS_F64, check_launches=own,
                dtype="float64")
            print(f"# {repo}: float64 training W=1, run {rep + 1}: "
                  f"{steady * 1e3:.2f} ms/iteration over iterations "
                  f"{THIN + 1}-{ITERS_F64}; launches "
                  f"{ {k: v for k, v in launches.items() if v} }  [{card}]",
                  flush=True)
            busy, wall, calls, top = profile_phase(sim, dev, wave=1,
                                                   dtype="float64", top_n=8)
            print(f"# {repo}: profiler float64 W=1, run {rep + 1}: device "
                  f"busy {busy:.3f} of {wall:.3f} ms/iteration, idle share "
                  f"{1 - busy / wall:.3f}, {calls:.1f} launches per "
                  f"iteration; busiest kernels (name, ms and launches per "
                  f"iteration) {top}  [{card}]", flush=True)


def kernel_ms_by_name(fn, reps=5):
    """Device ms per call of ``fn`` by kernel name: ``reps`` calls captured
    in one CUDA graph, one replay of it under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if "cuda" in str(e.device_type).lower() and e.name:
            us = getattr(e, "device_time", None) or e.cuda_time
            by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / reps
    return by_name


def sass_counts(lib, fn_part, ops):
    """How often each SASS opcode prefix of ``ops`` occurs in every
    function of the shared library ``lib`` whose mangled name contains
    ``fn_part`` (``cuobjdump -sass``), and its instructions in all but
    the NOPs that pad it (``"all"``)."""
    import re
    from gmrm_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1) if fn_part in head.group(1) else None
            if fn:
                counts[fn] = dict.fromkeys((*ops, "all"), 0)
        elif fn:
            instr = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", line)
            counts[fn]["all"] += (instr is not None
                                  and instr.group(1) != "NOP")
            for op in ops:
                if instr and instr.group(1).startswith(op):
                    counts[fn][op] += 1
    return counts


def sass_of(lib):
    """Each kernel's SASS in the shared library ``lib`` (``cuobjdump
    -sass``): {name (ANON_NS reduced): its instructions, without their
    addresses and encodings}."""
    from gmrm_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = ANON_NS.sub(r"_ZN\1_", head.group(1))
            out[fn] = []
        elif fn:
            instr = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if instr:
                out[fn].append(instr.group(1))
    return out


def ad_times(dev, gen, card, repo, rep):
    """Kernels A and D alone (``--f64-only``), for comparing two trees in
    one call: A on all 157 anchor blocks at NT=1 and NT=4, gs bit-equal to
    the plain version, device ms per launch by graph replay, and the
    launch's kernels split by name under torch.profiler (a tree of the
    earlier design launches a raw kernel and a scaling pass); where the
    tree's wrapper records them (``stamps=``), the %globaltimer split of
    one launch into main loop and epilogue.  D and the float32 predict
    kernel on one seeded bed of the anchor's shape (20,000 rows, 2% NAs),
    each held by ``predict_case``, and the int-to-float conversions in
    both instances' SASS.  In a tree that records stamps, the first rep
    also runs the widened gate (``gram_gate``) at both types."""
    import inspect
    import torch
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.ops import block_gram as bg
    bed, rows_all, mave_p, msig_p, na1, na4 = f64_anchor_operands(dev, gen)
    nblocks = rows_all.shape[0]
    stamped = "stamps" in inspect.signature(bg.blocks_gram_scaled).parameters
    for nt, na in ((1, na1[:1]), (T, na4)):
        for dtype in (torch.float64, torch.float32):
            args = (bed, rows_all, na.float().contiguous(),
                    mave_p.to(dtype), msig_p.to(dtype))
            got = bit_equal_twice(f"block_gram {dtype} (NT={nt})", lambda: (
                bg.blocks_gram_scaled(*args),))[0]
            if not torch.equal(got, bg.blocks_gram_scaled_plain(*args)):
                fail(f"block_gram {dtype} (NT={nt}): gs is not bit-equal to "
                     f"its plain version")
            del got
            ms = cuda_ms(lambda: bg.blocks_gram_scaled(*args), 5)
            split = kernel_ms_by_name(lambda: bg.blocks_gram_scaled(*args))
            parts = ", ".join(f"{k[:40]} {v:.4f}" for k, v in split.items())
            stamps = ""
            if stamped:
                stamps = "; stamps: " + gram_stamp_split(bg, args)
            print(f"# {repo}: kernel {'A' if dtype == torch.float64 else 5}"
                  f" NT={nt}, run {rep + 1}: {ms:.4f} ms a launch of "
                  f"{nblocks} blocks (graph replay); by kernel (profiler): "
                  f"{parts}{stamps}  [{card}]", flush=True)
    if stamped and rep == 0:
        for dtype in (torch.float32, torch.float64):
            lines = gram_gate(bg, dev, gen, dtype)
            print(f"# {repo}: block_gram {dtype} bit-equal twice at (B, mb, "
                  f"blocks) {GRAM_GATE_SHAPES}, NT=1 and NT={T}; plans: "
                  + " | ".join(lines[::2]) + f"  [{card}]", flush=True)
    m = MT
    pitch = MB
    pbed = torch.randint(0, 256, (m, pitch), generator=gen, device=dev,
                         dtype=torch.uint8)
    keep = (torch.rand((4, pitch), generator=gen, device=dev) > 0.02)
    y = torch.randn((4, pitch), generator=gen, device=dev,
                    dtype=torch.float64)
    for dtype in (torch.float64, torch.float32):
        row = predict_case(f"{repo} run {rep + 1}, seeded anchor bed, 2% "
                           f"NAs, {dtype}", pbed, keep.to(dtype),
                           (y * keep).to(dtype), 4 * pitch, card)
        del row
    ops = ("I2F.F64", "I2F", "F2F", "DFMA", "PRMT")
    counts = sass_counts(_build.build(), "predict_sums_kernel", ops)
    print(f"# {repo}: SASS of the predict kernels (instructions whose "
          f"opcode starts {', '.join(ops)}, and all but NOPs): " + "; ".join(
              f"{'double' if 'kernelId' in fn else 'float'} {c}"
              for fn, c in counts.items()) + f"  [{card}]", flush=True)


def close64(name, got, want):
    """Float64 kernels against their plain versions: within 1e-10 of
    max|want| (a sum of at most 4 mb float64 terms in another order)."""
    err = max_err(got, want)
    if err > 1e-10 * float(want.abs().max()):
        fail(f"{name}: kernel disagrees with its float64 plain version "
             f"(max abs err {err:.3e}, max|want| "
             f"{float(want.abs().max()):.3e})")
    return err


def f64_anchor_operands(dev, gen):
    """The anchor's float64 pass operands on the card: a bed of 157 blocks
    (the pad rows and the last 60 byte columns 0x55), the W=1 order (the
    real markers shuffled, the pad rows last: the last block holds 96 pad
    slots), mave and msig in that order (zero on pad slots), a shared
    (NT=1) and a per-trait (NT=4) NA mask."""
    import torch
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
    return bed, rows_all, mave_p, msig_p, na_shared, na_trait


def f64_passes(bk, bed, rows_all, mave_p, msig_p, d_all, eps, masks,
               blocks):
    """Phase 7a and ``--f64-only``: kernel B's three launches (the c-dot,
    the update and the fused pass) at float64 on the sweep's (nb, T, B)
    arrays, for each NA mask of ``masks`` and each block of ``blocks``.
    Through the one-block wrappers each is launched twice on the same
    inputs (bit-equal) and held against its float64 plain version
    (``close64``; the update from a zero residual, so the compared values
    are the update itself; the fused pass updates ``eps`` with the block
    before and dots the block), and the fused pass's c must be at least as
    close to the plain c-dot of the residual it wrote as the c-dot alone
    is; through ``BlockPasses`` (a block index) each is bit-equal to its
    wrapper.  Then each is timed by graph replay at ``blocks[0]`` beside
    its plain version and a float64 torch.matmul yardstick on pre-decoded
    operands (the c-dot (T, 4mb) @ (4mb, 2B), the update (T, 2B) @ (2B,
    4mb), the fused pass both).  Returns ({name: (max abs err, kernel ms,
    plain ms, yardstick ms, bound)} at the first mask, {name: every mask's
    times}, the last mask's ``BlockPasses``, {mask: {name: (kernel,
    plain, yardstick ms)}})."""
    import torch
    from gmrm_tpu_torch.ops.decode import decode_planes
    f64 = torch.float64
    mb = bed.shape[1]
    errs = dict.fromkeys(PASSES, 0.0)
    times = {}
    for na in masks:
        nt = mask_name(na)
        e = (eps * na).contiguous()
        passes = bk.BlockPasses(bed, rows_all, mave_p, msig_p, na)
        for b in blocks:
            where = f"{nt}, block {b}"
            rows, mave, msig, d = rows_all[b], mave_p[b], msig_p[b], d_all[b]
            prev = (rows_all[b - 1], d_all[b - 1], mave_p[b - 1])
            c = bit_equal_twice(f"block_cdot_f64 ({where})", lambda: (
                bk.block_cdot(bed, rows, e, mave, msig),))[0]
            errs["block_cdot"] = max(errs["block_cdot"], close64(
                f"block_cdot_f64 ({where})", c,
                bk.block_cdot_plain(bed, rows, e, mave, msig)))

            def upd():
                t = torch.zeros_like(e)
                bk.block_eps_update_(bed, rows, d, mave, na, t)
                return (t,)
            u = bit_equal_twice(f"eps_update_f64 ({where})", upd)[0]
            errs["eps_update"] = max(errs["eps_update"], close64(
                f"eps_update_f64 ({where})", u, bk.block_eps_update_plain_(
                    bed, rows, d, mave, na, torch.zeros_like(e))))
            if not u.abs().sum() > 0:
                fail(f"eps_update_f64 ({where}) is zero")

            def fused():
                x = e.clone()
                return x, bk.block_update_cdot_(bed, *prev, na, x, rows,
                                                mave, msig)
            fe, fc = bit_equal_twice(f"update_cdot_f64 ({where})", fused)
            we = e.clone()
            wc = bk.block_update_cdot_plain_(bed, *prev, na, we, rows, mave,
                                             msig)
            for part, g, w in (("eps", fe, we), ("c", fc, wc)):
                errs["update_cdot"] = max(errs["update_cdot"], close64(
                    f"update_cdot_f64 ({where}) {part}", g, w))
            ref = bk.block_cdot_plain(bed, rows, fe, mave, msig)
            alone = bk.block_cdot(bed, rows, fe, mave, msig)
            if max_err(fc, ref) > max_err(alone, ref):
                fail(f"update_cdot_f64 ({where}): c is further from the "
                     f"plain c-dot ({max_err(fc, ref):.3e}) than the c-dot "
                     f"alone ({max_err(alone, ref):.3e})")
            passes.cdot(b, e)
            same = torch.equal(passes.c[b], c)
            t = torch.zeros_like(e)
            passes.update_(b, d_all, t)
            x = e.clone()
            passes.update_cdot_(b - 1, d_all, x)
            if not (same and torch.equal(t, u) and torch.equal(x, fe)
                    and torch.equal(passes.c[b], fc)):
                fail(f"BlockPasses at float64 ({where}): the sweep "
                     f"interface and the one-block wrappers differ")
        b = blocks[0]
        target, x, x2 = torch.zeros_like(e), e.clone(), e.clone()
        pa, pb = decode_planes(bed[rows_all[b].long()], f64)
        ab = torch.cat([pa, pb]).reshape(2 * B, -1)
        del pa, pb
        e2 = e.reshape(T, -1)
        dd = torch.cat([d_all[b], mave_p[b] * d_all[b]], dim=1)
        plain = (bed, rows_all[b - 1], d_all[b - 1], mave_p[b - 1], na)
        times[nt] = {
            "block_cdot": (
                cuda_ms(lambda: passes.cdot(b, e), 200),
                cuda_ms(lambda: bk.block_cdot_plain(
                    bed, rows_all[b], e, mave_p[b], msig_p[b]), 20),
                cuda_ms(lambda: e2 @ ab.T, 200)),
            "eps_update": (
                cuda_ms(lambda: passes.update_(b, d_all, target), 200),
                cuda_ms(lambda: bk.block_eps_update_plain_(
                    bed, rows_all[b], d_all[b], mave_p[b], na, target), 20),
                cuda_ms(lambda: dd @ ab, 200)),
            "update_cdot": (
                cuda_ms(lambda: passes.update_cdot_(b - 1, d_all, x), 200),
                cuda_ms(lambda: bk.block_update_cdot_plain_(
                    *plain, x2, rows_all[b], mave_p[b], msig_p[b]), 20),
                cuda_ms(lambda: (dd @ ab, e2 @ ab.T), 200))}
        del ab
        if not (torch.isfinite(x).all() and torch.isfinite(target).all()):
            fail("kernel B: the timed launches left a non-finite residual")
    plane, tb = T * 4 * mb * 8, T * B * 8
    blk = B * mb + B * 4
    ops = 4 * T * B * 4 * mb
    bounds = {"block_cdot": bound_of(blk + plane + 3 * tb, (ops, F64_OPS)),
              "eps_update": bound_of(blk + 3 * plane + 2 * tb,
                                     (ops, F64_OPS)),
              "update_cdot": bound_of(2 * blk + 3 * plane + 5 * tb,
                                      (2 * ops, F64_OPS))}
    first = times[mask_name(masks[0])]
    rows = {name + "_f64": (errs[name], *first[name], bounds[name])
            for name in PASSES}
    notes = {name + "_f64": "; ".join(
        f"{nt}: kernel {t[name][0]:.5f}, torch.matmul {t[name][2]:.5f}"
        for nt, t in times.items()) for name in PASSES}
    return rows, notes, passes, times


# Kernel C beyond the anchor, (T, B, K) on one block's sweep arrays, each
# against serial_scan_plain (phase 7a, --f64-only): one trait; eight; 33
# (more traits than one CTA takes); K=8; K=16 at eight traits and, at
# B=512, twelve; B=512; B=203 (no bulk copies); B=1.
F64_SCAN_SHAPES = ((1, 128, 4), (8, 128, 4), (33, 128, 4), (4, 128, 8),
                   (8, 128, 16), (4, 512, 4), (12, 512, 16), (4, 203, 4),
                   (4, 1, 4))


def f64_scan_operands(dev, gen, Tv, Bv, Kv, nb, pad, G=3):
    """Kernel C's operands on the card: the sweep's (nb, ..., B) float64
    arrays of Tv traits and Kv components (mixtures 0 and a log-spaced
    run, an adaV group), the last block's last ``pad`` slots padding; c of
    order 30; the scaled Grams of 600 random columns, the same for every
    trait (NT=1) and each trait's scaled by its own factor in [0.5, 1.5]
    (NT=4, as per-trait NA masks make them).  Returns (SerialScanSweep's
    operands, c, {"NT=1": gs, "NT=4": gs}, live)."""
    import torch
    from gmrm_tpu_torch.ops import scan_kernel_wave as sw
    from gmrm_tpu_torch.ops import sweep_kernel as sk
    f64 = torch.float64

    def rnd(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=f64)

    def nrm(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=f64)
    cva = torch.cat([torch.zeros((G, 1), device=dev, dtype=f64),
                     torch.logspace(-3, -1.3, Kv - 1, device=dev,
                                    dtype=f64).expand(G, Kv - 1)], dim=1)
    cvai = torch.zeros_like(cva)
    cvai[:, 1:] = 1.0 / cva[:, 1:]
    sigmag = rnd(Tv, G) * 0.4 + 0.1
    sigmag[0, 1] = 0.0                                   # an adaV group
    sigmae = rnd(Tv) * 0.4 + 0.5
    pi = rnd(Tv, G, Kv) + 0.1
    pi = pi / pi.sum(-1, keepdim=True)
    nonas = torch.full((Tv,), 490.0, device=dev, dtype=f64)
    tabs = sk.build_sweep_tables(sigmag, sigmae, pi, cva, cvai, nonas, 500.0,
                                 dtype=f64)
    grp = torch.randint(0, G, (nb, Bv), generator=gen, device=dev)
    valid = torch.ones((nb, Bv), dtype=torch.bool, device=dev)
    valid[-1, Bv - pad:] = False
    live, zerob = (x.movedim(0, 1).contiguous()
                   for x in sw.scan_masks(grp, valid, sigmag))
    xg = nrm(nb, Bv, 600)
    gs1 = torch.bmm(xg, xg.transpose(1, 2))
    del xg
    gs = {"NT=1": gs1[:, None].expand(nb, Tv, Bv, Bv).contiguous(),
          "NT=4": (gs1[:, None] * (rnd(Tv) + 0.5)[None, :, None, None])
          .contiguous()}
    del gs1
    ops = (nonas - 1.0,
           *(t[:, :, grp].movedim(2, 0).contiguous() for t in tabs),
           nrm(nb, Tv, Bv) * 0.05,
           torch.randint(0, Kv, (nb, Tv, Bv), generator=gen, device=dev,
                         dtype=torch.int32),
           rnd(nb, Tv, Bv), rnd(nb, Tv, Bv), nrm(nb, Tv, Bv), live, zerob,
           rnd(nb, Tv, Bv) + 0.5, (1.0 / (2.0 * sigmae)).contiguous())
    return ops, nrm(nb, Tv, Bv) * 30.0, gs, live


def math_gate(dev, gen, n=10_000_000):
    """Kernel C's written-out math (csrc/serial_scan.cu, through
    gmrm_math_check) against the library's on the card.  The reciprocal
    rcp_ge1 against the IEEE division __ddiv_rn(1.0, x): n seeded x in
    [1, 2^1000) (a uniform exponent, uniform mantissa bits) and the edges:
    1, the next double above 1, every power of two from 1 to 2^1023, the
    largest mantissa at every one of those exponents, 2^1022 and its
    neighbours, the largest finite double and +inf; bit-equal up to 2^1022
    (and equal to torch's 1 / x); above it rcp_ge1 gives 0 where the
    division gives a subnormal, or 0 at +inf.  exp_near against exp: n
    seeded x in [-760, 760] and the edges of its range (0, +-1e-300, +-700,
    the doubles on both sides of |x| = 708.4 where it hands over to exp,
    +-745.2, +-inf, NaN); bit-equal wherever it takes x (all |x| < 708.39),
    out of range elsewhere.  Returns a note."""
    import torch
    from gmrm_tpu_torch.ops import _build
    i64, f64 = torch.int64, torch.float64

    def check(x):
        out = torch.empty((x.numel(), 4), dtype=i64, device=dev)
        err = _build.library().gmrm_math_check(
            x.data_ptr(), out.data_ptr(), x.numel(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"gmrm_math_check launch failed: {_build.error_string(err)}")
        torch.cuda.synchronize()
        return out

    expo = torch.randint(1023, 2023, (n,), generator=gen, device=dev,
                         dtype=i64)
    mant = torch.randint(0, 2 ** 52, (n,), generator=gen, device=dev,
                         dtype=i64)
    every = torch.arange(1023, 2047, device=dev, dtype=i64)
    top = torch.tensor([2.0 ** 1022], dtype=f64)
    edges = torch.cat([
        torch.tensor([1.0, 2.0 ** 1022, torch.finfo(f64).max,
                      float("inf")], dtype=f64),
        torch.nextafter(torch.tensor([1.0], dtype=f64),
                        torch.tensor([2.0], dtype=f64)),
        torch.nextafter(top, torch.zeros_like(top)),
        torch.nextafter(top, top * 2)]).to(dev)
    x = torch.cat([((expo << 52) | mant).view(f64), (every << 52).view(f64),
                   ((every << 52) | (2 ** 52 - 1)).view(f64),
                   edges]).contiguous()
    out = check(x)
    mine, ieee = out[:, 0], out[:, 1]
    inside = x <= 2.0 ** 1022
    bad = (mine != ieee) & inside
    if bad.any():
        fail(f"serial_scan_f64: rcp_ge1 differs from __ddiv_rn(1.0, x) at "
             f"{int(bad.sum())} of {int(inside.sum())} x in [1, 2^1022], "
             f"first x = {float(x[bad][0])!r}")
    if not torch.equal(ieee[inside].view(f64), 1.0 / x[inside]):
        fail("serial_scan_f64: __ddiv_rn(1.0, x) differs from torch's 1 / x")
    above = ~inside
    if (mine[above] != 0).any() or (
            ieee[above].view(f64) >= 2.0 ** -1022).any():
        fail("serial_scan_f64: above 2^1022 rcp_ge1 is not 0, or the "
             "division not subnormal")
    n_rcp = int(inside.sum())

    hand = torch.tensor([0x4086232A_FFFFFFFF, 0x4086232B_00000000],
                        dtype=i64).view(f64)
    xe = torch.cat([
        (torch.rand((n,), generator=gen, device=dev, dtype=f64) - 0.5)
        * 1520.0,
        torch.tensor([0.0, -0.0, 1e-300, -1e-300, 700.0, -700.0, 745.2,
                      -745.2, float("inf"), float("-inf"), float("nan")],
                     dtype=f64, device=dev),
        hand.to(dev), -hand.to(dev)]).contiguous()
    out = check(xe)
    near, lib = out[:, 2], out[:, 3]
    taken = near != -1
    if (~taken & (xe.abs() < 708.39)).any():
        fail("serial_scan_f64: exp_near hands over to exp below |x| 708.39")
    bad = taken & (near != lib)
    if bad.any():
        fail(f"serial_scan_f64: exp_near differs from exp at "
             f"{int(bad.sum())} of {int(taken.sum())} x, first x = "
             f"{float(xe[bad][0])!r}")
    return (f"rcp_ge1 bit-equal to __ddiv_rn(1.0, x) at {n_rcp} x in "
            f"[1, 2^1022] ({n} seeded, the rest edges), 0 at the "
            f"{int(above.sum())} above; exp_near bit-equal to exp at "
            f"{int(taken.sum())} of {xe.numel()} x in [-760, 760] and "
            f"edges, exp taken at the rest")


def scan_f64_gate(dev, gen):
    """Kernel C against serial_scan_plain on the card: at the anchor on the
    sweep's 157-block arrays (a middle block and the last, with its 96 pad
    slots) with per-trait Grams at |c| of order 30 and 1e3 (where live
    steps must take the |dlogl| > 700 guard) and the shared Gram at the
    middle block, then at F64_SCAN_SHAPES on one block, at both |c|.  Each
    launch twice (bit-equal), comp exact, dbeta, beta and acum within 1e-10
    of their largest magnitude, d = msig * dbeta bit for bit, the one-block
    wrapper bit-equal to the sweep interface.  Returns (max abs err, a
    note, the anchor's (sweep, c, {NT: gs}))."""
    import torch
    from gmrm_tpu_torch.ops import scan_kernel as sk6
    err = 0.0

    def held(where, sweep, ops, c, gs, b):
        nonlocal err

        def step():
            sweep.step(b, c, gs, b, bc=b)
            return tuple(x[b].clone() for x in (
                sweep.dbeta, sweep.beta_new, sweep.comp_new, sweep.acum_new,
                sweep.d))
        got = bit_equal_twice(f"serial_scan_f64 ({where})", step)
        base = (c[b] + ops[4][b] * ops[0][:, None]).contiguous()
        blk = (base, *(x[b] for x in ops[1:4]), gs[b],
               *(x[b] for x in ops[4:11]), ops[12])
        want = sk6.serial_scan_plain(*blk)
        if not torch.equal(got[2], want[2]):
            fail(f"serial_scan_f64 ({where}): comp differs from the plain "
                 f"version in {int((got[2] != want[2]).sum())} entries")
        for part, g, w in zip(("dbeta", "beta", "acum"),
                              (got[0], got[1], got[3]),
                              (want[0], want[1], want[3])):
            err = max(err, close64(f"serial_scan_f64 ({where}) {part}", g,
                                   w))
        if not torch.equal(got[4], ops[11][b] * got[0]):
            fail(f"serial_scan_f64 ({where}): d is not msig * dbeta bit for "
                 f"bit")
        one = sk6.serial_scan(*blk)
        if not all(torch.equal(x, y) for x, y in zip(one, got)):
            fail(f"serial_scan_f64 ({where}): the one-block wrapper and the "
                 f"sweep interface wrote different bits")
        return want, blk

    def guarded_steps(blk, dbeta, live_b):
        """Live steps where some |L_k - L_i| > 700, each step's num rebuilt
        from the plain version's dbeta."""
        base, lc, rd, gs_b, i2se = blk[0], blk[1], blk[2], blk[4], blk[-1]
        num = base + (dbeta[:, :, None] * torch.triu(gs_b, 1)).sum(1)
        logl = lc + rd * num * (num * i2se[:, None])
        spread = logl.max(0).values - logl.min(0).values
        return int(((spread > 700.0) & (live_b != 0)).sum())

    nblocks = -(-MT // B)
    bm = nblocks // 2
    ops, c, gs, live = f64_scan_operands(dev, gen, T, B, K, nblocks, 96)
    sweep = sk6.SerialScanSweep(*ops)
    guarded, drawn = 0, set()
    for scale in (1.0, 40.0):
        for b in (bm, nblocks - 1):
            want, blk = held(f"anchor, block {b}, NT={T}, |c| "
                             f"~{30 * scale:.0f}", sweep, ops, c * scale,
                             gs["NT=4"], b)
            drawn.update(want[2][live[b] != 0].tolist())
            if scale > 1:
                guarded += guarded_steps(blk, want[0], live[b])
    held(f"anchor, block {bm}, NT=1", sweep, ops, c, gs["NT=1"], bm)
    if not guarded:
        fail("serial_scan_f64: no step at |c| ~1e3 took the 700 guard")
    if len(drawn) < 2:
        fail(f"serial_scan_f64: the blocks drew components {drawn} only")
    if not torch.equal(sweep.beta_new[-1][:, B - 96:], ops[4][-1][:, B - 96:]):
        fail("serial_scan_f64: the last block's pad slots moved")
    for Tv, Bv, Kv in F64_SCAN_SHAPES:
        o2, c2, g2, _ = f64_scan_operands(dev, gen, Tv, Bv, Kv, 1,
                                          min(3, Bv - 1))
        sw2 = sk6.SerialScanSweep(*o2)
        for scale in (1.0, 40.0):
            held(f"T={Tv}, B={Bv}, K={Kv}, |c| ~{30 * scale:.0f}", sw2, o2,
                 c2 * scale, g2["NT=4"], 0)
        del o2, c2, g2, sw2
    note = (f"{guarded} live steps of the two anchor blocks at |c| ~1e3 "
            f"took the 700 guard; also held at (T, B, K) in "
            f"{list(F64_SCAN_SHAPES)}, per-trait Grams")
    return err, note, (sweep, c, gs)


def scan_f64_times(sweep, c, gs, b):
    """Kernel C's ms a block at block b (graph replay) with the shared
    Gram (NT=1) and per-trait Grams (NT=4), and its plain version's."""
    from gmrm_tpu_torch.ops import scan_kernel as sk6
    ms = {nt: cuda_ms(lambda g=g: sweep.step(b, c, g, b, bc=b), 20)
          for nt, g in gs.items()}
    ops_b = [x[b] for x in sweep.state]
    base = (c[b] + ops_b[0] * sweep.nm1[:, None]).contiguous()
    blk = (base, *(x[b] for x in sweep.tables), gs["NT=1"][b], *ops_b,
           sweep.i2se)
    return ms, cuda_ms(lambda: sk6.serial_scan_plain(*blk), 1)


def scan_stamp_split(sweep, c, gs, b, bc=None):
    """One stamped launch of a serial scan sweep (``step(...,
    stamps=)``, events scan_kernel.SCAN_STAMPS) at block b (with c[bc],
    c[b] by default): its SM clock, the cycles a step of each phase
    (summed over the block's steps by the scanning warp's lane 0, each
    phase ended once its value is known), the steps that waited for a
    helper warp or the Gram ring, and the chain bound: the cycles of the
    step's dependent phases (CHAIN_PHASES) over the block, at that clock
    (``scan_kernel.scan_stamp_summary``).  Returns {"text", "chain_ms"};
    chain_ms is None for a tree whose kernel records none or that has no
    such reducer."""
    import torch
    from gmrm_tpu_torch.ops import scan_kernel as sk6
    names = getattr(sk6, "SCAN_STAMPS", None)
    if names is None or not hasattr(sk6, "scan_stamp_summary"):
        return {"text": "none recorded", "chain_ms": None}
    st = torch.zeros(len(names), dtype=torch.int64, device=c.device)
    sweep.step(b, c, gs, b, bc=b if bc is None else bc, stamps=st)
    torch.cuda.synchronize()
    v = sk6.scan_stamp_summary(st.cpu(), c.shape[-1])
    ns = v["chain_ns"]
    ghz = v["cycles"] / ns
    nsteps = v["steps"]
    chain = sum(v["phases"][k] for k in CHAIN_PHASES)
    text = (f"chain {ns / 1e3:.2f} us, {v['cycles'] / nsteps:.0f} cycles a "
            f"step at {ghz * 1e3:.0f} MHz; cycles a step by phase "
            + ", ".join(f"{k} {x / nsteps:.0f}"
                        for k, x in v["phases"].items())
            + f"; chain bound {chain / nsteps:.0f} cycles a step, "
            f"{chain / ghz / 1e6:.5f} ms a block")
    for what in ("helper", "ring"):
        text += (f"; waited for the {what} at {v[what + '_waits']} of "
                 f"{nsteps} steps, {v[what + '_wait_cycles']} cycles")
    return {"text": text, "chain_ms": chain / ghz / 1e6}


def float64_kernel_phase(dev, gen, card):
    """Phase 7a: kernels A, B and C against their float64 plain versions
    on the card, at the anchor's shapes (T=4, B=128, K=4, mb_pad=2560,
    157 blocks, the last with 96 pad slots), with the shared (NT=1) and a
    per-trait (NT=4) NA mask, an adaV group; each launched twice on the
    same inputs (bit-equal) and timed beside its plain version by graph
    replay, with a float64 torch.matmul yardstick on pre-decoded operands
    for A and B.  Kernel A's gs bit-equal (the same roundings as the plain
    version); B's c and eps within 1e-10 of their largest magnitude.
    Kernel B is its three launches (``f64_passes``: the c-dot, the update
    and the fused pass at a middle block and the last), one stamped launch
    of each (``passes_stamp_split``) and the same at mb_pad=25,088
    (``passes_big``).  Kernel C is ``scan_f64_gate`` (per-trait Grams, the
    anchor and F64_SCAN_SHAPES), timed at a middle block with the shared
    and per-trait Grams, and one stamped launch (``scan_stamp_split``).
    Returns {name: (max abs err, kernel ms, plain ms, library ms or None,
    bound)}; C's chain bound goes into CHAIN_BOUND_MS."""
    import torch
    from gmrm_tpu_torch.ops import block_gram as bg
    from gmrm_tpu_torch.ops import block_kernels as bk
    from gmrm_tpu_torch.ops.decode import decode_planes

    f64 = torch.float64
    nblocks = -(-MT // B)
    bed, rows_all, mave_p, msig_p, na_shared, na_trait = f64_anchor_operands(
        dev, gen)
    res = {}
    ms_of = {}

    # Kernel A: all 157 blocks in one run at NT=1 and NT=4 (the last block
    # with its pad slots), twice, bit-equal; then GRAM_GATE_SHAPES.
    gram_ops = 2 * (2 * (B * (B + 1) // 2) + B * B) * 4 * (MB - 60)
    err_a, a_ms, a_notes = 0.0, [], []
    for na in (na_shared, na_trait):
        nt = 1 if na is na_shared else T
        na_in = (na[:1] if nt == 1 else na).to(torch.float32).contiguous()
        nb = bg.gram_run_blocks(T, B, nblocks, 8)
        if nb != nblocks:
            fail(f"block_gram_f64: a run of {nb} blocks at NT={nt}")
        args = (bed, rows_all, na_in, mave_p, msig_p)
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
        a_notes.append(f"NT={nt}: plan {gram_plan_text(bg, B, nt, nb)}; "
                       f"stamps {gram_stamp_split(bg, args)}")
    a_notes.append("bit-equal twice at (B, mb, blocks) "
                   f"{GRAM_GATE_SHAPES}, NT=1 and NT={T}; plans: "
                   + " | ".join(gram_gate(bg, dev, gen, f64)))
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
        f"NT={nt}: {k:.5f} per block in a run of {nb} ({k * nb:.4f} a "
        f"launch; plain {p:.4f})" for (nb, k, p), nt in zip(a_ms, (1, T)))
    ms_of["block_gram_f64"] += "; " + "; ".join(a_notes)

    # Kernel B: the c-dot, the update and the fused pass, checked at a
    # middle block and the last, timed at the middle one (f64_passes).
    bm = nblocks // 2
    d_all = (torch.randn((nblocks, T, B), generator=gen, device=dev,
                         dtype=f64) * 0.01).contiguous()
    eps = torch.randn((T, 4, MB), generator=gen, device=dev, dtype=f64)
    b_rows, b_note, passes, _ = f64_passes(
        bk, bed, rows_all, mave_p, msig_p, d_all, eps,
        (na_shared, na_trait), (bm, nblocks - 1))
    res.update(b_rows)
    ms_of.update(b_note)
    split = passes_stamp_split(bk, passes, bm, (eps * na_trait).contiguous(),
                               d_all)
    for name, parts in split.items():
        ms_of[name + "_f64"] += (f"; stamps (NT={T}, us, mean/latest): "
                                 f"{parts}")
    wide = passes_big(bk, dev, gen, torch.float64)
    for name in PASSES:
        ms_of[name + "_f64"] += f"; at mb_pad={MB_BIG}: {wide[name]}"
    err_w = wide["errs"]
    for name in PASSES:
        e, *rest = res[name + "_f64"]
        res[name + "_f64"] = (max(e, err_w[name]), *rest)
    tb = T * B * 8

    # Kernel C (math_gate, scan_f64_gate, scan_f64_times, scan_stamp_split).
    note_r = math_gate(dev, gen)
    err_s, note_s, (sweep, c_n, gs_n) = scan_f64_gate(dev, gen)
    bm = nblocks // 2
    s_ms, s_plain = scan_f64_times(sweep, c_n, gs_n, bm)
    split = scan_stamp_split(sweep, c_n, gs_n["NT=1"], bm)
    ms_of["serial_scan_f64"] = (
        f"NT={T} {s_ms['NT=4']:.5f}; {note_s}; {note_r}; stamps (NT=1): "
        f"{split['text']}")
    # The Gram entries i > j a block reads, its operands and results once.
    res["serial_scan_f64"] = (err_s, s_ms["NT=1"], s_plain, None, bound_of(
        T * B * (B - 1) // 2 * 8 + (3 * K + 10) * tb + T * 16, ))
    CHAIN_BOUND_MS["serial_scan_f64"] = split["chain_ms"]
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
    prof = profile_phase(sim, dev, wave=1, dtype="float64", top_n=8)

    # (d) cut at 5 with a checkpoint at 3, resumed to the end.
    out = os.path.join(tmp, "resume_f64")
    for stop, resume in ((5, False), (ITERS_F64, True)):
        opt = anchor_options(sim, out, None, stop, "float64")
        opt.checkpoint_every, opt.resume = 3, resume
        _, c = counted(lambda: run_training(opt, device=dev, verbose=False))
        want = f64_counts(nblocks, sweeps=5 if not resume
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
    p3 = predict_case("N=100,000 x 4,096, 2% NAs, float64",
                      *big_predict_operands(dev, gen, torch.float64), N_BIG,
                      card)
    prow = dict(prow, err=max(prow["err"], p2["err"], p3["err"]))
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


# Kernel E's gate beyond the anchor, at 8-byte values: (T, B, K, W) and
# the plan (tables staged, waves of Gram rows staged, traits a CTA) each
# must get.  At B=128 every plan stages the tables and every wave's rows,
# one trait a CTA: T=2, 16, and 33 (33 CTAs); value-sized cp.async copies
# (B=36, W=6: no bulk copy); 16 components.  E_SHAPES_MORE (a generator of
# their own, so the later phases' draws stay as they were): T=8, and B=256,
# where one trait holds the tables and four of its seven waves' rows and
# the later waves fold from global memory.
E_SHAPES = ((2, 128, 4, 32, (1, 3, 1)), (16, 128, 4, 32, (1, 3, 1)),
            (33, 128, 4, 32, (1, 3, 1)), (3, 36, 8, 6, (1, 5, 1)),
            (2, 64, 16, 16, (1, 3, 1)))
E_SHAPES_MORE = ((8, 128, 4, 32, (1, 3, 1)), (4, 256, 4, 32, (1, 4, 1)))
E_ANCHOR_PLAN = (1, 3, 1)
# The plans (tab, gsw, TG) the anchor block is also launched at through
# the raw entry point, each of which must give every trait the bytes of
# E_ANCHOR_PLAN: two and three traits a CTA (everything staged), the
# parent design's one CTA of the four (the tables and wave 0's rows
# staged, waves 1 and 2 folded from L2) and one CTA with nothing staged.
E_GATE_PLANS = ((1, 3, 2), (1, 3, 3), (1, 1, T), (0, 0, T))
# Kernel E's plans timed at T=4 (the anchor) and T=16: one, two and three
# traits a CTA, and the parent design's one CTA (at T=16 it staged
# nothing).
E_TIMED_PLANS = {T: ((1, 3, 1), (1, 3, 2), (1, 3, 3), (1, 1, T)),
                 16: ((1, 3, 1), (1, 3, 2), (1, 3, 3), (0, 0, 16))}
ITERS_F64_WAVE = 10     # the float64 W=32 anchor run (phase 7h)


def e_launch(fn, sweep, c, gs, b, plan, stamps=None):
    """A wave-scan entry point ``fn`` (kernel E's, kernel 3's, or another
    tree's) on block b of a WaveScanSweep's arrays, against c[b] and Gram
    b of gs, at a plan of the caller's ((tab, gsw, TG), or (tab, gsw) for
    an entry that takes no TG).  Not counted: the gates and timings around
    the main path launch it so."""
    import torch
    _, Tv, Bv, Kv = sweep.shape
    err = fn(c.data_ptr(), *sweep.head, gs.data_ptr(), *sweep.tail,
             None if stamps is None else stamps.data_ptr(), b, b, b, Tv, Bv,
             Kv, sweep.wave, *plan, torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"wave scan entry at plan {plan}: launch error {err}")


def sweep_outputs(sweep, b):
    """Block b's results of a scan sweep: dbeta, beta, comp, acum, d."""
    return tuple(x[b].clone() for x in (
        sweep.dbeta, sweep.beta_new, sweep.comp_new, sweep.acum_new,
        sweep.d))


def wave_f64_gate(dev, gen):
    """Kernel E against wave_scan_plain on the card: at the anchor on the
    sweep's 157-block arrays (a middle block and the last, with its 96 pad
    slots) with per-trait Grams at |c| of order 30 and 1e3 (where live
    draws must take the |dlogl| > 700 guard) and the shared Gram at the
    middle block, then at E_SHAPES and E_SHAPES_MORE on one block, at both
    |c|.  Each launch twice (bit-equal), comp exact, dbeta, beta and acum
    within 1e-10 of their largest magnitude, d = msig * dbeta bit for bit,
    the one-block wrapper bit-equal to the sweep interface.  Then the
    middle block through the raw entry point at E_GATE_PLANS (twice each),
    every result byte-equal to E_ANCHOR_PLAN's.  Returns (max abs err, a
    note, the anchor's (sweep, c, {NT: gs}))."""
    import torch
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.ops import scan_kernel_wave as sw
    err = 0.0
    drawn = set()

    def held(where, sweep, ops, c, gs, b, Wv):
        nonlocal err

        def step():
            sweep.step(b, c, gs, b, bc=b)
            return sweep_outputs(sweep, b)
        got = bit_equal_twice(f"wave_scan_f64 ({where})", step)
        base = (c[b] + ops[4][b] * ops[0][:, None]).contiguous()
        blk = (base, *(x[b] for x in ops[1:4]), gs[b],
               *(x[b] for x in ops[4:11]), ops[12])
        want = sw.wave_scan_plain(*blk, Wv)
        if got[0].dtype != torch.float64 or not torch.equal(got[2], want[2]):
            fail(f"wave_scan_f64 ({where}): comp differs from the plain "
                 f"version in {int((got[2] != want[2]).sum())} entries")
        for part, g, w in zip(("dbeta", "beta", "acum"),
                              (got[0], got[1], got[3]),
                              (want[0], want[1], want[3])):
            err = max(err, close64(f"wave_scan_f64 ({where}) {part}", g, w))
        if not torch.equal(got[4], ops[11][b] * got[0]):
            fail(f"wave_scan_f64 ({where}): d is not msig * dbeta bit for "
                 f"bit")
        one = sw.wave_scan(*blk, wave=Wv)
        if not all(torch.equal(x, y) for x, y in zip(one, got)):
            fail(f"wave_scan_f64 ({where}): the one-block wrapper and the "
                 f"sweep interface wrote different bits")
        drawn.update(want[2][ops[9][b] != 0].tolist())
        return want, blk, got

    def guarded(blk, dbeta, live_b, Wv):
        """Live draws where some |L_k - L_i| > 700, each num rebuilt from
        the plain version's dbeta and the folds of the earlier waves."""
        base, lc, rd, gs_b, i2se = blk[0], blk[1], blk[2], blk[4], blk[-1]
        wv = torch.arange(base.shape[1], device=base.device) // Wv
        earlier = (wv[:, None] < wv[None, :]).to(gs_b.dtype)
        num = base + (dbeta[:, :, None] * gs_b * earlier).sum(1)
        logl = lc + rd * num * (num * i2se[:, None])
        spread = logl.max(0).values - logl.min(0).values
        return int(((spread > 700.0) & (live_b != 0)).sum())

    nblocks = -(-MT // B)
    bm = nblocks // 2
    ops, c, gs, live = f64_scan_operands(dev, gen, T, B, K, nblocks, 96)
    sweep = sw.WaveScanSweep(*ops, wave=W)
    if tuple(sweep.plan) != E_ANCHOR_PLAN:
        fail(f"wave_scan_f64: the anchor's plan {sweep.plan}")
    n_guard = 0
    refs = {}
    for scale in (1.0, 40.0):
        for b in (bm, nblocks - 1):
            want, blk, got = held(f"anchor, block {b}, NT={T}, |c| "
                                  f"~{30 * scale:.0f}", sweep, ops,
                                  c * scale, gs["NT=4"], b, W)
            if scale > 1:
                n_guard += guarded(blk, want[0], live[b], W)
            if b == bm:
                refs[(scale, "NT=4")] = got
    refs[(1.0, "NT=1")] = held(f"anchor, block {bm}, NT=1", sweep, ops, c,
                               gs["NT=1"], bm, W)[2]
    if not n_guard:
        fail("wave_scan_f64: no draw at |c| ~1e3 took the 700 guard")
    if not torch.equal(sweep.beta_new[-1][:, B - 96:], ops[4][-1][:, B - 96:]):
        fail("wave_scan_f64: the last block's pad slots moved")
    # Each trait's bytes at every plan, the parent design's included.
    fn = _build.library().gmrm_wave_scan_f64
    for (scale, nt), ref in refs.items():
        cs = c * scale
        for plan in E_GATE_PLANS:
            def run(plan=plan):
                e_launch(fn, sweep, cs, gs[nt], bm, plan)
                return sweep_outputs(sweep, bm)
            got = bit_equal_twice(f"wave_scan_f64 (anchor, plan {plan})",
                                  run)
            if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                fail(f"wave_scan_f64 (anchor, block {bm}, {nt}, |c| "
                     f"~{30 * scale:.0f}): plan {plan} wrote other bytes "
                     f"than plan {E_ANCHOR_PLAN}")
    gen_more = torch.Generator(device=dev)
    gen_more.manual_seed(20261019)
    for shapes, g_ in ((E_SHAPES, gen), (E_SHAPES_MORE, gen_more)):
        for Tv, Bv, Kv, Wv, plan in shapes:
            o2, c2, g2, _ = f64_scan_operands(dev, g_, Tv, Bv, Kv, 1,
                                              min(3, Bv - 1))
            sw2 = sw.WaveScanSweep(*o2, wave=Wv)
            if tuple(sw2.plan) != plan:
                fail(f"wave_scan_f64: plan {sw2.plan} at T={Tv}, B={Bv}, "
                     f"K={Kv}, W={Wv}")
            for scale in (1.0, 40.0):
                held(f"T={Tv}, B={Bv}, K={Kv}, W={Wv}, |c| "
                     f"~{30 * scale:.0f}", sw2, o2, c2 * scale, g2["NT=4"],
                     0, Wv)
            del o2, c2, g2, sw2
    if len(drawn) < 2:
        fail(f"wave_scan_f64: the blocks drew components {drawn} only")
    note = (f"plan at the anchor (tables staged, waves of Gram rows staged, "
            f"traits a CTA) {E_ANCHOR_PLAN}, each trait's bytes equal at "
            f"plans {list(E_GATE_PLANS)}; {n_guard} live draws of the two "
            f"anchor blocks at |c| ~1e3 took the 700 guard; also held at "
            f"(T, B, K, W, plan) {list(E_SHAPES + E_SHAPES_MORE)}, "
            f"per-trait Grams")
    return err, note, (sweep, c, gs)


def e_stamps(fn, sweep, c, gs, b, plan):
    """One stamped launch at a plan: CTA 0's %globaltimer at
    scan_kernel_wave.wave_stamp_names' events, us from the start."""
    import torch
    from gmrm_tpu_torch.ops import scan_kernel_wave as sw
    nw = sweep.shape[2] // sweep.wave
    st = torch.zeros(2 + 2 * nw, dtype=torch.int64, device=c.device)
    e_launch(fn, sweep, c, gs, b, plan, st)
    torch.cuda.synchronize()
    return dict(zip(sw.wave_stamp_names(nw),
                    ((st - st[0]).double() / 1e3).tolist()))


def e_chain(stamps):
    """The chain of a stamped launch after its operands are in: each
    wave's draw (from the fold before it) and chain fold, us; the chain,
    their sum; and the chain bound, us: B/W draws and B/W - 1 chain folds
    each at the least that one took (the dependent steps of a wave, with
    no wait for its rows and no first pass through the code)."""
    nw = (len(stamps) - 2) // 2
    draws, folds, t = [], [], stamps["operands staged"]
    for w in range(nw):
        draws.append(stamps[f"wave {w} drawn"] - t)
        t = stamps[f"wave {w} folded"]
        folds.append(t - stamps[f"wave {w} drawn"])
    bound = nw * min(draws) + (nw - 1) * min(folds[:-1] or [0.0])
    return draws, folds, t - stamps["operands staged"], bound


def e_sweep_order_ms(fn, sweep, c, gs, plan, reps=3):
    """A scan entry over every block of the sweep's arrays in processing
    order, block b against Gram b of the run gs: ms a block, the median of
    ``reps`` replays of one CUDA graph of the launches, each replay right
    after the run is rewritten in place (gs *= 1), as kernel A writes a
    run before the scans read it (the run's head out of L2, its last ~50 MB
    in it)."""
    import torch
    nb = sweep.shape[0]

    def every_block():
        for b in range(nb):
            e_launch(fn, sweep, c, gs, b, plan)
    every_block()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        every_block()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        gs.mul_(1.0)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / nb)
    return sorted(times)[reps // 2]


def wave_f64_times(sweep, c, gs, b):
    """Kernel E's ms a block at block b (graph replay) with the shared Gram
    (NT=1) and per-trait Grams (NT=4), its plain version's, kernel 3 on
    the same operands cast to float32 (NT=1), and the bound: the block's
    operands and outputs once and the Gram rows a fold reads, of the waves
    that moved a marker; operations those folds and the draws, at the
    float64 peak.  Then per plan of E_TIMED_PLANS at T=4 and T=16
    (seeded operands of the anchor's shapes, 157 blocks): ms a block
    alone (graph replay, NT=1), in sweep order against a rewritten Gram
    run (NT=1; NT=4 too at T=4) and one stamped launch.  The chain bound
    (E_ANCHOR_PLAN's stamped chain at the anchor) goes into
    CHAIN_BOUND_MS."""
    import torch
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.ops import scan_kernel_wave as sw
    ms = {nt: cuda_ms(lambda g=g: sweep.step(b, c, g, b, bc=b), 20)
          for nt, g in gs.items()}
    ops_b = [x[b] for x in sweep.state]
    base = (c[b] + ops_b[0] * sweep.nm1[:, None]).contiguous()
    blk = (base, *(x[b] for x in sweep.tables), gs["NT=1"][b], *ops_b,
           sweep.i2se)
    plain = cuda_ms(lambda: sw.wave_scan_plain(*blk, sweep.wave), 1)
    f32 = [x.float() if x.is_floating_point() else x
           for x in (sweep.nm1, *sweep.tables, *sweep.state, sweep.msig_p,
                     sweep.i2se)]
    sweep3 = sw.WaveScanSweep(*f32, wave=sweep.wave)
    c3, gs3 = c.float(), gs["NT=1"].float()
    k3 = cuda_ms(lambda: sweep3.step(b, c3, gs3, b, bc=b), 20)
    del sweep3, c3, gs3, f32
    db = sweep.dbeta[b]
    Wv = sweep.wave
    nw = B // Wv
    moved = [w for w in range(nw - 1)
             if (db[:, w * Wv:(w + 1) * Wv] != 0).any()]
    fold = sum(T * Wv * (B - (w + 1) * Wv) for w in moved)
    tb = T * B * 8
    # Ten float64 arrays (c, beta, acum, u, z, msig in; dbeta, d, beta,
    # acum out) and four int32 ones (comp, live, zerob in; comp out).
    bound = bound_of(3 * K * tb + 10 * tb + 4 * T * B * 4 + 2 * T * 8
                     + fold * 8,
                     (2 * fold + T * B * K * 12, F64_OPS))
    fn = _build.library().gmrm_wave_scan_f64
    gen16 = torch.Generator(device=c.device)
    gen16.manual_seed(20261020)
    o16, c16, g16, _ = f64_scan_operands(c.device, gen16, 16, B, K,
                                         sweep.shape[0], 96)
    runs = {T: (sweep, c, gs), 16: (sw.WaveScanSweep(*o16, wave=Wv), c16,
                                    g16)}
    plans = {}
    for Tv, (sw_, c_, gs_) in runs.items():
        for plan in E_TIMED_PLANS[Tv]:
            row = {"alone": cuda_ms(lambda: e_launch(
                fn, sw_, c_, gs_["NT=1"], b, plan), 20)}
            for nt in (("NT=1", "NT=4") if Tv == T else ("NT=1",)):
                row[f"sweep order {nt}"] = e_sweep_order_ms(
                    fn, sw_, c_, gs_[nt], plan)
            row["stamps"] = e_stamps(fn, sw_, c_, gs_["NT=1"], b, plan)
            plans[(Tv, plan)] = row
    del runs, o16, c16, g16
    CHAIN_BOUND_MS["wave_scan_f64"] = e_chain(
        plans[(T, E_ANCHOR_PLAN)]["stamps"])[3] / 1e3
    return ms, plain, k3, plans, bound


def float64_wave_phase(sim, small, dev, tmp, card, gen):
    """Phase 7h: --dtype float64 --wave-size 32 (the composed wave path on
    kernels A, B and E).  (a) kernel E alone (``wave_f64_gate``,
    ``wave_f64_times``); (b) one float64 W=32 sweep on the small panel on
    the card against the plain float64 sweep on the host CPU, same uniform
    order and draws, on one device and at S=2; (c) run_training at the
    anchor twice from one seed (byte-equal), launches per
    ``f64_counts(wave=32)`` (no Gram cache, no float32 kernel), h2 in
    (0.05, 0.95), peak memory, ms/iteration, and a profiler window over 5
    float64 W=32 iterations; (d) the chain cut at 5 (a checkpoint at 3)
    and resumed to the end, byte-equal; (e) run_training_sharded at S=2.
    Returns (kernel E's row, the path's launches, the phase's numbers)."""
    import numpy as np
    import torch
    from gmrm_tpu_torch.runner import run_training

    t_phase = time.perf_counter()
    err, note, (sweep, c_n, gs_n) = wave_f64_gate(dev, gen)
    nblocks = -(-MT // B)
    ms, plain, k3, plans, bound = wave_f64_times(sweep, c_n, gs_n,
                                                 nblocks // 2)
    del sweep, c_n, gs_n
    print(f"# wave_scan_f64: max abs err {err:.3e}; kernel ms a block (CUDA "
          f"graph replay) NT=1 {ms['NT=1']:.5f}, NT={T} {ms['NT=4']:.5f}; "
          f"plain ms {plain:.4f}; kernel 3 (float32) on the same block cast "
          f"to float32 {k3:.5f}; bound {bound[0]:.5f} ms by {bound[1]}; "
          f"chain bound {CHAIN_BOUND_MS['wave_scan_f64']:.5f} ms; {note}  "
          f"[{card}]", flush=True)
    print_e_plans(plans, card)
    sweep_gate(small, dev, W, f"float64 W={W} sweep gate", card,
               dtype="float64")
    sharded_gate(small, dev, card, 2, W, f"float64 sharded W={W} sweep gate",
                 dtype="float64")
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    runs = [training_phase(sim, dev, tmp, W, ITERS_F64_WAVE, dtype="float64",
                           tag=tag) for tag in ("", "_again")]
    res, counts, steady, h2, peak = runs[0]
    add(counts)
    add(runs[1][1])
    f32_kernels = {k for k, v in counts.items()
                   if v and not k.endswith("_f64")}
    if f32_kernels:
        fail(f"float64 W={W} training launched float32 kernels "
             f"{f32_kernels}")
    if res.state.eps.dtype != torch.float64 or not (
            np.isfinite(h2).all() and (h2 > 0.05).all()
            and (h2 < 0.95).all()):
        fail(f"float64 W={W} training: dtype {res.state.eps.dtype}, h2 {h2}")
    ref = os.path.join(tmp, f"out_w{W}_f64")
    if not same_artifacts(sim, ref, ref + "_again"):
        fail(f"float64 W={W} training: two runs of one seed wrote other "
             f"bytes")
    prof = profile_phase(sim, dev, wave=W, dtype="float64", top_n=8)
    out = os.path.join(tmp, f"resume_f64_w{W}")
    for stop, resume in ((5, False), (ITERS_F64_WAVE, True)):
        opt = anchor_options(sim, out, W, stop, "float64")
        opt.checkpoint_every, opt.resume = 3, resume
        _, c = counted(lambda: run_training(opt, device=dev, verbose=False))
        want = f64_counts(nblocks, sweeps=ITERS_F64_WAVE - 3 if resume
                          else 5, wave=W)
        if c != want:
            fail(f"float64 W={W} resume: launches {c}, expected {want}")
        add(c)
    if not same_artifacts(sim, ref, out):
        fail(f"float64 W={W} resume: the resumed chain wrote other bytes "
             f"than the uninterrupted one")
    sh = sharded_training_phase(sim, dev, tmp, 2, W, ITERS_F64_WAVE,
                                dtype="float64")
    add(sh[1])
    numbers = dict(steady=steady, h2=h2, peak=peak, profile=prof,
                   startup=res.startup_seconds, sharded=sh, k3_ms=k3,
                   seconds=time.perf_counter() - t_phase)
    return (err, ms["NT=1"], plain, None, bound), launches, numbers


def print_e_plans(plans, card):
    """Kernel E per plan (``wave_f64_times``): its ms a block alone and in
    sweep order, one stamped launch's events and its chain, in us and in
    cycles at the SM clock nvidia-smi reads right after."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    mhz, mhz_max = (float(x) for x in smi.stdout.split(",")[:2])
    for (Tv, plan), row in plans.items():
        draws, folds, chain, bound = e_chain(row["stamps"])
        times = ", ".join(f"{k} {v:.5f}" for k, v in row.items()
                          if k != "stamps")
        events = ", ".join(f"{k} {v:.2f}" for k, v in row["stamps"].items())
        print(f"# wave_scan_f64 T={Tv} plan {plan} ({-(-Tv // plan[2])} "
              f"CTAs): ms a block {times}; stamps, us from the start: "
              f"{events}; chain {chain:.2f} us = {chain * mhz:.0f} cycles at "
              f"{mhz:.0f} MHz (max {mhz_max:.0f}): draws "
              f"{[round(x * mhz) for x in draws]}, chain folds "
              f"{[round(x * mhz) for x in folds]} cycles; chain bound "
              f"{bound:.2f} us = {bound * mhz:.0f} cycles  [{card}]",
              flush=True)


# A tree's wave-scan plans for --wave64-pairs, printed as JSON by a process
# of that tree's own package: the argument count of gmrm_wave_scan, and
# kernel 3's and kernel E's plans at the shapes asked (E's None where the
# tree has no kernel E; a tree before the trait-group grid plans (tab, gsw)).
WAVE_PLAN_CODE = """
import json, sys
sys.path.insert(0, sys.argv[1])
from gmrm_tpu_torch.ops import _build, scan_kernel_wave as sw
shapes = json.loads(sys.argv[2])
f64 = "gmrm_wave_scan_f64" in _build.SIGNATURES
plan = getattr(sw, "launch_plan", sw.wave_plan)
print(json.dumps({
    "nargs": len(_build.SIGNATURES["gmrm_wave_scan"]),
    "f32": [list(plan(*s)) for s in shapes],
    "f64": [list(sw.launch_plan(*s, 8)) if f64 else None for s in shapes]}))
"""


def ptxas_summary(log):
    """Registers, stack frame and spills of each K <= 4 wave-scan kernel
    in an nvcc -Xptxas=-v log, by value type, tables staged and stamps."""
    out = []
    for name, (regs, stack, st, ld) in ptxas_resources(log).items():
        m = re.search(r"wave_scan_kernelI([fd]?)Li4ELb([01])ELb([01])E", name)
        if m:
            out.append(f"{'E' if m.group(1) == 'd' else '3'} tab={m.group(2)}"
                       f" st={m.group(3)}: {stack} bytes stack, {st} bytes "
                       f"spill stores, {ld} bytes spill loads, {regs} "
                       f"registers")
    return "; ".join(out)


def wave_libraries(trees, tmp):
    """This tree's ("." first) and each TREE's csrc/wave_scan.cu built
    alone with this tree's nvcc flags, all at once, into tmp and loaded,
    with each tree's plans (WAVE_PLAN_CODE) at T=4 and T=16 of the
    anchor's shapes: {label: (library, plans)}."""
    import ctypes
    from gmrm_tpu_torch.ops import _build
    roots = {".": str(_build.CSRC.parent.parent),
             **{t: os.path.abspath(t) for t in trees}}
    shapes = json.dumps([(T, B, K, W), (16, B, K, W)])
    procs = {}
    for i, (label, root) in enumerate(roots.items()):
        csrc = os.path.join(root, "gmrm_tpu_torch", "csrc")
        so = os.path.join(tmp, f"wave{i}.so")
        procs[label] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-shared",
             "-o", so, os.path.join(csrc, "wave_scan.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            subprocess.Popen([sys.executable, "-c", WAVE_PLAN_CODE, root,
                              shapes], stdout=subprocess.PIPE, text=True))
    out = {}
    for label, (so, build, plan) in procs.items():
        log = build.communicate(timeout=900)[0]
        text = plan.communicate(timeout=300)[0]
        if build.returncode or plan.returncode:
            fail(f"wave pairs: {label}'s wave_scan.cu or plans failed:\n"
                 f"{log[-3000:]}")
        print(f"# wave pairs, {label}: {ptxas_summary(log)}", flush=True)
        info = json.loads(text.strip().splitlines()[-1])
        lib = ctypes.CDLL(so)
        for fn in ("gmrm_wave_scan", "gmrm_wave_scan_f64"):
            if hasattr(lib, fn):
                f = getattr(lib, fn)
                f.argtypes = ([ctypes.c_void_p] * 21
                              + [ctypes.c_int] * (info["nargs"] - 22)
                              + [ctypes.c_void_p])
                f.restype = ctypes.c_int
        out[label] = (lib, info)
    return out


def wave64_pairs(dev, card, trees, pairs, tmp):
    """``--wave64-pairs N --against TREE`` (repeatable): kernel E and
    kernel 3 of this tree and of each TREE, each tree's csrc/wave_scan.cu
    built alone (``wave_libraries``) and launched at the plan of that
    tree's own package, in one process.  Seeded float64 operands of the
    anchor's shapes (157 blocks, the last with 96 pad slots, an adaV
    group) at T=4 and T=16, and kernel 3 on the T=4 ones cast to float32.
    This tree's E also at two and three traits a CTA (". TG=2", ". TG=3").
    Held first: every variant of this tree byte-equal to its launch plan's
    bytes, every TREE's E with this tree's comp and values within 1e-10 of
    the largest magnitude; kernel 3's bytes against this tree's are
    printed.  Then N pairs, the variants in turn (in the listed order in
    the even pairs, reversed in the odd ones): E at the anchor, block 78,
    NT=1 and NT=4 alone (graph replay of 20), at T=16 alone, in sweep
    order over the 157 blocks against a rewritten Gram run (NT=1, T=4 and
    T=16; ``e_sweep_order_ms``), and kernel 3 alone.  Prints every pair
    and, per case and TREE, both ranges and in how many pairs this tree
    read below all of TREE's readings."""
    import torch
    from gmrm_tpu_torch.ops import scan_kernel_wave as sw
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261018)
    nblocks = -(-MT // B)
    bm = nblocks // 2
    data = {}
    for Tv in (T, 16):
        ops, c, gs, _ = f64_scan_operands(dev, gen, Tv, B, K, nblocks, 96)
        data[Tv] = (sw.WaveScanSweep(*ops, wave=W), c, gs["NT=1"],
                    gs["NT=4"])
    s4 = data[T][0]
    f32 = [x.float() if x.is_floating_point() else x
           for x in (s4.nm1, *s4.tables, *s4.state, s4.msig_p, s4.i2se)]
    k3 = (sw.WaveScanSweep(*f32, wave=W), data[T][1].float(),
          data[T][2].float())
    libs = wave_libraries(trees, tmp)
    variants = {}        # label -> (E entry or None, {T: plan}, 3's, plan)
    for label, (lib, info) in libs.items():
        fe = getattr(lib, "gmrm_wave_scan_f64", None)
        variants[label] = (fe if info["f64"][0] else None,
                           {T: info["f64"][0], 16: info["f64"][1]},
                           lib.gmrm_wave_scan, info["f32"][0])
    fe, p_e = variants["."][:2]
    for tg in (2, 3):
        variants[f". TG={tg}"] = (fe, {Tv: (*p[:2], tg)
                                       for Tv, p in p_e.items()}, None, None)
    for Tv, (sweep, c, gs1, _) in data.items():
        outs = {}
        for label, (f, plans, _, _) in variants.items():
            if f is not None:
                e_launch(f, sweep, c, gs1, bm, plans[Tv])
                outs[label] = sweep_outputs(sweep, bm)
        for label, got in outs.items():
            ref = outs["."]
            if label.startswith("."):
                same = all(torch.equal(x, y) for x, y in zip(got, ref))
                if not same:
                    fail(f"wave pairs, T={Tv}: {label} wrote other bytes "
                         f"than .")
                continue
            if not torch.equal(got[2], ref[2]):
                fail(f"wave pairs, T={Tv}: {label}'s comp differs")
            for g, r in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
                close64(f"wave pairs, T={Tv}, {label}", g, r)
    outs = {}
    for label, (_, _, f3, p3) in variants.items():
        if f3 is not None:
            e_launch(f3, *k3, bm, p3)
            outs[label] = sweep_outputs(k3[0], bm)
    for label, got in outs.items():
        same = all(torch.equal(x, y) for x, y in zip(got, outs["."]))
        print(f"# wave pairs: kernel 3 of {label} at plan "
              f"{variants[label][3]}: bytes {'' if same else 'NOT '}equal "
              f"to this tree's; E plans {variants[label][1]}", flush=True)
    for label, (f, plans, f3, p3) in variants.items():
        for name, fn, run, plan in (
                ("E", f, data[T][:3], plans[T]),
                ("kernel 3", f3, k3, p3)):
            if fn is None:
                continue
            st = e_stamps(fn, *run, bm, plan)
            print(f"# wave pairs: {name} of {label} at plan {plan}, T={T}, "
                  f"stamps, us from the start: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in st.items()),
                  flush=True)
    cases = {
        "E anchor NT=1 alone": lambda f, p: cuda_ms(lambda: e_launch(
            f, data[T][0], data[T][1], data[T][2], bm, p[T]), 20),
        "E anchor NT=4 alone": lambda f, p: cuda_ms(lambda: e_launch(
            f, data[T][0], data[T][1], data[T][3], bm, p[T]), 20),
        "E T=16 NT=1 alone": lambda f, p: cuda_ms(lambda: e_launch(
            f, data[16][0], data[16][1], data[16][2], bm, p[16]), 20),
        "E anchor NT=1 sweep order": lambda f, p: e_sweep_order_ms(
            f, data[T][0], data[T][1], data[T][2], p[T]),
        "E T=16 NT=1 sweep order": lambda f, p: e_sweep_order_ms(
            f, data[16][0], data[16][1], data[16][2], p[16]),
        "kernel 3 anchor NT=1 alone": None,
    }
    ms = {(case, label): [] for case in cases for label in variants}
    labels = list(variants)
    for i in range(pairs):
        order = labels if i % 2 == 0 else labels[::-1]
        for case, timed in cases.items():
            read = []
            for label in order:
                fe_, pe, f3, p3 = variants[label]
                if timed is None and f3 is not None:
                    x = cuda_ms(lambda: e_launch(f3, *k3, bm, p3), 20)
                elif timed is not None and fe_ is not None:
                    x = timed(fe_, pe)
                else:
                    continue
                ms[(case, label)].append(x)
                read.append(f"{label} {x:.5f}")
            print(f"# wave pair {i + 1}, {case}: {', '.join(read)} ms a "
                  f"block", flush=True)
    for (case, label), xs in ms.items():
        if not xs:
            continue
        mine = ms[(case, ".")]
        wins = (f"; this tree below all of its readings in "
                f"{sum(x < min(xs) for x in mine)} of {len(mine)} pairs"
                if label != "." else "")
        print(f"# wave pairs, {case}: {label} {min(xs):.5f}-{max(xs):.5f} "
              f"ms a block over {len(xs)} pairs{wins}  [{card}]", flush=True)


def wave64_only(dev, card):
    """``--wave64-only``: phase 7h alone."""
    import torch
    from gmrm_tpu_torch.ops import _build
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261018)
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ProcessPoolExecutor(
                2, mp_context=multiprocessing.get_context("spawn"),
                initializer=one_thread) as pool:
            sims = [pool.submit(make, os.path.join(tmp, name))
                    for name, make in (("data", anchor_dataset),
                                       ("small", small_dataset))]
            t0 = time.perf_counter()
            _build.library()
            print(f"# build: {time.perf_counter() - t0:.1f} s", flush=True)
            sim, small = (f.result() for f in sims)
        _, launches, num = float64_wave_phase(sim, small, dev, tmp, card, gen)
        print_wave64(num, launches, card)


def print_wave64(num, launches, card):
    """Phase 7h's summary lines."""
    busy, wall, calls, top = num["profile"]
    res_sh, launch_sh, steady_sh, span_sh, h2_sh, _ = num["sharded"]
    print(f"# float64 training W={W} at the anchor: startup "
          f"{num['startup']:.2f} s (no Gram cache); steady "
          f"{num['steady'] * 1e3:.2f} ms/iteration = "
          f"{MT / num['steady']:.0f} markers/s over iterations {THIN + 1}-"
          f"{ITERS_F64_WAVE}; h2 {[round(float(x), 3) for x in num['h2']]}; "
          f"peak device memory {num['peak'] / 2**20:.1f} MiB; two runs of "
          f"one seed and the chain cut at 5 and resumed byte-equal; no "
          f"float32 kernel launched  [{card}]", flush=True)
    print(f"# profiler, float64 W={W} path, 5 iterations: device busy "
          f"{busy:.3f} ms/iteration, wall {wall:.3f} ms/iteration, idle "
          f"share {1 - busy / wall:.3f}, {calls:.1f} launches per iteration; "
          f"busiest kernels (ms/iteration) {top}  [{card}]", flush=True)
    print(f"# float64 sharded training S=2, W={W} (all shards on the one "
          f"card): {steady_sh * 1e3:.2f} ms/iteration over {span_sh}; h2 "
          f"{[round(float(x), 3) for x in h2_sh]}; launches {launch_sh}  "
          f"[{card}]", flush=True)
    print(f"# phase 7h (float64 W={W}) wall {num['seconds']:.1f} s; launches "
          f"{launches}", flush=True)


# Kernels A-E: source, the TPU kernel whose float64 side each is, and the
# JAX package's float64 route that it replaces (kernel B's three launches
# are the template of csrc/block_passes.cuh at double; the fused pass also
# replaces pallas_kernels.py:275, F64_ALSO_REPLACES).
F64_SOURCES = {
    "block_gram_f64": ("gmrm_tpu_torch/csrc/block_gram.cu",
                       "gmrm_tpu/ops/pallas_kernels.py:135",
                       "gmrm_tpu/ops/blockops.py:131"),
    "block_cdot_f64": ("gmrm_tpu_torch/csrc/block_cdot.cu",
                       "gmrm_tpu/ops/pallas_kernels.py:275",
                       "gmrm_tpu/ops/blockops.py:131"),
    "eps_update_f64": ("gmrm_tpu_torch/csrc/eps_update.cu",
                       "gmrm_tpu/ops/pallas_kernels.py:352",
                       "gmrm_tpu/ops/blockops.py:141"),
    "update_cdot_f64": ("gmrm_tpu_torch/csrc/update_cdot.cu",
                        "gmrm_tpu/ops/pallas_kernels.py:352",
                        "gmrm_tpu/ops/blockops.py:141"),
    "serial_scan_f64": ("gmrm_tpu_torch/csrc/serial_scan.cu",
                        "gmrm_tpu/ops/scan_kernel.py:61",
                        "gmrm_tpu/sampler/scan.py:33"),
    "predict_sums_f64": ("gmrm_tpu_torch/csrc/predict_sums.cu",
                         "gmrm_tpu/predict.py:43", "gmrm_tpu/predict.py:43"),
    # The JAX package's float64 W>1 run scans through this wrapper, which
    # narrows the scan to float32; kernel E computes it in double.
    "wave_scan_f64": ("gmrm_tpu_torch/csrc/wave_scan.cu",
                      "gmrm_tpu/ops/scan_kernel_wave.py:57",
                      "gmrm_tpu/ops/scan_kernel_wave.py:196"),
}


F64_ALSO_REPLACES = {"update_cdot_f64": "gmrm_tpu/ops/pallas_kernels.py:275"}

# Phase 8, trait chunks (``--traits-only``): the trait counts of its timing
# runs, their iterations, and its datasets: the anchor's N and markers with
# 32 phenotypes (subsets of 8 and 16 of them), with 16 phenotypes and 2%
# NAs (NT = 16), and the small panel with 33 phenotypes and 2% NAs.
TRAIT_TIMING = (8, 16, 32)
ITERS_TRAITS = 10
T_GATE, T_SMALL = 16, 33
# The most float32 ulps of u from its CDF boundary at which a draw of the
# T=33 W=32 sweep may go the other way from the plain version's.
TIE_ULPS = 4


def traits_anchor(tmp):
    """The anchor's N and markers with 32 phenotypes, seed 171014."""
    import numpy as np
    from gmrm_tpu_torch.io.sim import simulate
    return simulate(tmp, n=N, m=MT, n_traits=32, n_causal=MT // 4, h2=0.5,
                    n_groups=1, na_rate=0.0, seed=171014,
                    mixtures=np.array([0.0, 0.0001, 0.001, 0.01]))


def traits_anchor_na(tmp):
    """The anchor with 16 phenotypes of 2% NAs (NT = 16), seed 171014."""
    import numpy as np
    from gmrm_tpu_torch.io.sim import simulate
    return simulate(tmp, n=N, m=MT, n_traits=T_GATE, n_causal=MT // 4,
                    h2=0.5, n_groups=1, na_rate=0.02, seed=171014,
                    mixtures=np.array([0.0, 0.0001, 0.001, 0.01]))


def traits_small(tmp):
    """The small panel (N=10,000, 4,096 markers) with 33 phenotypes of 2%
    NAs (NT = 33), seed 171015."""
    import numpy as np
    from gmrm_tpu_torch.io.sim import simulate
    return simulate(tmp, n=N, m=MT_SMALL, n_traits=T_SMALL,
                    n_causal=MT_SMALL // 4, h2=0.5, n_groups=1,
                    na_rate=0.02, seed=171015,
                    mixtures=np.array([0.0, 0.0001, 0.001, 0.01]))


def traits_small16(tmp):
    """The small panel with 16 phenotypes and no NAs (NT = 1), seed
    171014: the W=1 gates' panel at T=16, the anchor cut to 32 blocks."""
    import numpy as np
    from gmrm_tpu_torch.io.sim import simulate
    return simulate(tmp, n=N, m=MT_SMALL, n_traits=T_GATE,
                    n_causal=MT_SMALL // 4, h2=0.5, n_groups=1, na_rate=0.0,
                    seed=171014,
                    mixtures=np.array([0.0, 0.0001, 0.001, 0.01]))


TRAIT_DATASETS = (("traits32", traits_anchor), ("traits16na", traits_anchor_na),
                  ("traits33", traits_small), ("traits16", traits_small16))


# The trait axis of each sweep_blocks operand (None: shared by the traits;
# the Gram cache and na only with a mask a trait).
SWEEP_TRAIT_AXES = dict(
    bed=None, blkidx=None, win_p=None, m_local=None, gram_cache=1, eps=0,
    na=0, mave=0, msig=0, beta_old=0, comp_old=0, acum_old=0, grp=None,
    u_p=1, z_p=1, sigmag=0, lc=1, rd=1, sqb=1, i2se=0, nonas=0)
# The trait axis of each argument of the one-block scan wrappers.
SCAN_TRAIT_AXES = (0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0)


def trait_slice(x, axis, t0, t1):
    return x if axis is None else x.narrow(axis, t0, t1 - t0).contiguous()


def chunk_gates(dev, gen, card):
    """Phase 8b: every launch of a trait chunk bit-equal to the same kernel
    run on that chunk's traits alone (their contiguous copies): kernels 7/8
    (a whole anchor sweep of 16 traits, two launches of 8) and 9 (one block
    step of 16), at NT=1 and NT=16; the passes at 48 traits (B=128: two
    launches of 24; float64, B: three of 16); kernel 6 at 33 traits (a grid
    of trait groups of 8 against one CTA of a group) and kernel 3 at 48 (two
    groups of 24)."""
    import torch
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.ops import block_kernels as bk
    from gmrm_tpu_torch.ops import scan_kernel as sk6
    from gmrm_tpu_torch.ops import scan_kernel_wave as sw
    from gmrm_tpu_torch.ops import sweep_kernel as sk
    from gmrm_tpu_torch.ops.trait_chunks import trait_chunks

    i32 = torch.int32
    report = []

    def same(name, full, parts, chunks, axis=0):
        for (t0, t1), part in zip(chunks, parts):
            for i, (f, p) in enumerate(zip(full, part)):
                if not torch.equal(trait_slice(f, axis, t0, t1), p):
                    fail(f"chunk gate {name}: output {i} of traits {t0}.."
                         f"{t1 - 1} differs from the chunk alone")

    def counted(fn):
        _build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in launch_counts().items() if v}

    nT = T_GATE
    for shared in (True, False):
        static, st, blk, win, (u, z) = sweep_operands(dev, gen, shared,
                                                      traits=nT)
        nt = static.gram_cache.shape[1]
        tables = sk.build_sweep_tables(st["sigmag"], st["sigmae"], st["pi"],
                                       static.cva, static.cvai, static.nonas,
                                       static.n_total)
        ops = dict(bed=static.bed, blkidx=blk.to(i32),
                   win_p=win.to(i32).contiguous(), m_local=static.m_local,
                   gram_cache=static.gram_cache, eps=st["eps"],
                   na=static.na[:nt].contiguous(), mave=static.mave,
                   msig=static.msig, beta_old=st["betas"],
                   comp_old=st["comp"], acum_old=st["acum"],
                   grp=static.group_of.to(i32), u_p=u, z_p=z,
                   sigmag=st["sigmag"], lc=tables[0], rd=tables[1],
                   sqb=tables[2], i2se=(1.0 / (2.0 * st["sigmae"])),
                   nonas=static.nonas)
        chunks = trait_chunks("sweep_blocks", nT, B)

        def of(t0, t1):
            return {k: (v if (nt == 1 and k in ("gram_cache", "na"))
                        else trait_slice(v, SWEEP_TRAIT_AXES[k], t0, t1))
                    for k, v in ops.items()}

        def sweep(o):
            args = [o[k] for k in SWEEP_TRAIT_AXES]
            args[5] = args[5].clone()
            return sk.sweep_blocks(*args, wave=W)

        def step(o, b=0):
            beta, comp, acum = (o[k].clone() for k in
                                ("beta_old", "comp_old", "acum_old"))
            deps = sk.block_sweep(
                o["blkidx"][b], o["m_local"], o["bed"], o["win_p"][b],
                o["gram_cache"], o["eps"], o["na"], o["mave"], o["msig"],
                beta, comp, acum, o["grp"], o["u_p"][b], o["z_p"][b],
                o["sigmag"], o["lc"], o["rd"], o["sqb"], o["i2se"],
                o["nonas"], wave=W)[0]
            return deps, beta, comp, acum

        for name, fn, kernel in (("sweep_blocks", sweep, "sweep_blocks"),
                                 ("block_sweep", step, "block_sweep")):
            full, n_full = counted(lambda: fn(ops))
            parts = []
            for t0, t1 in chunks:
                part, n_part = counted(lambda: fn(of(t0, t1)))
                if n_part != {kernel: 1}:
                    fail(f"chunk gate {name}: a chunk alone launched "
                         f"{n_part}")
                parts.append(part)
            if n_full != {kernel: len(chunks)}:
                fail(f"chunk gate {name}: {nT} traits launched {n_full}")
            same(f"{name} (NT={nt})", full, parts, chunks)
            report.append(f"{name} T={nT} NT={nt}: {len(chunks)} launches "
                          f"of {chunks[0][1]}")
        del static, st, ops

    for dtype in (torch.float32, torch.float64):
        nP, nb = 48, 2
        es = torch.tensor([], dtype=dtype).element_size()
        bed = torch.randint(0, 256, ((nb + 1) * B, MB), generator=gen,
                            device=dev, dtype=torch.uint8)
        rows = torch.stack([B + b * B + torch.randperm(B, generator=gen,
                                                       device=dev)
                            for b in range(nb)]).to(i32)
        na = (torch.rand((nP, 4, MB), generator=gen, device=dev)
              > 0.03).to(dtype)
        eps0 = torch.randn((nP, 4, MB), generator=gen, device=dev,
                           dtype=dtype) * na
        mave = torch.rand((nb, nP, B), generator=gen, device=dev,
                          dtype=dtype) * 1.6 + 0.2
        msig = torch.rand((nb, nP, B), generator=gen, device=dev,
                          dtype=dtype) * 1.5 + 0.5
        d = torch.randn((nb, nP, B), generator=gen, device=dev,
                        dtype=dtype) * 0.05
        chunks = trait_chunks("passes", nP, B, mb=MB, es=es)

        def passes(t0, t1):
            s = slice(t0, t1)
            ps = bk.BlockPasses(bed, rows, mave[:, s].contiguous(),
                                msig[:, s].contiguous(), na[s].contiguous())
            eps = eps0[s].clone()
            ps.cdot(0, eps)
            ps.update_cdot_(0, d[:, s].contiguous(), eps)
            ps.update_(1, d[:, s].contiguous(), eps)
            return ps.c.movedim(1, 0), eps

        sfx = "_f64" if dtype == torch.float64 else ""
        full, n_full = counted(lambda: passes(0, nP))
        parts = [passes(t0, t1) for t0, t1 in chunks]
        want = {f"block_cdot{sfx}": len(chunks),
                f"update_cdot{sfx}": len(chunks),
                f"eps_update{sfx}": len(chunks)}
        if len(chunks) < 2 or n_full != want:
            fail(f"chunk gate passes {dtype}: {chunks}, launches {n_full}")
        same(f"passes {dtype}", full, parts, chunks)
        report.append(f"passes T={nP} {dtype}: {len(chunks)} launches of "
                      f"{chunks[0][1]}")

    for kernel, nS, Bs in (("serial_scan", T_SMALL, B), ("wave_scan", 48, B)):
        vargs, _ = scan_case(dev, gen, nS, Bs, K)
        TG = (sk6.launch_plan(nS, Bs, K) if kernel == "serial_scan"
              else sw.launch_plan(nS, Bs, K, W))[-1]
        chunks = [(t0, min(nS, t0 + TG)) for t0 in range(0, nS, TG)]

        def scan(args):
            if kernel == "serial_scan":
                return sk6.serial_scan(*args)
            return sw.wave_scan(*args, wave=W)

        full, n_full = counted(lambda: scan(vargs))
        parts = [scan([trait_slice(x, ax, t0, t1) for x, ax in
                       zip(vargs, SCAN_TRAIT_AXES)]) for t0, t1 in chunks]
        if len(chunks) < 2 or n_full != {kernel: 1}:
            fail(f"chunk gate {kernel}: {chunks}, launches {n_full}")
        same(kernel, full, parts, chunks)
        report.append(f"{kernel} T={nS}: a grid of {len(chunks)} trait "
                      f"groups of {chunks[0][1]}")
    print(f"# chunk gates (phase 8b): every chunked launch bit-equal to its "
          f"kernel on that chunk's traits alone: {'; '.join(report)}  "
          f"[{card}]", flush=True)


def sweep_width_gate(dev, gen, card, widths=(5, 6, 7)):
    """Phase 8b': kernels 7/8 at the launch widths a chunked run gives
    besides 4 and 8 (33 traits: 7 and 5), on the small panel's shapes
    with a mask a trait, against the plain sweep on the card: comp and
    cass exact, beta and eps within 1e-4; a mismatch reports the least
    margin |u - cdf| of the draws it hit."""
    import torch
    from gmrm_tpu_torch.ops import sweep_kernel as sk
    from gmrm_tpu_torch.sampler.gibbs import _natural_cass
    i32 = torch.int32
    out = []
    for nT in widths:
        static, st, blk, win, (u, z) = sweep_operands(
            dev, gen, False, mt=MT_SMALL, traits=nT)
        nt = static.gram_cache.shape[1]
        m_pad = static.bed.shape[0]
        tables = sk.build_sweep_tables(st["sigmag"], st["sigmae"], st["pi"],
                                       static.cva, static.cvai, static.nonas,
                                       static.n_total)
        ops = (static.bed, blk.to(i32), win.to(i32).contiguous(),
               static.m_local, static.gram_cache, None,
               static.na[:nt].contiguous(), static.mave, static.msig,
               st["betas"], st["comp"], st["acum"], static.group_of, u, z,
               st["sigmag"], *tables, 1.0 / (2.0 * st["sigmae"]),
               static.nonas)
        got, want = (fn(*ops[:5], st["eps"].clone(), *ops[6:], wave=W)
                     for fn in (sk.sweep_blocks, sk.sweep_blocks_plain))
        diff = got[2] != want[2]
        cass = [_natural_cass(x[2], static.group_of, st["sigmag"], MT_SMALL,
                              K) for x in (got, want)]
        d_beta, d_eps = max_err(got[1], want[1]), max_err(got[0], want[0])
        if diff.any():
            rows = (blk[:, None] * B + win).reshape(-1)
            u_nat = torch.empty_like(want[3])
            u_nat[:, rows] = u.movedim(1, 0).reshape(nT, m_pad)
            margin = torch.minimum((u_nat - got[3]).abs(),
                                   (u_nat - want[3]).abs())[diff].min()
            fail(f"sweep_blocks at T={nT}: comp differs from the plain "
                 f"version at (trait, slot) {diff.nonzero()[:12].tolist()}"
                 f"; least margin |u - cdf| {float(margin):.3e}")
        if not torch.equal(*cass) or d_beta > 1e-4 or d_eps > 1e-4:
            fail(f"sweep_blocks at T={nT}: cass equal "
                 f"{torch.equal(*cass)}, max|dbeta| {d_beta:.3e}, "
                 f"max|deps| {d_eps:.3e}")
        out.append(f"T={nT} max|dbeta| {d_beta:.1e}, max|deps| {d_eps:.1e}")
    print(f"# sweep_blocks at launch widths {widths} (NT=T, "
          f"{MT_SMALL} markers): comp and cass equal to the plain version; "
          f"{'; '.join(out)}  [{card}]", flush=True)


def first_flip(got, want, u_nat, order, t):
    """Trait t's first draw in sweep order (``order``: the markers in the
    order drawn) whose comp differs between two sweeps' outputs (eps,
    beta, comp, acum, cass): its place in the order, the marker, its u, the
    distance |u - cdf| from the nearer of the two sweeps' acum (the CDF
    value at the component drawn) and that distance in float32 ulps of u."""
    import numpy as np
    first = int((got[2][t, order] != want[2][t, order]).int().argmax())
    r = int(order[first])
    u = float(u_nat[t, r])
    margin = min(abs(u - float(got[3][t, r])), abs(u - float(want[3][t, r])))
    return first, r, u, margin, margin / float(np.spacing(np.float32(u)))


def chunked_sweep_gate(sim, dev, card, name):
    """Phase 8a at T=33, W=32: one whole sweep of the default path (kernels
    7/8 in five launches: 7, 7, 7, 7 and 5 traits), with injected block
    order and draws, held (1) bit for bit (eps, beta, comp, acum and cass)
    to marker_sweep run on each trait chunk's phenotypes alone (their
    slices of the static inputs and the state, one launch each), and (2)
    to the plain sweep on the host CPU, tie-aware: every trait whose comp
    equals the plain version's has its cass equal and max|dbeta| and
    max|deps| within 1e-4; in a trait whose comp differs, the first
    differing draw in sweep order must have u within TIE_ULPS float32 ulps
    of its CDF boundary (such a draw follows the order of the sums, and
    the trait's chain differs from there on).  The second witness for such
    a trait, printed beside it: the plain sweep on its chunk's traits
    alone, and whether that trait's comp there equals the plain sweep's on
    all traits."""
    import numpy as np
    import torch
    from gmrm_tpu_torch import runner
    from gmrm_tpu_torch.config import resolve_plan
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.ops.trait_chunks import trait_chunks
    from gmrm_tpu_torch.sampler.gibbs import marker_sweep

    t_gate = time.perf_counter()
    opt = anchor_options(sim, "", W)
    resolve_plan(opt, "cuda", sim.m)
    nT = len(opt.phen_files)
    data = runner.load_data(opt)
    static = runner.build_static(data, opt, dev)
    state = runner.init_sampler_state(data, opt, dev)
    nblocks = data.m_pad // B
    nt = static.gram_cache.shape[1]
    rng = np.random.default_rng(7)
    blocks = (rng.permutation(nblocks)[:, None] * B
              + np.argsort(rng.uniform(size=(nblocks, B)), axis=1))
    inj = [torch.from_numpy(a).to(dev) for a in (
        blocks.reshape(nblocks, B),
        rng.uniform(size=(nblocks, nT, B)).astype(np.float32),
        rng.normal(size=(nblocks, nT, B)).astype(np.float32))]
    sigmae = 0.5 * (state.eps * state.eps).sum(dim=(1, 2)) / static.nonas

    def sweep(s_=slice(None), on=dev):
        """marker_sweep of traits s_ alone, on ``on``, outputs on the
        host."""
        sta = dataclasses.replace(
            static, na=static.na[s_], mave=static.mave[s_],
            msig=static.msig[s_],
            nonas=static.nonas[s_],
            gram_cache=(static.gram_cache if nt == 1 else
                        static.gram_cache[:, s_]))
        st = dataclasses.replace(state, **{
            k: getattr(state, k)[s_] for k in (
                "eps", "betas", "comp", "acum", "sigmag", "pi_est")})
        sta, st = (to_device(dataclasses.replace(x, **{
            f.name: getattr(x, f.name).contiguous()
            for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)}), on)
            for x in (sta, st))
        u, z = (x[:, s_].contiguous().to(on) for x in inj[1:])
        return [x.cpu().clone() for x in marker_sweep(
            st.eps.clone(), st.betas, st.comp, st.acum, st.sigmag,
            sigmae[s_].contiguous().to(on), st.pi_est, sta, inj[0].to(on),
            u, z, wave=W)]

    _build.reset_launch_counts()
    whole = sweep()
    chunks = trait_chunks("sweep_blocks", nT, B)
    if launch_counts()["sweep_blocks"] != len(chunks):
        fail(f"{name}: {launch_counts()} for {len(chunks)} chunks")
    for t0, t1 in chunks:
        part = sweep(slice(t0, t1))
        for i, (w, p_) in enumerate(zip(whole, part)):
            if not torch.equal(w[t0:t1], p_):
                fail(f"{name}: output {i} of traits {t0}..{t1 - 1} differs "
                     f"from the sweep of that chunk alone")
    cpu = torch.device("cpu")
    plain = sweep(on=cpu)
    order = inj[0].cpu().reshape(-1).long()
    u_nat = torch.empty_like(plain[3])
    u_nat[:, order] = inj[1].cpu().movedim(1, 0).reshape(nT, -1)
    flipped = (whole[2] != plain[2]).any(dim=1)
    same = ~flipped
    d_beta = max_err(whole[1][same], plain[1][same])
    d_eps = max_err(whole[0][same], plain[0][same])
    if (not torch.equal(whole[4][same], plain[4][same]) or d_beta > 1e-4
            or d_eps > 1e-4):
        fail(f"{name}: the traits whose comp equals the plain version's: "
             f"cass equal {torch.equal(whole[4][same], plain[4][same])}, "
             f"max|dbeta| {d_beta:.3e}, max|deps| {d_eps:.3e}")
    ties = []
    for t in flipped.nonzero()[:, 0].tolist():
        first, r, u, margin, ulps = first_flip(whole, plain, u_nat, order, t)
        t0, t1 = next(c for c in chunks if c[0] <= t < c[1])
        alone = sweep(slice(t0, t1), on=cpu)
        witness = torch.equal(alone[2][t - t0], plain[2][t])
        ties.append(
            f"trait {t}: {int((whole[2][t] != plain[2][t]).sum())} comp "
            f"mismatches, the first in sweep order at draw {first} of "
            f"{order.numel()} (marker {r}, comp {int(whole[2][t, r])} here, "
            f"{int(plain[2][t, r])} plain): u {u:.9g}, acum "
            f"{float(whole[3][t, r]):.9g} here, "
            f"{float(plain[3][t, r]):.9g} plain, |u - cdf| "
            f"{margin:.3e} = {ulps:.2f} ulps; the plain sweep of traits "
            f"{t0}..{t1 - 1} alone gives trait {t} the comp of the plain "
            f"sweep of all traits: {witness}")
        if ulps > TIE_ULPS:
            fail(f"{name}: {ties[-1]}; more than {TIE_ULPS} ulps from its "
                 f"CDF boundary")
    print(f"# {name} (T={nT}, W={W}, NT={nt}, {nblocks} blocks): {len(chunks)}"
          f" launches of {[t1 - t0 for t0, t1 in chunks]} traits, every "
          f"output bit-equal to the sweep of each chunk alone; against the "
          f"plain sweep: {int(same.sum())} traits with comp and cass equal, "
          f"max|dbeta| {d_beta:.3e}, max|deps| {d_eps:.3e}; "
          f"{'; '.join(ties) or 'no trait differs'}; "
          f"{time.perf_counter() - t_gate:.1f} s  [{card}]", flush=True)


def gram_kernels_at_nt(dev, gen, card):
    """Phase 8c: kernels 1 and 5 (A at float64) at 16 traits with a mask a
    trait (NT = 16), on four anchor blocks: bit-equal to their plain
    versions; they take nt in {1, T} at any T and are not chunked."""
    import torch
    from gmrm_tpu_torch.ops import block_gram as bg
    from gmrm_tpu_torch.ops import sweep_kernel as sk
    nT, nb = T_GATE, 4
    bed = torch.randint(0, 256, (nb * B, MB), generator=gen, device=dev,
                        dtype=torch.uint8)
    na = (torch.rand((nT, 4, MB), generator=gen, device=dev)
          > 0.03).float().contiguous()
    cache = sk.build_gram_cache(bed, na, block_size=B, shared_na=False)
    if not torch.equal(cache, sk.gram_cache_plain(bed, na, B)):
        fail("kernel 1 at NT=16: not bit-equal to its plain version")
    rows = torch.stack([b * B + torch.randperm(B, generator=gen, device=dev)
                        for b in range(nb)]).to(torch.int32)
    for dtype in (torch.float32, torch.float64):
        mave = (torch.rand((nb, nT, B), generator=gen, device=dev) * 1.6
                + 0.2).to(dtype)
        msig = (torch.rand((nb, nT, B), generator=gen, device=dev) * 1.5
                + 0.5).to(dtype)
        got = bg.blocks_gram_scaled(bed, rows, na, mave, msig)
        if not torch.equal(got, bg.blocks_gram_scaled_plain(bed, rows, na,
                                                            mave, msig)):
            fail(f"kernel {'A' if dtype == torch.float64 else 5} at NT=16: "
                 f"not bit-equal to its plain version")
    print(f"# kernels 1, 5 and A at T=16, NT=16 ({nb} anchor blocks): "
          f"bit-equal to their plain versions  [{card}]", flush=True)


def trait_training(sim, dev, tmp, nT, wave):
    """Phase 8d: run_training at the anchor with the first ``nT``
    phenotypes, ITERS_TRAITS iterations: steady ms/iteration, launches an
    iteration (each kernel's, checked against its trait chunks) and peak
    device memory."""
    import torch
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.runner import check_finite_chain, run_training
    out_dir = os.path.join(tmp, f"traits_t{nT}_w{wave}")
    opt = anchor_options(sim, out_dir, wave, ITERS_TRAITS,
                         phens=sim.phens[:nT])
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    res = run_training(opt, device=dev, verbose=False)
    counts = {k: v for k, v in launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    nblocks = -(-MT // B)
    want = ({"gram_cache": 1, "sweep_blocks":
             ITERS_TRAITS * sweep_chunks(nT)} if wave > 1
            else serial_counts(nblocks, sweeps=ITERS_TRAITS, traits=nT))
    if counts != want:
        fail(f"T={nT} W={wave} training: launches {counts}, expected {want}")
    check_finite_chain(res.state.sigmag.cpu().numpy(),
                       res.state.sigmae.cpu().numpy(), ITERS_TRAITS)
    steady = sum(res.iter_seconds[THIN:]) / (ITERS_TRAITS - THIN)
    per_iter = {k: v / ITERS_TRAITS for k, v in counts.items()
                if k != "gram_cache"}
    return steady, per_iter, peak, res.startup_seconds


def traits_phase(dev, tmp, card, gen, sims):
    """Phase 8: any number of traits on every CUDA training path.  (a)
    Sweep gates at T=16 at the anchor (16 of the 32 phenotypes, NT=1; 16
    with 2% NAs, NT=16): W=32 (the whole-sweep kernel, two launches of 8)
    on the anchor's 157 blocks; composed W=32, sharded S=2 at W=32, W=1 and
    float64 W=1 on the anchor cut to 32 blocks (the small panel with 16
    phenotypes: no NAs, or 16 of the 33 with NAs), each against its plain
    version on the host CPU; at T=33 on the small panel (NT=33), W=1
    (kernel 6 as a grid of trait groups) and W=32.  (b) chunk_gates.
    (c) gram_kernels_at_nt.  (d) run_training at T = 8, 16 and 32, W=32 and
    W=1 (ms/iteration, launches an iteration, peak memory).  Returns the
    timing rows."""
    t0 = time.perf_counter()
    a32, a16na, s33, s16 = sims
    sweep_width_gate(dev, gen, card)
    # The default W=32 path sweeps the anchor's 157 blocks; the others run
    # on the anchor cut to 32 blocks (the small panel's 4,096 markers at
    # the same N, B and traits), where their plain sweeps on the host take
    # seconds.
    for sim, phens, small, small_phens, tag in (
            (a32, a32.phens[:T_GATE], s16, None, "NT=1"),
            (a16na, None, s33, s33.phens[:T_GATE], f"NT={T_GATE}")):
        sweep_gate(sim, dev, W, f"T={T_GATE} W={W} sweep gate ({tag})",
                   card, phens=phens, timed=False)
        sweep_gate(small, dev, 1, f"T={T_GATE} W=1 sweep gate ({tag})",
                   card, phens=small_phens)
        sweep_gate(small, dev, W, f"T={T_GATE} composed W={W} sweep gate "
                   f"({tag})", card, phens=small_phens, mega=False)
        sharded_gate(small, dev, card, 2, W, f"T={T_GATE} sharded S=2 sweep "
                     f"gate ({tag})", phens=small_phens, against="plain")
        sweep_gate(small, dev, 1, f"T={T_GATE} float64 W=1 sweep gate "
                   f"({tag})", card, dtype="float64", phens=small_phens)
    sweep_gate(s33, dev, 1, f"T={T_SMALL} W=1 sweep gate", card)
    chunked_sweep_gate(s33, dev, card, f"T={T_SMALL} W={W} sweep gate")
    t_gates = time.perf_counter() - t0
    chunk_gates(dev, gen, card)
    gram_kernels_at_nt(dev, gen, card)
    rows = {}
    for nT in TRAIT_TIMING:
        for wave in (W, 1):
            steady, per_iter, peak, startup = trait_training(a32, dev, tmp,
                                                             nT, wave)
            rows[(nT, wave)] = (steady, per_iter, peak)
            print(f"# traits T={nT} W={wave} training at the anchor: steady "
                  f"{steady * 1e3:.2f} ms/iteration over iterations "
                  f"{THIN + 1}-{ITERS_TRAITS}; launches an iteration "
                  f"{per_iter} ({sum(per_iter.values()):.0f}); peak device "
                  f"memory {peak / 2**20:.1f} MiB; startup {startup:.2f} s  "
                  f"[{card}]", flush=True)
    print(f"# phase 8 (traits): gates {t_gates:.1f} s, all "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def traits_only(dev, tmp, card, reps):
    """``--traits-only REPS``: phase 8 alone, its datasets simulated while
    the kernels build; the timing runs REPS times."""
    import torch
    from gmrm_tpu_torch.ops import _build
    with concurrent.futures.ProcessPoolExecutor(
            len(TRAIT_DATASETS),
            mp_context=multiprocessing.get_context("spawn"),
            initializer=one_thread) as pool:
        futs = [pool.submit(make, os.path.join(tmp, name))
                for name, make in TRAIT_DATASETS]
        t0 = time.perf_counter()
        _build.library()
        print(f"# build {time.perf_counter() - t0:.1f} s", flush=True)
        sims = [f.result() for f in futs]
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    traits_phase(dev, tmp, card, gen, sims)
    a32 = sims[0]
    for rep in range(1, reps):
        for nT in TRAIT_TIMING:
            for wave in (W, 1):
                steady, per_iter, peak, _ = trait_training(a32, dev, tmp, nT,
                                                           wave)
                print(f"# traits T={nT} W={wave} run {rep + 1}: "
                      f"{steady * 1e3:.2f} ms/iteration, "
                      f"{sum(per_iter.values()):.0f} launches an iteration, "
                      f"peak {peak / 2**20:.1f} MiB  [{card}]", flush=True)


def predict_stamp_split(st):
    """A stamped predict launch's CTAs (``gmrm_predict_sums_probe``): the
    launch's span, a CTA's mean and longest, the tail after the last CTA
    started, how many CTAs an SM ran, and the loop's phases' shares."""
    import torch
    st = st[st[:, 0] != 0].double()     # the CTAs the launch ran
    start, end = st[:, 0], st[:, 1]
    span = float(end.max() - start.min()) / 1e3
    dur = (end - start) / 1e3
    tail = float(end.max() - start.max()) / 1e3
    per_sm = torch.bincount(st[:, 2].long())
    phases = st[:, 4:8].sum(0)         # no y staging at float
    names = ("bed + mask loads", "y loads", "decode + FMAs",
             "reductions and writes")
    share = ", ".join(f"{n} {float(v / phases.sum()):.3f}"
                      for n, v in zip(names, phases))
    return (f"span {span:.2f} us, CTA mean {float(dur.mean()):.2f} us, "
            f"longest {float(dur.max()):.2f}, tail after the last start "
            f"{tail:.2f} us, CTAs an SM {int(per_sm.min())}-"
            f"{int(per_sm.max())} ({st.shape[0]} CTAs); cycles by phase "
            f"(stamped loop, loads waited out): {share}")


def seeded_predict_operands(dev, gen):
    """A seeded anchor-shaped predict bed (20,000 rows at the row pitch of
    N=10,000, 2,512 bytes, the pad bytes 0x55) and one trait's float32
    planes: 2% NAs, y zero where missing and past N."""
    import torch
    from gmrm_tpu_torch.ops.predict_sums import pitch_of
    pitch = pitch_of((N + 3) // 4)
    bed = torch.randint(0, 256, (MT, pitch), generator=gen, device=dev,
                        dtype=torch.uint8)
    bed[:, (N + 3) // 4:] = 0x55
    keep = (torch.rand((4, pitch), generator=gen, device=dev) > 0.02).float()
    col = torch.arange(pitch, device=dev)
    keep = (keep * (col[None, :] * 4 + torch.arange(4, device=dev)[:, None]
                    < N)).contiguous()
    y = (torch.randn((4, pitch), generator=gen, device=dev)
         * keep).contiguous()
    return bed, keep, y


def predict_times(dev, gen, card, repo, rep):
    """``--predict-only``: the float32 predict kernel alone, for two trees
    in one call: on a seeded anchor-shaped bed (``seeded_predict_operands``)
    and at N=100,000 x 4,096, each held by ``predict_case`` (its ms by graph
    replay, torch.mv beside it; kernel D on the same bed and planes at
    float64 before it), the launch's two kernels split by the profiler,
    and, where the tree has the probe entry point, one stamped launch, and
    the kernels' SASS counts."""
    import torch
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.ops.predict_sums import predict_sums
    lib = _build.library()
    cases = (("anchor", *seeded_predict_operands(dev, gen), N),
             ("N=100,000", *big_predict_operands(dev, gen, torch.float32),
              N_BIG))
    for name, b_, na_, y_, n in cases:
        d_row = predict_case(f"{repo} run {rep + 1}, {name}, kernel D", b_,
                             na_.double(), y_.double(), n, card)
        print(f"# {repo}: predict_sums_f64 (D) {name} run {rep + 1}: "
              f"{d_row['ms']:.5f} ms a trait  [{card}]", flush=True)
        row = predict_case(f"{repo} run {rep + 1}, {name}", b_, na_, y_, n,
                           card)
        split = kernel_ms_by_name(lambda: predict_sums(b_, na_, y_))
        parts = ", ".join(f"{k[:40]} {v:.5f}" for k, v in split.items())
        print(f"# {repo}: predict_sums {name} run {rep + 1}: {row['ms']:.5f} "
              f"ms a trait; by kernel (profiler): {parts}  [{card}]",
              flush=True)
        if not hasattr(lib, "gmrm_predict_sums_probe"):
            continue
        m, L = b_.shape
        team = lib.gmrm_predict_sums_team(L)
        grid = -(-m // (8 // team * 4))
        out = torch.empty((2, m), device=dev)
        kw = torch.empty(L // 4 + 4, dtype=torch.int32, device=dev)
        st = torch.zeros((grid, 8), dtype=torch.int64, device=dev)
        err = lib.gmrm_predict_sums_probe(
            b_.data_ptr(), na_.data_ptr(), y_.data_ptr(), kw.data_ptr(),
            out.data_ptr(), m, L, st.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"predict probe: {_build.error_string(err)}")
        torch.cuda.synchronize()
        if not torch.equal(out, torch.stack(predict_sums(b_, na_, y_))):
            fail(f"predict probe, {name}: the stamped launch's sums differ "
                 f"from the kernel's")
        print(f"# {repo}: predict_sums {name}, stamped launch (team "
              f"{team}): {predict_stamp_split(st.cpu())}  [{card}]",
              flush=True)
    if rep == 0:
        ops = ("LDG", "LDS", "STS", "FFMA", "FADD", "FMUL", "PRMT", "BAR",
               "POPC", "LOP3", "SHF", "IMAD", "IADD3", "LEA", "MOV", "ISETP",
               "SEL", "BRA", "SHFL", "I2F")
        counts = sass_counts(_build.build(), "predict_sums_kernel", ops)
        print(f"# {repo}: SASS of the predict kernels (opcodes starting "
              f"{', '.join(ops)}, and all but NOPs): " + "; ".join(
                  f"{fn[-40:]} {c}" for fn, c in counts.items())
              + f"  [{card}]", flush=True)


def predict_pairs(dev, gen, card, trees, pairs, tmp):
    """``--predict-pairs N --against TREE``: the float32 predict kernel
    (``gmrm_predict_sums``) and D (``gmrm_predict_sums_f64``) of this tree
    against each TREE's, their libraries loaded side by side in this
    process (TREE's built by a subprocess of its own package).  On three
    beds: the seeded anchor-shaped bed of ``--predict-only`` (2% NAs), the
    anchor dataset's own bed with its first trait (phase 6's "anchor,
    NT=1") and the seeded N=100,000 x 4,096 bed.  Every tree's sums must be
    bit-equal to this tree's.  Then N pairs, the trees in turn (TREE first
    in the even pairs, this tree first in the odd ones), each reading the
    device ms of one call by CUDA-graph replay of 100.  Prints every pair
    and, per bed, kernel and TREE, both ranges and in how many pairs this
    tree read below all of TREE's readings (a win beyond its spread)."""
    import ctypes
    import torch
    from gmrm_tpu_torch.io.bed import read_bed
    from gmrm_tpu_torch.io.phen import read_phen
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.ops.predict_sums import padded_chunk, pitch_of
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from gmrm_tpu_torch.ops import _build; print(_build.build())")
    builds = [subprocess.Popen([sys.executable, "-c", code, t],
                               stdout=subprocess.PIPE, text=True)
              for t in trees]
    libs = {".": _build.library()}
    for t, b in zip(trees, builds):
        path = b.communicate(timeout=900)[0].strip()
        if b.returncode or not path:
            fail(f"predict pairs: {t}'s build failed")
        libs[t] = ctypes.CDLL(path.splitlines()[-1])
    for lib in libs.values():
        for fn in ("gmrm_predict_sums", "gmrm_predict_sums_f64"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
    sim = anchor_dataset(os.path.join(tmp, "anchor"))
    pitch = pitch_of((N + 3) // 4)
    beds = (("seeded anchor-shaped bed, 2% NAs",
             *seeded_predict_operands(dev, gen)),
            ("anchor dataset's bed, NT=1",
             padded_chunk(read_bed(sim.bed, N, MT), 0, MT, dev),
             *predict_planes(read_phen(sim.phens[0], N), dev, pitch)),
            ("N=100,000 x 4,096, 2% NAs",
             *big_predict_operands(dev, gen, torch.float32)))
    for bed_name, bed, na, y in beds:
        m, L = bed.shape
        for fn, dt in (("gmrm_predict_sums", torch.float32),
                       ("gmrm_predict_sums_f64", torch.float64)):
            na_, y_ = na.to(dt), y.to(dt)
            calls, outs = {}, {}
            for t, lib in libs.items():
                out = torch.empty((2, m), dtype=dt, device=dev)
                keep = torch.empty(L // 4 + 4, dtype=torch.int32, device=dev)

                def call(f=getattr(lib, fn), out=out, keep=keep, t=t):
                    err = f(bed.data_ptr(), na_.data_ptr(), y_.data_ptr(),
                            keep.data_ptr(), out.data_ptr(), m, L,
                            torch.cuda.current_stream().cuda_stream)
                    if err:
                        fail(f"predict pairs: {fn} of {t} failed ({err})")
                call()
                calls[t], outs[t] = call, out
            torch.cuda.synchronize()
            for t in trees:
                if not torch.equal(outs[t], outs["."]):
                    fail(f"predict pairs, {bed_name}: {fn} of {t} differs "
                         f"from this tree's")
            ms = {t: [] for t in libs}
            for i in range(pairs):
                order = [*trees, "."] if i % 2 == 0 else [".", *trees]
                for t in order:
                    ms[t].append(cuda_ms(calls[t], 100))
                print(f"# predict pair {i + 1}, {bed_name}, {fn}: "
                      + ", ".join(f"{t} {ms[t][-1]:.5f}" for t in order)
                      + " ms a trait", flush=True)
            for t in trees:
                wins = sum(x < min(ms[t]) for x in ms["."])
                print(f"# predict pairs, {bed_name}, {fn}: {t} "
                      f"{min(ms[t]):.5f}-{max(ms[t]):.5f}, this tree "
                      f"{min(ms['.']):.5f}-{max(ms['.']):.5f} ms a trait; "
                      f"this tree below all of {t}'s readings in {wins} of "
                      f"{pairs} pairs (bytes equal)  [{card}]", flush=True)


@contextlib.contextmanager
def load_route(route):
    """Every load path of the port (run_training, load_data_process,
    run_predict) reading on ``route``: "native" (the default, the host
    library) or "numpy" (the readers' plain versions)."""
    import functools
    from gmrm_tpu_torch import predict, runner
    from gmrm_tpu_torch.io.bed import read_bed
    from gmrm_tpu_torch.io.phen import read_phen
    from gmrm_tpu_torch.parallel import runner as prunner
    saved = [(m, m.read_bed, m.read_phen) for m in (runner, prunner, predict)]
    try:
        for m, _, _ in saved:
            m.read_bed = functools.partial(read_bed, route=route)
            m.read_phen = functools.partial(read_phen, route=route)
        yield
    finally:
        for m, bed, phen in saved:
            m.read_bed, m.read_phen = bed, phen


def best_of(fn, reps=IO_REPS):
    """(fn's last result, its best wall seconds over ``reps`` calls)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return out, best


def phen_fields(ph):
    return (ph.values.tobytes(), ph.mask.tobytes(), ph.epsilon0.tobytes(),
            ph.nas, ph.nonas)


def same_data(a, b):
    """Whether two loaded inputs (LoadedData, ProcessData and what they
    hold) are equal, their arrays bit for bit."""
    import numpy as np
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same_data, a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_data(a[k], b[k]) for k in a)
    if hasattr(a, "__dict__"):
        return type(a) is type(b) and same_data(vars(a), vars(b))
    return a == b


def io_phase(sim, big, dev, tmp, card):
    """Phase 9: the host I/O library (csrc/io_native.cpp) on every load
    path, against the readers' NumPy routes, host time on this machine.
    (a) The anchor's bed (50 MB) and the large-N panel's (102 MB) read by
    both routes, byte-equal, best of IO_REPS with a warm page cache; (b) the
    anchor's phens parsed by both, bit-equal, none sent back to NumPy; (c)
    load_data (W=32) and load_data_process (S=2, W=32) by each route,
    equal; (d) run_training at W=32 and W=1 for IO_ITERS iterations by each
    route: the .csv/.bet/.cpn bytes equal, the library's counters non-zero
    on the native route and 0 on the NumPy route, kernels 1 and 7 (W=32)
    and 5, 6 and the passes (W=1) launched as phases 4 and 4b count them;
    (e) run_predict on the W=32 .bet files by each route, the .mlma bytes
    equal, its read / upload / sums / ols / write split."""
    from gmrm_tpu_torch import runner
    from gmrm_tpu_torch.config import Options
    from gmrm_tpu_torch.io import native
    from gmrm_tpu_torch.io.bed import read_bed
    from gmrm_tpu_torch.io.phen import read_phen
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.parallel.runner import load_data_process
    from gmrm_tpu_torch.predict import run_predict
    from gmrm_tpu_torch.runner import run_training

    import numpy as np
    routes = ("native", "numpy")
    t_phase = time.perf_counter()
    for name, ds, n, m in (("anchor", sim, N, MT),
                           ("large-N panel", big, N_BIG, MT_BIG)):
        read = {r: (lambda r=r: read_bed(ds.bed, n, m, route=r))
                for r in routes}
        read["numpy"]()                        # the page cache warm
        got = {r: best_of(read[r]) for r in routes}
        if got["native"][0].tobytes() != got["numpy"][0].tobytes():
            fail(f"io: the {name}'s bed reads other bytes natively")
        mbytes = got["native"][0].nbytes / 1e6
        print(f"# io, bed of the {name} ({n:,} x {m:,}, {mbytes:.1f} MB), "
              f"best of {IO_REPS}, warm page cache: native "
              f"{got['native'][1] * 1e3:.2f} ms = "
              f"{mbytes / got['native'][1]:.0f} MB/s, NumPy "
              f"{got['numpy'][1] * 1e3:.2f} ms = "
              f"{mbytes / got['numpy'][1]:.0f} MB/s; byte-equal  "
              f"[{card}] (host time)", flush=True)
    # What holds the pread, on the large-N bed: its threads, and the first
    # touch of the fresh buffer read_bed gets (np.empty) against a buffer
    # already faulted in (the library called directly; and Python's
    # readinto, one thread).
    lib = _build.host_library()
    size = MT_BIG * ((N_BIG + 3) // 4)
    buf = np.zeros(size, np.uint8)
    sweep = []
    for nt in IO_THREADS:
        fresh = best_of(lambda: native.native_read_block(big.bed, 3, size,
                                                         nt))[1]
        reused = best_of(lambda: lib.gmrm_read_block(
            big.bed.encode(), 3, size, buf.ctypes.data, nt))[1]
        sweep.append(f"{nt}: {fresh * 1e3:.2f} / {reused * 1e3:.2f}")
    with open(big.bed, "rb", buffering=0) as fh:
        def readinto():
            fh.seek(3)
            return fh.readinto(memoryview(buf))
        one = best_of(readinto)[1]
    print(f"# io, pread of the large-N bed ({size / 1e6:.1f} MB) by threads "
          f"asked (at most one per 8 MiB; {os.cpu_count()} CPUs), ms best of "
          f"{IO_REPS}, fresh buffer / buffer faulted in: "
          f"{'; '.join(sweep)}; Python readinto, faulted in, one thread: "
          f"{one * 1e3:.2f}  [{card}] (host time)", flush=True)

    native.reset_call_counts()
    parse = {r: best_of(lambda r=r: [read_phen(p, N, route=r)
                                     for p in sim.phens]) for r in routes}
    deferred = native.call_counts()["parses_deferred"]
    if deferred or ([phen_fields(ph) for ph in parse["native"][0]]
                    != [phen_fields(ph) for ph in parse["numpy"][0]]):
        fail(f"io: the anchor's phens parse otherwise natively ({deferred} "
             f"sent back to NumPy)")
    print(f"# io, the anchor's {T} phens ({N:,} lines each), best of "
          f"{IO_REPS}: native {parse['native'][1] * 1e3:.2f} ms, NumPy "
          f"{parse['numpy'][1] * 1e3:.2f} ms; values, mask, epsilon0 "
          f"bit-equal, none sent back  [{card}] (host time)", flush=True)

    opt = anchor_options(sim, os.path.join(tmp, "io_load"), W, IO_ITERS)
    loads = {}
    for r in routes:
        with load_route(r):
            loads[r] = (best_of(lambda: runner.load_data(opt), 3),
                        best_of(lambda: load_data_process(
                            opt, 2, interleave=True), 3))
    for i, what in enumerate(("load_data", "load_data_process(S=2)")):
        if not same_data(*(loads[r][i][0] for r in routes)):
            fail(f"io: {what} gives other arrays natively")
        print(f"# io, {what} at the anchor (W={W}), best of 3: native "
              f"{loads['native'][i][1]:.3f} s, NumPy "
              f"{loads['numpy'][i][1]:.3f} s; equal arrays  [{card}] "
              f"(host time)", flush=True)

    nblocks = -(-MT // B)
    for w in (W, 1):
        want = ({"gram_cache": 1, "sweep_blocks": IO_ITERS} if w > 1
                else serial_counts(nblocks, sweeps=IO_ITERS))
        outs = {}
        for i, r in enumerate(routes + routes[::-1]):
            out = os.path.join(tmp, f"io_w{w}_{r}{i // 2 or ''}")
            opt = anchor_options(sim, out, w, IO_ITERS)
            with load_route(r):
                native.reset_call_counts()
                res, launches = counted(lambda: run_training(
                    opt, device=dev, verbose=False))
                calls = native.call_counts()
            outs[out] = r
            for name in set(want) | set(launches):
                n_l = want.get(name, 0)
                if launches.get(name, 0) != n_l:
                    fail(f"io: W={w} training ({r}): kernel {name} launched "
                         f"{launches.get(name, 0)} times, expected {n_l}")
            if r == "native" and (calls["reads"] != 1
                                  or calls["parses"] != T
                                  or calls["parses_deferred"]):
                fail(f"io: W={w} training did not read natively: {calls}")
            if r == "numpy" and any(calls.values()):
                fail(f"io: W={w} training on the NumPy route called the "
                     f"library: {calls}")
            print(f"# io, W={w} training ({IO_ITERS} iterations) on the {r} "
                  f"route: startup {res.startup_seconds:.3f} s; library "
                  f"calls {calls}; launches {launches}  [{card}]",
                  flush=True)
        first, *rest = outs
        if not all(same_artifacts(sim, first, out) for out in rest):
            fail(f"io: W={w} chains differ by route")
    print(f"# io, W={W} and W=1 chains byte-equal by either route", flush=True)

    splits = {}
    train = os.path.join(tmp, f"io_w{W}_native")
    popt = Options(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                   bim_file=sim.bim, ref_bim_file=sim.bim, out_dir=train,
                   predict=True)
    for r in routes:
        with load_route(r):
            native.reset_call_counts()
            splits[r] = run_predict(popt, device=dev, verbose=False)
            calls = native.call_counts()
        if (calls["reads"] == 0) != (r == "numpy"):
            fail(f"io: predict on the {r} route: library calls {calls}")
        mlma = {}
        for p in sim.phens:
            name = os.path.splitext(os.path.basename(p))[0] + ".mlma"
            with open(os.path.join(train, name), "rb") as fh:
                mlma[name] = fh.read()
        splits[r + " mlma"] = mlma
    if splits["native mlma"] != splits["numpy mlma"]:
        fail("io: predict writes other .mlma bytes by route")
    for r in routes:
        split = splits[r]
        print(f"# io, predict at the anchor ({T} traits) on the {r} route: "
              f"wall {sum(split.values()):.3f} s = "
              f"{', '.join(f'{k} {v:.3f}' for k, v in split.items())}; "
              f".mlma byte-equal  [{card}] (host and device)", flush=True)
    print(f"# phase 9 (io) wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def build_host_library():
    """Phase 1's host half: csrc/io_native.cpp with the host compiler (no
    nvcc), timed."""
    from gmrm_tpu_torch.ops import _build
    found = set(_build.BUILD_DIR.glob("libgmrm_io_*.so"))
    t0 = time.perf_counter()
    lib = _build.host_build()
    took = time.perf_counter() - t0
    _build.host_library()
    print(f"# build: {lib.name} (the host I/O library, "
          f"{' '.join(_build.HOST_CXX_FLAGS)}) in {took:.2f} s"
          f"{' (found built)' if lib in found else ''}", flush=True)


def io_only(dev, tmp, card):
    """``--io-only``: phase 9 alone, on the anchor and large-N datasets
    simulated by worker processes while the kernels build."""
    from gmrm_tpu_torch.ops import _build
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn"),
            initializer=one_thread) as pool:
        sims = [pool.submit(make, os.path.join(tmp, name)) for name, make
                in (("data", anchor_dataset), ("big", big_dataset))]
        build_host_library()
        _build.library()
        sim, big = (f.result() for f in sims)
    io_phase(sim, big, dev, tmp, card)


# --------------------------------------------------------------------------
# Phase 10: whole iterations from scripted draws, and anchor-scale posteriors
# --------------------------------------------------------------------------

CHAIN_ITERS = 3          # phase 10(a): whole iterations a path
CHAIN_GROUPS = 300       # the anchor's bed with this many annotation groups
# Phase 10(b): the dataset of benchmarking/EQUIVALENCE.md "Anchor-scale"
# (benchmarking/equivalence_ref.py:154-156), its chains and its criterion.
EQ_N, EQ_M, EQ_T, EQ_SEED = 10_000, 20_000, 4, 20260819
EQ_SEEDS, EQ_ITERS, EQ_THIN, EQ_BURN = (42, 43, 44), 400, 2, 0.4
EQ_W1_SEED = 4242
# dataset_digest of that dataset as the JAX package's simulator writes it
# (its phenotypes at float32), made in the repository's root with:
#   python -c "import numpy as np, chip_smoke; from gmrm_tpu.io.sim import
#   simulate; print(chip_smoke.dataset_digest(simulate('/tmp/eq', n=10000,
#   m=20000, n_traits=4, n_causal=5000, h2=0.5, n_groups=2, na_rate=0.01,
#   seed=20260819, mixtures=np.array([0.0, 0.0001, 0.001, 0.01]))))"
# (realized h2 0.481606, 0.509875, 0.519018, 0.513289).
EQ_DIGEST = "33990c2bffdcf8bf82e330f5da6fa7581efcadf0660cf12a228754102c5628f2"
# benchmarking/EQUIVALENCE.md:27-59: per trait, the compiled reference's
# posterior-mean h2 at its two seeds (W=32 rows), and its W=1 control's.
EQ_REF_H2 = ((0.4080, 0.4141), (0.4886, 0.4821), (0.4637, 0.4651),
             (0.4886, 0.4852))
EQ_REF_W1 = (0.4030, 0.4804, 0.4543, 0.4783)
# ... and its posterior-mean sigmaE at the same two seeds.
EQ_REF_SE = ((0.5922, 0.5889), (0.5130, 0.5209), (0.5432, 0.5421),
             (0.5134, 0.5179))
# The paths of phase 10(a): name -> (dataset, kind, --wave-size, dtype,
# shards, phenotypes).  Kinds: "default" the whole-sweep iteration (its
# CUDA graphs), "composed" gibbs_iteration(megakernel=False), "gibbs"
# gibbs_iteration on the path its plan gives, "sharded"
# gibbs_iteration_sharded.  "small" is the small panel (Mt=4,096): the
# cut where the host CPU's plain versions would take too long at the
# anchor (the serial scans' plain versions loop over markers).
CHAIN_PATHS = {
    "W=32 default": ("anchor", "default", W, "float32", 1, None),
    "W=32 composed": ("anchor", "composed", W, "float32", 1, None),
    "W=1": ("small", "gibbs", 1, "float32", 1, None),
    "S=2 W=32": ("anchor", "sharded", W, "float32", 2, None),
    "S=2 W=1": ("small", "sharded", 1, "float32", 2, None),
    "float64 W=1": ("small", "gibbs", 1, "float64", 1, None),
    "float64 W=32": ("small", "gibbs", W, "float64", 1, None),
    "NT=4 W=32": ("anchor_na", "default", W, "float32", 1, T),
    f"G={CHAIN_GROUPS} W=32": ("groups", "default", W, "float32", 1, None),
}
CHAIN_SHARD_KEYED = ("block_order", "row_order", "marker_order", "u", "z")


class ChainScript:
    """Every random number of iterations 1, 2, ... from a numpy seed (the
    port's side of tests/torch_chain_script.py): z_mu (T,); the order as
    pi_b (nblocks,) and row keys (nblocks, B), or marker keys (m_pad,),
    distinct multiples of 1/B or 1/m_pad; u and z (nblocks, T, B); one
    uniform a gamma variate of the hyperparameter block.  The order, u and
    z per shard."""

    def __init__(self, seed, T, G, K, nblocks, Bv, n_shards=1):
        self.seed, self.T, self.G, self.K = seed, T, G, K
        self.nblocks, self.B, self.n_shards = nblocks, Bv, n_shards
        self.cache = {}

    def __call__(self, it):
        import numpy as np
        if it not in self.cache:
            T, G, Kv, nb, Bv, D = (self.T, self.G, self.K, self.nblocks,
                                   self.B, self.n_shards)
            rng = np.random.default_rng([self.seed, it])
            m_pad = nb * Bv
            self.cache[it] = {
                "mu": rng.normal(size=T),
                "block_order": np.stack([rng.permutation(nb)
                                         for _ in range(D)]),
                "row_order": ((np.stack([np.stack([rng.permutation(Bv)
                                                   for _ in range(nb)])
                                         for _ in range(D)]) + 0.5) / Bv
                              ).astype(np.float32),
                "marker_order": ((np.stack([rng.permutation(m_pad)
                                            for _ in range(D)]) + 0.5)
                                 / m_pad).astype(np.float32),
                "u": rng.uniform(size=(D, nb, T, Bv)),
                "z": rng.normal(size=(D, nb, T, Bv)),
                "sigmag": rng.uniform(size=(T, G)),
                "pi": rng.uniform(size=(T, G, Kv)),
                "sigmae": rng.uniform(size=T),
            }
        return self.cache[it]

    def value(self, it, purpose, shard=0):
        x = self(it)[purpose]
        return x[shard] if purpose in CHAIN_SHARD_KEYED else x

    def order(self, it, block_mode, m_local, shard=0):
        """The processing order (m_pad,) the sweep derives."""
        import numpy as np
        if block_mode:
            pi_b = self.value(it, "block_order", shard)
            rows = np.argsort(self.value(it, "row_order", shard), axis=1)
            return (pi_b[:, None] * self.B + rows).reshape(-1)
        r = self.value(it, "marker_order", shard).astype(np.float64)
        r = np.where(np.arange(r.size) < m_local, r, 2.0)
        return np.argsort(r, kind="stable")


class ChainToken:
    """What ChainPlan.gen returns in place of a generator."""

    def __init__(self, it, purpose, shard):
        self.it, self.purpose, self.shard = it, purpose, shard


class ChainPlan:
    """RngPlan's interface over a ChainScript."""

    def __init__(self, script, device, shard=None):
        import torch
        self.script = script
        self.device = torch.device(device)
        self.shard = 0 if shard is None else int(shard)

    def gen(self, it, purpose):
        return ChainToken(int(it), purpose, self.shard)


class ChainTorch:
    """torch, with randn, rand and randperm of a ChainToken answered from
    the script (written into ``out`` where the caller gives one)."""

    def __init__(self, script):
        self.script = script

    def __getattr__(self, name):
        import torch
        return getattr(torch, name)

    def _draw(self, real, size, generator, out, dtype, device, kw):
        import numpy as np
        import torch
        if not isinstance(generator, ChainToken):
            return real(size, generator=generator, out=out, dtype=dtype,
                        device=device, **kw)
        x = torch.from_numpy(np.ascontiguousarray(self.script.value(
            generator.it, generator.purpose, generator.shard)))
        want = (size,) if isinstance(size, int) else tuple(size)
        if tuple(x.shape) != want:
            fail(f"scripted draw {generator.purpose}: {tuple(x.shape)} "
                 f"for {want}")
        if out is not None:
            return out.copy_(x)
        if dtype is None:
            dtype = torch.int64 if real is torch.randperm else torch.float32
        return x.to(device=device, dtype=dtype)

    def randn(self, size, *, generator=None, out=None, dtype=None,
              device=None, **kw):
        import torch
        return self._draw(torch.randn, size, generator, out, dtype, device,
                          kw)

    def rand(self, size, *, generator=None, out=None, dtype=None,
             device=None, **kw):
        import torch
        return self._draw(torch.rand, size, generator, out, dtype, device,
                          kw)

    def randperm(self, n, *, generator=None, out=None, dtype=None,
                 device=None, **kw):
        import torch
        return self._draw(torch.randperm, n, generator, out, dtype, device,
                          kw)


def gamma_quantile(shape, u, where=None, steps=120):
    """Gamma(shape, 1) at quantile u, float64, on shape's device: bisection
    of log x against torch.special.gammainc (the upper tail Q above u =
    0.5), torch operations only, so that the whole-sweep iteration's
    second CUDA graph can hold it (scipy.special.gammaincinv, which the CPU
    tests use, runs on the host; gamma_quantile_gate holds this to it).
    Computed on ``where`` (default: shape's device): phase 10 computes
    both sides' variates on the card, so that they are the same
    (torch.special.gammainc is good to ~3e-10 of P near shape 20 on the
    CPU, to ~1e-13 on the card)."""
    import torch
    where = shape.device if where is None else where
    a = shape.double().to(where)
    u = u.double().to(where)
    lo = torch.full_like(a, -740.0)
    hi = torch.log(4.0 * a + 1000.0)
    upper = u > 0.5
    q = 1.0 - u
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        x = torch.exp(mid)
        below = torch.where(upper, torch.special.gammaincc(a, x) > q,
                            torch.special.gammainc(a, x) < u)
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return torch.exp(0.5 * (lo + hi)).to(shape.device)


def gamma_quantile_gate(dev, card):
    """gamma_quantile on ``dev`` against scipy.special.gammaincinv, on the
    shapes the hyperparameter block makes (half-integers to 0.5 (V0E + N),
    counts + 1) and uniforms from 1e-9 to 1 - 1e-9: relative error <=
    1e-12 on the card (1e-9 on the CPU)."""
    import numpy as np
    import scipy.special
    import torch
    shapes = np.concatenate([np.arange(0.5, 200.0, 0.5), [0.50005, 1.00005,
                             2500.5, 5000.00005, 5000.5, 20001.0]])
    us = np.concatenate([[1e-9, 1e-6, 1e-3], np.linspace(0.01, 0.99, 21),
                         [1 - 1e-3, 1 - 1e-6, 1 - 1e-9]])
    a, u = (x.ravel() for x in np.meshgrid(shapes, us))
    want = scipy.special.gammaincinv(a, u)
    got = gamma_quantile(torch.from_numpy(a).to(dev),
                         torch.from_numpy(u).to(dev)).cpu().numpy()
    worst = float(np.max(np.abs(got - want) / want))
    print(f"# phase 10: gamma_quantile on the {dev.type} against "
          f"scipy.special.gammaincinv on {a.size} (shape, u) pairs: max "
          f"relative error {worst:.3e}  [{card}]", flush=True)
    if worst > (1e-12 if dev.type == "cuda" else 1e-9):
        fail(f"gamma_quantile is {worst:.3e} from scipy's gammaincinv")


@contextlib.contextmanager
def scripted(script, where):
    """The port's iteration fed from ``script`` (with ChainPlan in place of
    its RngPlan): torch's draws in sampler.gibbs and sampler.whole_sweep,
    and the hyperparameter block's gamma draws (the uniform in the boost
    slot) and variates (gamma_quantile, computed on ``where``); undone on
    exit."""
    import torch
    from gmrm_tpu_torch.sampler import dists
    from gmrm_tpu_torch.sampler import gibbs as pgibbs
    from gmrm_tpu_torch.sampler import whole_sweep

    def gamma_draws(gen, shape, device, out=None):
        u = torch.as_tensor(script.value(gen.it, gen.purpose),
                            dtype=torch.float64, device=device)
        if out is None:
            return (None, None, u)
        out[2].copy_(u)
        return out

    def gamma_from_draws(shape, draws):
        return gamma_quantile(shape, draws[2], where).to(
            dists._out_dtype(shape))

    proxy = ChainTorch(script)
    patches = [(pgibbs, "torch", proxy), (whole_sweep, "torch", proxy),
               (pgibbs, "gamma_draws", gamma_draws),
               (dists, "gamma_draws", gamma_draws),
               (dists, "gamma_from_draws", gamma_from_draws)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, value in patches:
            setattr(obj, name, value)
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def groups_dataset(sim, out_dir, n_groups=CHAIN_GROUPS):
    """``sim`` (its bed and phens) with a .gri/.grm of ``n_groups``
    annotation groups of consecutive markers, each with the anchor's
    mixtures."""
    os.makedirs(out_dir, exist_ok=True)
    gri = os.path.join(out_dir, f"g{n_groups}.gri")
    grm = os.path.join(out_dir, f"g{n_groups}.grm")
    with open(gri, "w") as fh:
        for j in range(sim.m):
            fh.write(f"{j} {j * n_groups // sim.m}\n")
    with open(grm, "w") as fh:
        for _ in range(n_groups):
            fh.write("0.00000 0.00010 0.00100 0.01000\n")
    return dataclasses.replace(sim, gri=gri, grm=grm)


def shard_states_to(states, dev):
    """Copies on ``dev`` of per-shard states that share their replicated
    leaves (one residual), as the sharded run's do."""
    first = to_device(states[0], dev, copy=True)
    return [dataclasses.replace(first, **{
        k: getattr(s, k).to(dev, copy=True) for k in ("betas", "comp",
                                                      "acum")})
            for s in states]


def chain_fields(states, aux):
    """The compared leaves on the host, the shards' marker leaves
    concatenated."""
    import torch
    if not isinstance(states, (list, tuple)):
        states = [states]
    out = {k: getattr(states[0], k).detach().cpu().clone()
           for k in ("eps", "cass", "sigmag", "sigmae", "pi_est", "mu")}
    for k in ("betas", "comp", "acum"):
        out[k] = torch.cat([getattr(s, k).detach().cpu() for s in states],
                           dim=1)
    out["m0"] = aux.m0.detach().cpu().clone()
    return out


def chain_compare(name, it, kern, plain, script, block_mode, m_locals,
                  m_pad, onehot, f64, tied, ties):
    """Phase 10(a)'s gates on one iteration: comp, cass and m0 equal;
    max|dbeta|, max|deps| <= 1e-4 (1e-9 at float64); acum within rtol
    1e-3, atol 1e-5 (1e-10, 1e-12); sigmaE, pi and mu within rtol 1e-4
    (1e-10), sigmaG too, and also by as much as the betas' differences
    move its group's sum of beta^2 (``onehot``: markers x groups).  A
    trait whose comp differs must have its first differing draw in
    processing order within TIE_ULPS ulps of its CDF boundary in the plain
    version's arithmetic; it is printed and left out from then on.
    Returns (max|dbeta|, max|deps|, sigmaG's largest relative error)."""
    import numpy as np
    import torch
    from gmrm_tpu_torch.config import V0G, S02G
    nT = kern["betas"].shape[0]
    for t in range(nT):
        if t in tied or torch.equal(kern["comp"][t], plain["comp"][t]):
            continue
        orders, u_nat = [], np.zeros(tuple(plain["betas"].shape))
        for s, ml in enumerate(m_locals):
            o = script.order(it, block_mode, ml, shard=s)
            u = np.moveaxis(script.value(it, "u", s), 1, 0).reshape(nT, -1)
            u_nat[:, s * m_pad + o] = u
            orders.append(s * m_pad + o)
        order = np.concatenate(orders)
        diff = (kern["comp"][t, order] != plain["comp"][t, order]).numpy()
        r = int(order[int(np.argmax(diff))])
        u = (np.float64 if f64 else np.float32)(u_nat[t, r])
        margin = abs(float(u) - float(plain["acum"][t, r]))
        ulps = margin / float(np.spacing(u))
        msg = (f"{name}: iteration {it}, trait {t}: comp differs first at "
               f"marker {r} (card {int(kern['comp'][t, r])}, plain "
               f"{int(plain['comp'][t, r])}); u {float(u):.9g}, acum card "
               f"{float(kern['acum'][t, r]):.9g}, plain "
               f"{float(plain['acum'][t, r]):.9g}; |u - cdf| {margin:.3e} = "
               f"{ulps:.2f} ulps")
        if ulps > TIE_ULPS:
            fail(msg)
        tied.add(t)
        ties.append(msg)
    keep = [t for t in range(nT) if t not in tied]
    if not keep:
        fail(f"{name}: every trait tied")
    k = {f: x[keep] for f, x in kern.items()}
    p = {f: x[keep] for f, x in plain.items()}
    for f in ("comp", "cass", "m0"):
        if not torch.equal(k[f], p[f]):
            fail(f"{name}, iteration {it}: {f} differs in "
                 f"{int((k[f] != p[f]).sum())} places")
    tol = 1e-9 if f64 else 1e-4
    db, de = max_err(k["betas"], p["betas"]), max_err(k["eps"], p["eps"])
    if db > tol or de > tol:
        fail(f"{name}, iteration {it}: max|dbeta| {db:.3e}, max|deps| "
             f"{de:.3e} above {tol}")
    rtol, atol = (1e-10, 1e-12) if f64 else (1e-3, 1e-5)
    if not torch.allclose(k["acum"].double(), p["acum"].double(), rtol=rtol,
                          atol=atol):
        fail(f"{name}, iteration {it}: acum off by "
             f"{max_err(k['acum'], p['acum']):.3e}")
    rtol = 1e-10 if f64 else 1e-4
    for f in ("sigmae", "pi_est", "mu"):
        if not torch.allclose(k[f].double(), p[f].double(), rtol=rtol,
                              atol=0.0):
            fail(f"{name}, iteration {it}: {f} off by "
                 f"{max_err(k[f], p[f]):.3e} (rtol {rtol})")
    bw = p["betas"].double().abs()
    d = (k["betas"].double() - p["betas"].double()).abs()
    slack = (2.0 * bw * d + d * d) @ onehot
    m0 = p["m0"].double()
    sg = p["sigmag"].double().abs()
    sqn = (bw * bw) @ onehot
    allowed = rtol * sg + sg * m0 * slack / (m0 * sqn + V0G * S02G)
    dsg = (k["sigmag"].double() - p["sigmag"].double()).abs()
    if (dsg > allowed).any():
        fail(f"{name}, iteration {it}: sigmag off by {float(dsg.max()):.3e}"
             f" beyond rtol {rtol} and the betas' share")
    return db, de, float((dsg / sg.clamp(min=1e-300)).max())


def chain_stepper(kind, static, state, script, dev, wave, shards):
    """``step(it) -> (state(s), aux)`` of a phase 10(a) path on ``dev``."""
    from gmrm_tpu_torch.parallel.distributed import Communicator
    from gmrm_tpu_torch.sampler.gibbs import (
        gibbs_iteration, gibbs_iteration_sharded,
    )
    from gmrm_tpu_torch.sampler.whole_sweep import WholeSweepIteration
    if kind == "default":
        return WholeSweepIteration(state, static, ChainPlan(script, dev),
                                   block_size=B, wave=wave)
    box = [state]
    if kind == "sharded":
        plans = [ChainPlan(script, dev, shard=i) for i in range(shards)]
        comm = Communicator(dev)

        def step(it):
            box[0], aux = gibbs_iteration_sharded(
                box[0], static, it, plans, block_size=B, wave=wave,
                comm=comm)
            return box[0], aux
        return step
    plan = ChainPlan(script, dev)
    mega = False if kind == "composed" else None

    def step(it):
        box[0], aux = gibbs_iteration(box[0], static, it, plan, block_size=B,
                                      wave=wave, megakernel=mega)
        return box[0], aux
    return step


def chain_path(name, sims, dev, card, paths=CHAIN_PATHS):
    """Phase 10(a) on one path of ``paths``: CHAIN_ITERS whole iterations
    from one start and one script with the kernels on the card and with the
    plain versions on the host CPU, compared after every iteration
    (chain_compare).  Returns its figures."""
    import torch
    from gmrm_tpu_torch import runner
    from gmrm_tpu_torch.config import resolve_plan
    from gmrm_tpu_torch.ops import _build

    t_path = time.perf_counter()
    ds, kind, wave, dtype, shards, n_ph = paths[name]
    sim = sims[ds]
    phens = sim.phens[:n_ph] if n_ph else None
    cpu = torch.device("cpu")
    if shards > 1:
        opt, data, statics, states, _ = sharded_setup(sim, dev, shards, wave,
                                                      dtype, phens)
        m_pad, m_locals = data.layout.m_pad_shard, list(data.m_local)
        start = {"card": (statics, states),
                 "host": ([to_device(x, cpu) for x in statics],
                          shard_states_to(states, cpu))}
        static0 = statics[0]
        group_of = torch.cat([x.group_of.cpu() for x in statics])
    else:
        opt = anchor_options(sim, "", wave, dtype=dtype, phens=phens)
        resolve_plan(opt, "cuda", sim.m)
        data = runner.load_data(opt)
        static0 = runner.build_static(data, opt, dev)
        state = runner.init_sampler_state(data, opt, dev)
        m_pad, m_locals = data.m_pad, [data.m_local]
        start = {"card": (static0, state),
                 "host": (to_device(static0, cpu),
                          to_device(state, cpu, copy=True))}
        group_of = static0.group_of.cpu()
    if opt.wave_size != wave:
        fail(f"{name}: the plan resolved to W={opt.wave_size}")
    nT = len(opt.phen_files)
    G, Kv = static0.cva.shape
    nblocks = m_pad // B
    block_mode = static0.gram_cache is not None
    if kind == "default" and not block_mode:
        fail(f"{name}: the whole-sweep path needs a Gram cache")
    script = ChainScript(20261018, nT, G, Kv, nblocks, B, n_shards=shards)
    fields, seconds = {}, {}
    cuda = dev.type == "cuda"
    with scripted(script, dev):
        for side, d in (("card", dev), ("host", cpu)):
            step = chain_stepper(kind, *start[side], script, d, wave,
                                 shards)
            if side == "card" and cuda:
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            fields[side] = [chain_fields(*step(it))
                            for it in range(1, CHAIN_ITERS + 1)]
            seconds[side] = time.perf_counter() - t0
            if side == "card":
                peak = torch.cuda.max_memory_allocated() if cuda else 0
                launches = {k: v for k, v in launch_counts().items()
                            if v}
    if cuda and not launches:
        fail(f"{name}: no kernel launched on the card")
    onehot = (group_of[:, None] == torch.arange(G)[None, :]).double()
    tied, ties, worst = set(), [], (0.0, 0.0, 0.0)
    for it, (kern, plain) in enumerate(zip(fields["card"], fields["host"]),
                                       1):
        got = chain_compare(name, it, kern, plain, script, block_mode,
                            m_locals, m_pad, onehot, dtype == "float64",
                            tied, ties)
        worst = tuple(max(a, b) for a, b in zip(worst, got))
    moved = int((fields["card"][-1]["comp"] != 0).sum())
    if not moved:
        fail(f"{name}: no marker left component 0")
    wall = time.perf_counter() - t_path
    print(f"# phase 10(a) {name} (T={nT}, W={opt.wave_size}, S={shards}, "
          f"{dtype}, {nblocks} blocks{' a shard' if shards > 1 else ''}, "
          f"Mt={sim.m}, G={G}, NT={1 if static0.shared_na else nT}): "
          f"{CHAIN_ITERS} whole iterations, card against the plain versions "
          f"on the host CPU from one start and one script: comp, cass and m0 "
          f"equal after each, max|dbeta| {worst[0]:.3e}, max|deps| "
          f"{worst[1]:.3e}, sigmaG max rel {worst[2]:.3e}; "
          f"{'; '.join(ties) if ties else 'no tie'}; {moved} (trait, "
          f"marker) pairs off component 0; card {seconds['card']:.2f} s, "
          f"host CPU {seconds['host']:.2f} s; launches {launches}; peak "
          f"device memory {peak / 2**20:.1f} MiB; {wall:.1f} s  [{card}]",
          flush=True)
    return {"seconds": wall, "peak": peak, "launches": launches,
            "worst": worst, "ties": ties}


def dataset_digest(sim):
    """sha256 over a dataset: each file's base name, the bytes of its
    .bed, .dim, .bim, .gri and .grm, and of each .phen every line's ids
    with its value rounded to float32 (the simulator's phenotypes come from
    a BLAS product, whose last bits differ from machine to machine: two
    hosts with other numpy builds write other .phen bytes from the same
    genotypes)."""
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    for p in [sim.bed, sim.dim, sim.bim, sim.gri, sim.grm, *sim.phens]:
        h.update(os.path.basename(p).encode())
        if p not in sim.phens:
            with open(p, "rb") as fh:
                h.update(fh.read())
            continue
        with open(p) as fh:
            for line in fh:
                fid, iid, val = line.split()
                h.update(f"{fid} {iid} ".encode())
                h.update(b"NA" if val == "NA"
                         else np.float32(float(val)).tobytes())
    return h.hexdigest()


def equiv_dataset(tmp):
    """benchmarking/EQUIVALENCE.md's anchor-scale dataset (N=10,000,
    M=20,000, 4 traits), from the port's simulator."""
    import numpy as np
    from gmrm_tpu_torch.io.sim import simulate
    return simulate(tmp, n=EQ_N, m=EQ_M, n_traits=EQ_T, n_causal=EQ_M // 4,
                    h2=0.5, n_groups=2, na_rate=0.01, seed=EQ_SEED,
                    mixtures=np.array([0.0, 0.0001, 0.001, 0.01]))


def csv_chain(path):
    """(sigmaE, h2) per record of a .csv."""
    import numpy as np
    se, h2 = [], []
    with open(path) as fh:
        for line in fh:
            parts = [p.strip() for p in line.split(",") if p.strip()]
            if parts:
                g = int(parts[1])
                se.append(float(parts[2 + g]))
                h2.append(float(parts[3 + g]))
    return np.asarray(se), np.asarray(h2)


def equivalence_phase(sim, dev, tmp, card):
    """Phase 10(b): the anchor-scale dataset regenerated by the port's
    simulator (its digest checked against the JAX package's), run_training
    at W=32 (B=128) for EQ_ITERS iterations at each of EQ_SEEDS (thin
    EQ_THIN, the first 40% of records burn-in) and a W=1 control; each
    trait's pooled posterior-mean h2 held to EQUIVALENCE.md's reference
    rows: |diff| <= max(3 hypot(SEM_ref, SEM_port), 0.015), the control
    within 0.03 of the reference's control (the criterion's floor, which
    governs at these chains' spread), and the pooled sigmaE within
    max(3 hypot(SEM_ref, SEM_port), 3% of the mean)."""
    import numpy as np
    from gmrm_tpu_torch.config import Options
    from gmrm_tpu_torch.io.writers import read_history
    from gmrm_tpu_torch.runner import run_training

    t_phase = time.perf_counter()
    digest = dataset_digest(sim)
    if digest != EQ_DIGEST:
        fail(f"phase 10(b): the dataset's digest {digest} is not the JAX "
             f"package's {EQ_DIGEST}")
    print(f"# phase 10(b): the anchor-scale dataset from the port's "
          f"simulator (N={EQ_N}, M={EQ_M}, {EQ_T} traits, 2 groups, 1% NAs, "
          f"seed {EQ_SEED}): digest (phenotypes at float32) equal to the JAX "
          f"package's; realized h2 "
          f"{[round(float(x), 6) for x in sim.h2_realized]}", flush=True)

    def chain(seed, wave):
        out = os.path.join(tmp, f"eq_w{wave}_s{seed}")
        opt = Options(bed_file=sim.bed, dim_file=sim.dim,
                      phen_files=list(sim.phens), group_index_file=sim.gri,
                      group_mixture_file=sim.grm, iterations=EQ_ITERS,
                      seed=seed, out_dir=out, block_size=B, wave_size=wave,
                      output_thin_rate=EQ_THIN)
        opt.validate()
        opt.load_group_mixtures()
        t0 = time.perf_counter()
        run_training(opt, device=dev, verbose=False)
        rows = []
        for t, ph in enumerate(sim.phens):
            base = os.path.join(out, os.path.splitext(
                os.path.basename(ph))[0])
            se, h2 = csv_chain(base + ".csv")
            _, bet = read_history(base + ".bet", "f8")
            if len(h2) != EQ_ITERS // EQ_THIN or bet.shape[0] != len(h2):
                fail(f"phase 10(b): {base}.csv/.bet hold {len(h2)} and "
                     f"{bet.shape[0]} records")
            k = int(len(h2) * EQ_BURN)
            beta = bet[k:].mean(axis=0)
            rows.append({"h2": float(h2[k:].mean()),
                         "h2_sd": float(h2[k:].std()),
                         "sigmae": float(se[k:].mean()),
                         "corr_truth": float(np.corrcoef(
                             beta, sim.beta_true[:, t])[0, 1])})
        return rows, time.perf_counter() - t0

    runs = [chain(s, W) for s in EQ_SEEDS]
    control, ctl_s = chain(EQ_W1_SEED, 1)
    ok = True
    lines = []
    for t in range(EQ_T):
        ours = np.array([r[0][t]["h2"] for r in runs])
        ref = np.array(EQ_REF_H2[t])
        sem_o = ours.std(ddof=1) / np.sqrt(len(ours))
        sem_r = ref.std(ddof=1) / np.sqrt(len(ref))
        tol = max(3.0 * float(np.hypot(sem_r, sem_o)), 0.015)
        diff = abs(ours.mean() - ref.mean())
        cd = abs(control[t]["h2"] - EQ_REF_W1[t])
        se_o = np.array([r[0][t]["sigmae"] for r in runs])
        se_r = np.array(EQ_REF_SE[t])
        se_tol = max(3.0 * float(np.hypot(
            se_r.std(ddof=1) / np.sqrt(len(se_r)),
            se_o.std(ddof=1) / np.sqrt(len(se_o)))),
            0.03 * (se_o.mean() + se_r.mean()) / 2)
        se_diff = abs(se_o.mean() - se_r.mean())
        ok = ok and diff <= tol and cd <= 0.03 and se_diff <= se_tol
        lines.append(
            f"trait {t}: port W={W} h2 {[round(float(x), 4) for x in ours]} "
            f"pooled "
            f"{ours.mean():.4f}+-{sem_o:.4f} against the reference "
            f"{ref.mean():.4f}+-{sem_r:.4f}: diff {diff:.4f} <= tol "
            f"{tol:.4f} {'PASS' if diff <= tol else 'FAIL'}; W=1 control "
            f"{control[t]['h2']:.4f} against {EQ_REF_W1[t]:.4f}: diff "
            f"{cd:.4f} <= 0.03 {'PASS' if cd <= 0.03 else 'FAIL'}; sigmaE "
            f"pooled {se_o.mean():.4f} against {se_r.mean():.4f}: diff "
            f"{se_diff:.4f} <= tol {se_tol:.4f} "
            f"{'PASS' if se_diff <= se_tol else 'FAIL'}; corr(beta, truth) "
            f"{min(r[0][t]['corr_truth'] for r in runs):.4f} at the least "
            f"seed")
    for line in lines:
        print(f"# phase 10(b) {line}  [{card}]", flush=True)
    secs = [round(r[1], 2) for r in runs]
    print(f"# phase 10(b): W={W} chains of {EQ_ITERS} iterations at seeds "
          f"{EQ_SEEDS}: {secs} s each (run_training, startup included); W=1 "
          f"control {ctl_s:.2f} s; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s  [{card}]", flush=True)
    if not ok:
        fail("phase 10(b): the anchor-scale posteriors fail the criterion "
             "of benchmarking/EQUIVALENCE.md")


def chains_phase(sims, dev, tmp, card):
    """Phase 10: (a) every training path's whole iterations on the card
    against the plain versions (chain_path, CHAIN_PATHS), with its peak
    device memory; (b) the anchor-scale posteriors (equivalence_phase)."""
    t_phase = time.perf_counter()
    gamma_quantile_gate(dev, card)
    sims = dict(sims, groups=groups_dataset(
        sims["anchor"], os.path.join(tmp, "groups")))
    rows = {name: chain_path(name, sims, dev, card)
            for name in CHAIN_PATHS}
    t_a = time.perf_counter() - t_phase
    print(f"# phase 10(a): {len(rows)} paths in {t_a:.1f} s; peak device "
          f"memory MiB "
          f"{ {k: round(v['peak'] / 2**20, 1) for k, v in rows.items()} }  "
          f"[{card}]", flush=True)
    equivalence_phase(sims["equiv"], dev, tmp, card)
    print(f"# phase 10 wall {time.perf_counter() - t_phase:.1f} s  [{card}]",
          flush=True)
    return rows


def chains_only(dev, tmp, card):
    """``--chains-only``: phase 10 alone, its datasets simulated by worker
    processes while the kernels build."""
    from gmrm_tpu_torch.ops import _build
    datasets = (("anchor", anchor_dataset), ("small", small_dataset),
                ("traits16na", traits_anchor_na), ("equiv", equiv_dataset))
    with concurrent.futures.ProcessPoolExecutor(
            len(datasets), mp_context=multiprocessing.get_context("spawn"),
            initializer=one_thread) as pool:
        futs = {name: pool.submit(make, os.path.join(tmp, name))
                for name, make in datasets}
        build_host_library()
        t0 = time.perf_counter()
        _build.build()
        _build.library()
        print(f"# build {time.perf_counter() - t0:.1f} s", flush=True)
        sims = {name: f.result() for name, f in futs.items()}
    sims["anchor_na"] = sims.pop("traits16na")
    chains_phase(sims, dev, tmp, card)


# ---- phase 11: any number of mixture components -----------------------------

ANY_K = (17, 33)        # the kernels' gates and training at the anchor
ANY_K_SMALL = 65        # and on the small panel
ANY_K_ITERS = 10        # run_training at K = 4, 17, 33 (ms/iteration over
                        # the iterations after THIN, sync to sync)
ANY_K_CLI_ITERS = 3     # the command line's runs with a 17-column .grm
# Phase 10(a)'s paths with a 17-column .grm (CHAIN_ITERS whole iterations
# each against the plain versions), on the small panel: the host CPU's
# plain sweeps are the phase's time, and 32 blocks take a fifth of the
# anchor's; the composed path has no command-line switch, so it is held
# here only.
ANY_K_CHAIN_PATHS = {
    "K=17 W=32 default": ("small17", "default", W, "float32", 1, None),
    "K=17 W=32 composed": ("small17", "composed", W, "float32", 1, None),
    "K=17 W=1": ("small17", "gibbs", 1, "float32", 1, None),
    "K=17 S=2 W=32": ("small17", "sharded", W, "float32", 2, None),
    "K=17 float64 W=1": ("small17", "gibbs", 1, "float64", 1, None),
    "K=17 float64 W=32": ("small17", "gibbs", W, "float64", 1, None),
}
# The command line's runs at the anchor with a 17-column .grm: name ->
# extra arguments.
ANY_K_CLI = {"W=32": [], "W=1": ["--wave-size", "1"],
             "S=2": ["--devices", "2"],
             "float64 W=1": ["--dtype", "float64"],
             "float64 W=32": ["--dtype", "float64", "--wave-size", str(W)]}
# And on the small panel with a 65-column .grm (its 32 blocks plan W=1
# unless the wave is named).
ANY_K_CLI_SMALL = {"W=32": ["--wave-size", str(W)],
                   "W=1": ["--wave-size", "1"]}
# The scans' kernels: (name, scan class, dtype); kernels 7/8 and 9 are
# held through their sweeps.
ANY_K_SCANS = (("serial_scan", "serial", "float32"),
               ("serial_scan_f64", "serial", "float64"),
               ("wave_scan", "wave", "float32"),
               ("wave_scan_f64", "wave", "float64"))


def mixtures(Kv):
    """A .grm row of Kv strictly ascending variances: 0, then Kv - 1 log
    spaced from 1e-5 to 1e-2."""
    import numpy as np
    return np.concatenate([[0.0], np.logspace(-5, -2, Kv - 1)])


def mixtures_dataset(sim, out_dir, Kv):
    """``sim`` with a one-group .grm of Kv components (``mixtures``)."""
    os.makedirs(out_dir, exist_ok=True)
    grm = os.path.join(out_dir, f"k{Kv}.grm")
    with open(grm, "w") as fh:
        fh.write(" ".join(f"{v:.10g}" for v in mixtures(Kv)) + "\n")
    return dataclasses.replace(sim, grm=grm)


def any_k_bound(kind, Tv, Bv, Kv, Wv, es):
    """The least ms of one block's scan: each operand read once (c, the
    state, the draws and msig, three int32 masks, the 3 K tables, the Gram
    entries the fold reads), the outputs written once (dbeta, d, beta,
    acum; comp), against the operations: the fold's product and sum per
    Gram entry read and, per (trait, marker), K exponentials of some 4
    operations (the wave draw) or K^2 (the serial draw's K sums)."""
    tb = Tv * Bv
    rows = (Bv * (Bv - 1) // 2 if kind == "serial"
            else Wv * sum(Bv - (w + 1) * Wv for w in range(Bv // Wv)))
    nbytes = es * (6 * tb + 3 * Kv * tb + Tv * rows + 4 * tb) + 4 * 4 * tb
    ops = 2 * Tv * rows + 4 * tb * Kv * (Kv if kind == "serial" else 1)
    return bound_of(nbytes, (ops, F64_OPS if es == 8 else F32_OPS))


def any_k_operands(dev, gen, Kv, nb, pad, dtype):
    """The scans' sweep operands (f64_scan_operands at T, B) in ``dtype``,
    with a quarter of the markers' c scaled by 40, so that their draws take
    the 700 guard; per-trait Grams."""
    import torch
    ops, c, gs, live = f64_scan_operands(dev, gen, T, B, Kv, nb, pad)
    big = torch.rand(c.shape, generator=gen, device=dev) < 0.25
    c = torch.where(big, c * 40.0, c)
    cast = [x.to(dtype) if x.is_floating_point() else x for x in ops]
    return cast, c.to(dtype), gs["NT=4"].to(dtype), live


def any_k_held(name, got, want, u, f64, live):
    """comp equal to the plain version's, where a trait's first differing
    draw may be a tie (within TIE_ULPS ulps of its CDF boundary: the
    trait is then left out); dbeta, beta and acum within the paths'
    gates.  Returns (max abs err, ties)."""
    import numpy as np
    keep, ties = [], []
    for t in range(got[2].shape[0]):
        diff = (got[2][t] != want[2][t]).nonzero()
        if not len(diff):
            keep.append(t)
            continue
        j = int(diff[0])
        uj = float(u[t, j])
        margin = min(abs(uj - float(got[3][t, j])),
                     abs(uj - float(want[3][t, j])))
        ulps = margin / float(np.spacing((np.float64 if f64
                                          else np.float32)(uj)))
        msg = (f"{name}: trait {t} comp differs first at marker {j} "
               f"({int(got[2][t, j])} against {int(want[2][t, j])}), "
               f"|u - cdf| {ulps:.2f} ulps")
        if ulps > TIE_ULPS:
            fail(msg)
        ties.append(msg)
    if not keep:
        fail(f"{name}: every trait tied")
    err = 0.0
    for part, i in (("dbeta", 0), ("beta", 1), ("acum", 3)):
        g, w = got[i][keep], want[i][keep]
        err = max(err, close64(f"{name} {part}", g, w) if f64
                  else close(f"{name} {part}", g, w, 1e-5, 1e-5))
    if int(want[2][live != 0].max()) < 1:
        fail(f"{name}: no live draw left component 0")
    return err, ties


def any_k_guarded(blk, dbeta, live_b, Wv):
    """Live (trait, marker) draws of a block whose log-likelihoods spread
    over more than 700, num rebuilt from the plain version's dbeta (the
    corrections of the markers before it: of the earlier waves)."""
    import torch
    base, lc, rd, gs_b, i2se = blk[0], blk[1], blk[2], blk[4], blk[-1]
    j = torch.arange(base.shape[1], device=base.device)
    before = (j[:, None] // Wv) < (j[None, :] // Wv)
    num = base + (dbeta[:, :, None] * gs_b * before).sum(1)
    logl = lc + rd * num * (num * i2se[:, None])
    spread = logl.max(0).values - logl.min(0).values
    return int(((spread > 700.0) & (live_b != 0)).sum())


def any_k_scan_gates(dev, gen, card):
    """Kernels 6, C, 3 and E against their plain versions on the card at
    K = 17 and 33 on the anchor's 157-block arrays (a middle block and the
    last, with its 96 pad slots) and at K = 65 on the small panel's 32
    blocks, per-trait Grams, a quarter of the draws past the 700 guard:
    each launch twice (bit-equal), comp exact but for a tie, the rest
    within the kernels' gates (any_k_held).  Then kernel 6 at K=17 in its
    one-CTA routes (one trait; two traits in passes at B=640, the state
    staged; three at K=33, nothing staged) and kernel C at K=65, B=512
    with its tables in global memory (mode 1).  The ms of
    a block (graph replay) at K = 4, 17, 33 and 65, the plain version's,
    and the bound.  Returns {name: rows}."""
    import torch
    from gmrm_tpu_torch.ops import scan_kernel as sk6
    from gmrm_tpu_torch.ops import scan_kernel_wave as sw
    nblocks = -(-MT // B)
    rows = {}
    cases = [(Kv, nblocks, 96) for Kv in (K, *ANY_K)]
    cases.append((ANY_K_SMALL, MT_SMALL // B, 3))
    for Kv, nb, pad in cases:
        for name, kind, dtype in ANY_K_SCANS:
            f64 = dtype == "float64"
            dty = torch.float64 if f64 else torch.float32
            ops, c, gs, live = any_k_operands(dev, gen, Kv, nb, pad, dty)
            Wv = W if kind == "wave" else 1
            sweep = (sw.WaveScanSweep(*ops, wave=W) if kind == "wave"
                     else sk6.SerialScanSweep(*ops))
            errs, ties, guarded, top = 0.0, [], 0, 0
            for b in (nb // 2, nb - 1):
                def step(b=b):
                    sweep.step(b, c, gs, b, bc=b)
                    return tuple(x[b].clone() for x in (
                        sweep.dbeta, sweep.beta_new, sweep.comp_new,
                        sweep.acum_new, sweep.d))
                got = bit_equal_twice(f"{name} K={Kv} block {b}", step)
                if Kv == K:
                    continue
                base = (c[b] + ops[4][b] * ops[0][:, None]).contiguous()
                blk = (base, *(x[b] for x in ops[1:4]), gs[b],
                       *(x[b] for x in ops[4:11]), ops[12])
                want = (sw.wave_scan_plain(*blk, W) if kind == "wave"
                        else sk6.serial_scan_plain(*blk))
                top = max(top, int(want[2][live[b] != 0].max()))
                e, t = any_k_held(f"{name} K={Kv} block {b}", got, want,
                                  ops[7][b], f64, live[b])
                errs, ties = max(errs, e), ties + t
                guarded += any_k_guarded(blk, want[0], live[b], Wv)
                if not torch.equal(got[4], ops[11][b] * got[0]):
                    fail(f"{name} K={Kv}: d is not msig * dbeta bit for bit")
            if Kv != K and not guarded:
                fail(f"{name} K={Kv}: no draw took the 700 guard")
            plan = list(sw.launch_plan(T, B, Kv, W, 8 if f64 else 4)
                        if kind == "wave" else sk6.f64_plan(T, B, Kv) if f64
                        else sk6.launch_plan(T, B, Kv))
            bm = nb // 2
            base = (c[bm] + ops[4][bm] * ops[0][:, None]).contiguous()
            blk = (base, *(x[bm] for x in ops[1:4]), gs[bm],
                   *(x[bm] for x in ops[4:11]), ops[12])
            ms = cuda_ms(lambda: sweep.step(bm, c, gs, bm, bc=bm), 50)
            plain = ((lambda: sw.wave_scan_plain(*blk, W)) if kind == "wave"
                     else (lambda: sk6.serial_scan_plain(*blk)))
            plain_ms = call_ms(plain, 2)
            bound = any_k_bound(kind, T, B, Kv, Wv, 8 if f64 else 4)
            rows.setdefault(name, []).append(dict(
                K=Kv, blocks=nb, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], max_abs_err=errs, guarded=guarded,
                top=top, plan=plan, ties=ties))
            print(f"# any K: {name} K={Kv} ({nb} blocks, T={T}, B={B}, plan "
                  f"{plan}): "
                  + ("the timing's reference, ungated here (phase 2 and 7 "
                     "gate K=4); " if Kv == K else
                     f"two blocks against the plain version, comp equal"
                     f"{' but ' + '; '.join(ties) if ties else ''}, max abs "
                     f"err {errs:.3e}, {guarded} live draws past the 700 "
                     f"guard, components drawn up to {top}; ")
                  + f"kernel {ms:.5f} ms a block (graph replay), plain "
                  f"{plain_ms:.3f} ms (eager), bound {bound[0]:.6f} ms by "
                  f"{bound[1]}  [{card}]", flush=True)
            del ops, c, gs, sweep
    # Kernel 6's one-CTA routes and kernel C's tables in global memory,
    # one block's tensors each.
    for Tv, Bv, Kv, f64, plan in ((1, B, 17, False, (2, 8, 16, 1)),
                                  (2, 640, 17, False, (1, 8, 2, 2)),
                                  (3, 640, 33, False, (0, 8, 2, 3)),
                                  (2, 512, 65, True, (1, 8, 4, 1))):
        args, live = scan_case(dev, gen, Tv, Bv, Kv)
        if f64:
            args = tuple(x.double() if x.is_floating_point() else x
                         for x in args)
        got_plan = (sk6.f64_plan(Tv, Bv, Kv) if f64
                    else sk6.launch_plan(Tv, Bv, Kv))
        if got_plan != plan:
            fail(f"serial_scan T={Tv}, B={Bv}, K={Kv}: plan {got_plan}")
        name = f"serial_scan{'_f64' if f64 else ''} T={Tv}, B={Bv}, K={Kv}"
        got = bit_equal_twice(name, lambda: sk6.serial_scan(*args))
        want = sk6.serial_scan_plain(*args)
        err, ties = any_k_held(name, got, want, args[8], f64, live)
        print(f"# any K: {name}, plan {got_plan}: comp equal"
              f"{' but ' + '; '.join(ties) if ties else ''}, max abs err "
              f"{err:.3e}  [{card}]", flush=True)
    return rows


def any_k_training(sim, dev, tmp, Kv, wave, iterations):
    """run_training at the anchor with a Kv-column .grm: the launches (the
    Gram cache once and kernels 7/8 once an iteration at W>1; the serial
    path's at W=1), components drawn up to Kv - 1, the steady ms an
    iteration after THIN."""
    import numpy as np
    import torch
    from gmrm_tpu_torch.io.writers import read_history
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.runner import run_training
    out_dir = os.path.join(tmp, f"anyk_k{Kv}_w{wave}")
    opt = anchor_options(sim, out_dir, wave, iterations)
    gc.collect()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    res = run_training(opt, device=dev, verbose=False)
    launches = {k: v for k, v in launch_counts().items() if v}
    want = ({"gram_cache": 1, "sweep_blocks": iterations} if wave > 1
            else serial_counts(-(-MT // B), sweeps=iterations))
    if launches != want:
        fail(f"K={Kv} W={wave} training: launches {launches}, expected "
             f"{want}")
    base = os.path.join(out_dir, os.path.splitext(
        os.path.basename(sim.phens[0]))[0])
    _, cpn = read_history(base + ".cpn", "i4")
    if cpn.min() < 0 or cpn.max() >= Kv or not np.isfinite(
            res.state.sigmag.cpu().numpy()).all():
        fail(f"K={Kv} W={wave} training: components or chain out of range")
    return sum(res.iter_seconds[THIN:]) / (iterations - THIN), int(cpn.max())


def any_k_cli(sim, Kv, where, paths, dev, tmp, card):
    """``python -m gmrm_tpu_torch`` (cli.main) on the card with ``sim``'s
    Kv-column .grm, ANY_K_CLI_ITERS iterations of each of ``paths`` (name
    -> extra arguments, ANY_K_CLI's): exit 0, the path's kernels launched,
    every .cpn component in 0 .. Kv - 1.  Returns {path: launches}."""
    import numpy as np
    from gmrm_tpu_torch import cli
    from gmrm_tpu_torch.io.writers import read_history
    from gmrm_tpu_torch.ops import _build
    out = {}
    scans = {"W=32": "sweep_blocks", "W=1": "serial_scan",
             "S=2": "block_sweep", "float64 W=1": "serial_scan_f64",
             "float64 W=32": "wave_scan_f64"}
    for name, extra in paths.items():
        out_dir = os.path.join(tmp, f"anyk_cli_k{Kv}_" + name.replace(
            " ", "_").replace("=", ""))
        argv = ["--bed-file", sim.bed, "--dim-file", sim.dim,
                "--phen-files", ",".join(sim.phens),
                "--group-index-file", sim.gri,
                "--group-mixture-file", sim.grm,
                "--iterations", str(ANY_K_CLI_ITERS), "--seed", "42",
                "--out-dir", out_dir, "--output-thin-rate", "1",
                "--verbosity", "-1", *extra]
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        if cli.main(argv, device=dev):
            fail(f"any K: the command line's {name} run with a {Kv}-column "
                 f".grm exited non-zero")
        launches = {k: v for k, v in launch_counts().items() if v}
        if not launches.get(scans[name]):
            fail(f"any K: the command line's {name} run launched "
                 f"{launches}, not {scans[name]}")
        top = 0
        for ph in sim.phens:
            base = os.path.join(out_dir, os.path.splitext(
                os.path.basename(ph))[0])
            _, cpn = read_history(base + ".cpn", "i4")
            if cpn.shape[0] != ANY_K_CLI_ITERS or cpn.min() < 0 \
                    or cpn.max() >= Kv or not np.isfinite(
                        read_history(base + ".bet", "f8")[1]).all():
                fail(f"any K: {base}.cpn/.bet of the {name} run")
            top = max(top, int(cpn.max()))
        out[name] = launches
        print(f"# any K: python -m gmrm_tpu_torch {' '.join(extra) or '(W=32 '
              f'auto)'} {where} with a {Kv}-column .grm, "
              f"{ANY_K_CLI_ITERS} iterations: exit 0, components up to "
              f"{top}, launches {launches}; {time.perf_counter() - t0:.1f} s"
              f"  [{card}]", flush=True)
    return out


def any_k_phase(sims, dev, gen, tmp, card):
    """Phase 11: any number of mixture components.  (a) the scans'
    kernels (any_k_scan_gates); (b) kernels 7/8 and 9 through one sweep
    against their plain versions on the host CPU (sweep_gate and
    sharded_gate: W=32, S=2 at W=32) at K = 17 and 33 at the anchor and at
    K = 65 on the small panel; (c) the command line at the anchor with a
    17-column .grm and on the small panel with a 65-column one
    (any_k_cli); (d) phase 10(a)'s paths with a 17-column .grm on the
    small panel (ANY_K_CHAIN_PATHS); (e) run_training at the anchor at
    W=32 and W=1 at K = 4, 17 and 33, ms/iteration; and the ptxas
    resources of every instance of the kernels that take any K."""
    t_phase = time.perf_counter()
    anchor, small = sims["anchor"], sims["small"]
    data = {f"anchor{Kv}": mixtures_dataset(anchor, os.path.join(
        tmp, f"anyk_anchor{Kv}"), Kv) for Kv in ANY_K}
    data["small17"] = mixtures_dataset(small, os.path.join(
        tmp, "anyk_small17"), 17)
    data[f"small{ANY_K_SMALL}"] = mixtures_dataset(small, os.path.join(
        tmp, f"anyk_small{ANY_K_SMALL}"), ANY_K_SMALL)
    rows = any_k_scan_gates(dev, gen, card)
    for key in (*(f"anchor{Kv}" for Kv in ANY_K), f"small{ANY_K_SMALL}"):
        sweep_gate(data[key], dev, W, f"any K: {key} W={W} sweep gate", card,
                   tie_aware=True)
        sharded_gate(data[key], dev, card, 2, W,
                     f"any K: {key} S=2 W={W} sharded sweep gate",
                     against="plain", tie_aware=True)
    cli_launches = any_k_cli(data["anchor17"], 17, "at the anchor",
                             ANY_K_CLI, dev, tmp, card)
    cli_launches.update({f"K={ANY_K_SMALL} {k}": v for k, v in any_k_cli(
        data[f"small{ANY_K_SMALL}"], ANY_K_SMALL, "on the small panel",
        ANY_K_CLI_SMALL, dev, tmp, card).items()})
    chains = {name: chain_path(name, data, dev, card, ANY_K_CHAIN_PATHS)
              for name in ANY_K_CHAIN_PATHS}
    per_iter = {}
    for Kv in (K, *ANY_K):
        sim = anchor if Kv == K else data[f"anchor{Kv}"]
        for wave in (W, 1):
            per_iter[(Kv, wave)] = any_k_training(sim, dev, tmp, Kv, wave,
                                                  ANY_K_ITERS)
    for (Kv, wave), (steady, top) in per_iter.items():
        print(f"# any K: run_training at the anchor, K={Kv}, W={wave}: "
              f"{steady * 1e3:.2f} ms/iteration over iterations "
              f"{THIN + 1}-{ANY_K_ITERS}, components up to {top}  [{card}]",
              flush=True)
    print(f"# any K: ptxas of the instances that take any K: "
          f"{any_k_ptxas()}", flush=True)
    print(f"# phase 11 (any K) wall {time.perf_counter() - t_phase:.1f} s  "
          f"[{card}]", flush=True)
    return {"scans": rows, "cli": cli_launches, "chains": chains,
            "per_iter": per_iter}


# A kernel's anonymous namespace in its mangled name, which the compiler
# names after the source's path: reduced to the source's file name, so
# that two trees' kernels compare by name.
ANON_NS = re.compile(r"_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_(\w+?_cu)_[0-9a-f]+")


def ptxas_resources(log):
    """{entry function (ANON_NS reduced): (registers, stack bytes, spill
    stores, spill loads)} of an nvcc -Xptxas=-v log."""
    out, name, frame, props = {}, None, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, frame = m.group(1), None
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name and props == name:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and frame is not None:
            out[ANON_NS.sub(r"_ZN\1_", name)] = (int(m.group(1)), *frame)
            name = None
    return out


def any_k_ptxas():
    """The ptxas resources of this tree's instances that take any K (the
    serial scan's of 32 lanes a trait, the others' of bound GMRM_ANY_K):
    'function: registers/stack/spill stores/spill loads'."""
    from gmrm_tpu_torch.ops import _build
    res = ptxas_resources((_build.BUILD_DIR / "build.log").read_text())
    pat = re.compile(r"serial_scan_kernelI[fd]Li32E|"
                     r"(wave_scan|sweep_blocks|block_sweep)_kernelI\w*Li0E")
    return "; ".join(f"{n}: {'/'.join(map(str, r))}"
                     for n, r in sorted(res.items()) if pat.search(n))


def any_k_only(dev, tmp, card):
    """``--any-k-only``: phase 11 alone, the anchor and the small panel
    simulated by worker processes while the kernels build."""
    import torch
    from gmrm_tpu_torch.ops import _build
    datasets = (("anchor", anchor_dataset), ("small", small_dataset))
    with concurrent.futures.ProcessPoolExecutor(
            len(datasets), mp_context=multiprocessing.get_context("spawn"),
            initializer=one_thread) as pool:
        futs = {name: pool.submit(make, os.path.join(tmp, name))
                for name, make in datasets}
        build_host_library()
        t0 = time.perf_counter()
        _build.build()
        _build.library()
        print(f"# build {time.perf_counter() - t0:.1f} s", flush=True)
        sims = {name: f.result() for name, f in futs.items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261019)
    any_k_phase(sims, dev, gen, tmp, card)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--training-only", type=int, default=0,
                        metavar="REPS")
    parser.add_argument("--sweep-only", type=int, default=0,
                        metavar="REPS")
    parser.add_argument("--sharded-only", type=int, default=0,
                        metavar="REPS")
    parser.add_argument("--f64-only", type=int, default=0, metavar="REPS")
    parser.add_argument("--wave64-only", action="store_true")
    parser.add_argument("--wave64-pairs", type=int, default=0, metavar="N")
    parser.add_argument("--traits-only", type=int, default=0,
                        metavar="REPS")
    parser.add_argument("--predict-only", type=int, default=0,
                        metavar="REPS")
    parser.add_argument("--predict-pairs", type=int, default=0,
                        metavar="N")
    parser.add_argument("--against", action="append", default=[],
                        metavar="TREE")
    parser.add_argument("--io-only", action="store_true")
    parser.add_argument("--chains-only", action="store_true")
    parser.add_argument("--any-k-only", action="store_true")
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
    if args.io_only:
        with tempfile.TemporaryDirectory() as tmp:
            io_only(dev, tmp, card)
        return
    if args.chains_only:
        with tempfile.TemporaryDirectory() as tmp:
            chains_only(dev, tmp, card)
        return
    if args.any_k_only:
        with tempfile.TemporaryDirectory() as tmp:
            any_k_only(dev, tmp, card)
        return
    if args.wave64_only:
        wave64_only(dev, card)
        if not args.wave64_pairs:
            return
    if args.wave64_pairs:
        with tempfile.TemporaryDirectory() as tmp:
            wave64_pairs(dev, card, args.against, args.wave64_pairs, tmp)
        return
    if args.same_bytes:
        same_bytes(args.same_bytes, card)
        if not (args.training_only or args.sharded_only or args.f64_only
                or args.predict_only):
            return
    if args.traits_only:
        with tempfile.TemporaryDirectory() as tmp:
            traits_only(dev, tmp, card, args.traits_only)
        if not (args.training_only or args.sharded_only or args.f64_only
                or args.predict_only):
            return
    if (args.training_only or args.sharded_only or args.f64_only
            or args.predict_only):
        _build.library()
        if args.training_only:
            training_only(dev, args.training_only, card, args.repo)
        if args.sharded_only:
            sharded_only(dev, args.sharded_only, card, args.repo)
        if args.f64_only:
            f64_only(dev, args.f64_only, card, args.repo)
        if args.predict_only:
            gen = torch.Generator(device=dev)
            for rep in range(args.predict_only):
                gen.manual_seed(20261017)
                predict_times(dev, gen, card, args.repo, rep)
        return
    if args.predict_pairs:
        gen = torch.Generator(device=dev)
        gen.manual_seed(20261017)
        with tempfile.TemporaryDirectory() as tmp:
            predict_pairs(dev, gen, card, args.against, args.predict_pairs,
                          tmp)
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
            wide_sweep_gate(dev, gen, card)
        wide_sweep_branches(dev, gen, card)
        return

    # The three datasets are simulated by worker processes, one thread each,
    # while the kernels build and phase 2 runs.
    datasets = (("data", anchor_dataset), ("small", small_dataset),
                ("big", big_dataset), *TRAIT_DATASETS,
                ("equiv", equiv_dataset))
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ProcessPoolExecutor(
                len(datasets),
                mp_context=multiprocessing.get_context("spawn"),
                initializer=one_thread) as pool:
        sims = [pool.submit(make, os.path.join(tmp, name))
                for name, make in datasets]
        build_host_library()
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
        sim, small, big = (f.result() for f in sims[:3])
        print(f"# anchor, small and large-N datasets: waited "
              f"{time.perf_counter() - t0:.1f} s more for the worker "
              f"processes", flush=True)
        cache_bytes = sweep_gate(sim, dev, W, "sweep gate", card)
        sweep_gate(small, dev, None, "W=1 sweep gate", card)
        sweep_gate(big, dev, W, "large-N sweep gate", card,
                   against="composed")
        wide_sweep_gate(dev, gen, card)
        wide_sweep_branches(dev, gen, card)
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
        f64_rows["wave_scan_f64"], e_launches, f64w = float64_wave_phase(
            sim, small, dev, tmp, card, gen)
        for k, v in e_launches.items():
            f64_launches[k] = f64_launches.get(k, 0) + v
        trait_sims = [f.result() for f in sims[3:3 + len(TRAIT_DATASETS)]]
        trait_rows = traits_phase(dev, tmp, card, gen, trait_sims)
        io_phase(sim, big, dev, tmp, card)
        chains_phase({"anchor": sim, "small": small,
                      "anchor_na": trait_sims[1],
                      "equiv": sims[-1].result()}, dev, tmp, card)
        any_k = any_k_phase({"anchor": sim, "small": small}, dev, gen, tmp,
                            card)
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
             **({"chain_bound_ms": CHAIN_BOUND_MS[name]}
                if name in CHAIN_BOUND_MS else {}),
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
    print(f"# phase 7 (float64) wall {f64['seconds']:.1f} s", flush=True)
    print_wave64(f64w, e_launches, card)
    print(f"# float64 at the anchor in this call: W={W} "
          f"{f64w['steady'] * 1e3:.2f} ms/iteration against W=1 "
          f"{f64['steady'] * 1e3:.2f}; kernel E "
          f"{f64_rows['wave_scan_f64'][1]:.5f} ms a block against kernel C "
          f"{f64_rows['serial_scan_f64'][1]:.5f} and kernel 3 (float32) "
          f"{f64w['k3_ms']:.5f}; launches of phase 7 {f64_launches}  "
          f"[{card}]", flush=True)
    for name, (src, rep, route) in F64_SOURCES.items():
        err, k_ms, p_ms, lib, bound = f64_rows[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "float64_route": route,
                     "launches": f64_launches.get(name, 0),
                     "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": lib,
                     **({"chain_bound_ms": CHAIN_BOUND_MS[name]}
                        if name in CHAIN_BOUND_MS else {}),
                     **({"also_replaces": F64_ALSO_REPLACES[name]}
                        if name in F64_ALSO_REPLACES else {})})
    for (nT, wave), (steady, per_iter, peak) in trait_rows.items():
        print(f"# traits T={nT} W={wave}: {steady * 1e3:.2f} ms/iteration, "
              f"{sum(per_iter.values()):.0f} launches an iteration, peak "
              f"{peak / 2**20:.1f} MiB  [{card}]", flush=True)
    # Phase 11: the scans' ms a block at K = 4, 17, 33 (the anchor) and 65
    # (the small panel), beside their plain versions and bounds.
    for row in rows:
        if row["name"] in any_k["scans"]:
            row["any_k"] = [{k: r[k] for k in ("K", "ms", "plain_ms",
                                                "bound_ms", "bound_by")}
                            for r in any_k["scans"][row["name"]]]
    print(f"# the whole run: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
