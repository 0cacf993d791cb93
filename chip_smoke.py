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
   and per eager call;
3. the wave path's (W=32) one-sweep agreement gate: marker_sweep with the
   kernels on the card against the same sweep from the plain versions (on
   the host CPU), with the same injected processing order and draws;
3b. the exact serial path's (W=1) one-sweep gate on a small panel
   (N=10,000 x Mt=4,096 x 4 traits with phenotype NAs: 32 blocks, so the
   auto plan resolves to W=1, as it does for users' small panels);
4. the training entry point, gmrm_tpu_torch.runner.run_training, on the
   reference anchor (N=10,000 x Mt=20,000 x 4 traits, bench.py:50-57) in
   wave mode for 20 iterations with thinned output, checking the kernel
   launch counts of the wave path, the chain and the written artifacts;
4b. the same at W=1 (--wave-size 1) for 10 iterations, checking the
   launch counts of the exact serial path.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without CUDA, or without the
rest of the repository beside it, the script fails before printing any
result.
"""

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
WAVE_KERNELS = ("gram_cache", "block_cdot", "wave_scan", "eps_update")
SERIAL_KERNELS = ("block_gram", "serial_scan", "eps_update")


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
    out, times = {}, {}

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
    return {name: (err, *times[name]) for name, err in out.items()}


def anchor_dataset(tmp):
    """The reference anchor of bench.py:50-57 (N=10k, Mt=20k, 4 traits)."""
    import numpy as np
    from gmrm_tpu.io.sim import simulate
    return simulate(tmp, n=N, m=MT, n_traits=T, n_causal=MT // 4, h2=0.5,
                    n_groups=1, na_rate=0.0, seed=171014,
                    mixtures=np.array([0.0, 0.0001, 0.001, 0.01]))


def small_dataset(tmp):
    """The W=1 gate's panel: the anchor's N and traits, 4,096 markers, 2%
    phenotype NAs (so NT=4)."""
    import numpy as np
    from gmrm_tpu.io.sim import simulate
    return simulate(tmp, n=N, m=MT_SMALL, n_traits=T, n_causal=MT_SMALL // 4,
                    h2=0.5, n_groups=1, na_rate=0.02, seed=171015,
                    mixtures=np.array([0.0, 0.0001, 0.001, 0.01]))


def anchor_options(sim, out_dir, wave=W, iterations=ITERS):
    """``wave`` None lets the plan pick the wave, as a user's run does."""
    from gmrm_tpu.config import Options
    opt = Options(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                  group_index_file=sim.gri, group_mixture_file=sim.grm,
                  iterations=iterations, seed=42, out_dir=out_dir,
                  block_size=B, wave_size=wave, output_thin_rate=THIN)
    opt.validate()
    opt.load_group_mixtures()
    return opt


def sweep_gate(sim, dev, wave, name):
    """Phases 3 and 3b: one sweep with the kernels vs the plain versions.
    ``wave`` None is the auto plan, which must resolve to W=1."""
    import numpy as np
    import torch
    from gmrm_tpu_torch import runner
    from gmrm_tpu_torch.config import resolve_plan
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
    res = {}
    for key, d, st, sta in (("kernels", dev, state, static),
                            ("plain", torch.device("cpu"),
                             to_device(state, "cpu"),
                             to_device(static, "cpu"))):
        out = marker_sweep(
            st.eps.clone(), st.betas, st.comp, st.acum, st.sigmag,
            sigmae.to(d), st.pi_est, sta, *[x.to(d) for x in inj],
            wave=opt.wave_size)
        res[key] = [x.cpu() for x in out]
    (ke, kb, kc, _, kcass), (pe, pb, pc, _, pcass) = (res["kernels"],
                                                      res["plain"])
    n_diff = int((kc != pc).sum())
    db = float((kb - pb).abs().max())
    de = float((ke - pe).abs().max())
    print(f"# {name} (W={opt.wave_size}, NT="
          f"{1 if static.shared_na else T}, {nblocks} blocks): comp "
          f"mismatches {n_diff} of {kc.numel()}, cass equal "
          f"{torch.equal(kcass, pcass)}, max|dbeta| {db:.3e}, max|deps| "
          f"{de:.3e}", flush=True)
    if n_diff or not torch.equal(kcass, pcass) or db > 1e-4 or de > 1e-4:
        fail(f"{name}: the kernels disagree with the plain sweep")
    return 0 if static.gram_cache is None else static.gram_cache.numel() * 4


def training_phase(sim, dev, tmp, wave, iterations):
    """Phases 4 and 4b: run_training through the entry point.  The path's
    kernels each launch once per block and iteration (the Gram cache once
    per run), and the other path's kernels not at all."""
    import numpy as np
    from gmrm_tpu.io.writers import read_history
    from gmrm_tpu_torch.ops import _build
    from gmrm_tpu_torch.runner import check_finite_chain, run_training

    out_dir = os.path.join(tmp, f"out_w{wave}")
    opt = anchor_options(sim, out_dir, wave, iterations)
    _build.reset_launch_counts()
    res = run_training(opt, device=dev, verbose=False)
    launches = _build.launch_counts()
    nblocks = -(-MT // B)
    path = WAVE_KERNELS if wave > 1 else SERIAL_KERNELS
    for name, n in launches.items():
        want = (0 if name not in path else 1 if name == "gram_cache"
                else nblocks * iterations)
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


def main():
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, REPO)
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
    for name, (err, t_k, t_p, t_call) in kernels.items():
        print(f"# {name}: max abs err {err:.3e}; kernel ms {t_k}, plain ms "
              f"{t_p} (CUDA graph replay); kernel ms per eager call "
              f"{t_call}  [{card}]", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sim = anchor_dataset(os.path.join(tmp, "data"))
        small = small_dataset(os.path.join(tmp, "small"))
        print(f"# anchor and small datasets simulated in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        cache_bytes = sweep_gate(sim, dev, W, "sweep gate")
        sweep_gate(small, dev, None, "W=1 sweep gate")
        runs = {w: training_phase(sim, dev, tmp, w, iters)
                for w, iters in ((W, ITERS), (1, ITERS_SERIAL))}
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

    sources = {
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
    }
    # Launches: the training runs of the kernel's path (eps_update is on
    # both paths).
    rows = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": sum(r[1][name] for r in runs.values()),
             "max_abs_err": kernels[name][0],
             "ms": kernels[name][1][0], "plain_ms": kernels[name][2][0]}
            for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
