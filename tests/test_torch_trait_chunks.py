"""Trait chunks: any number of traits on every CUDA path of the port.

A kernel whose launch holds fewer traits than the run has is launched on
them in chunks (``gmrm_tpu_torch/ops/trait_chunks.py``); the scans take
any T in one launch, a grid of trait groups where one CTA cannot hold
them (``scan_kernel.launch_plan``, ``scan_kernel_wave.launch_plan``).
Here, on the CPU:

- the chunk plan and every launch planner of the port accept the shapes a
  user runs (up to 48 traits at B = 128, 32 at B = 256, 16 at B = 512) at
  the anchor's mb, and give the one chunk ``(0, T)`` (one CTA of all T
  traits, for the scans) wherever the planners before chunking took T;
- each kernel's plain version run chunk by chunk (trait group by trait
  group) on the slices the plan gives equals it run on all traits
  (``comp`` and ``cass`` exactly; beta, acum and eps within
  tests/test_sweep_equivalence.py:119-132), at NT = 1 and NT = T;
- the CUDA wrappers launch once a chunk at the chunk's offsets, and the
  scans once with their trait groups (the launch recorded instead of
  made, on meta tensors);
- a W > 1 sweep of 12 traits against the JAX package's whole-sweep Pallas
  kernel (interpret mode; its XLA sweep is the exact serial one, W = 1
  only) and a W = 1 sweep against its XLA sweep.

The kernels themselves are held to these plain versions on the card by
``chip_smoke.py --traits-only 1``.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gmrm_tpu.ops.pallas_kernels as jpk
import gmrm_tpu.ops.scan_kernel_wave as jskw
import gmrm_tpu.ops.sweep_kernel as jswk
from gmrm_tpu.config import Options as JaxOptions
from gmrm_tpu.io.sim import simulate
from gmrm_tpu.runner import build_static, init_sampler_state, load_data
from gmrm_tpu.sampler import gibbs as jgibbs
from gmrm_tpu_torch.ops import block_kernels as bk
from gmrm_tpu_torch.ops import scan_kernel as sk
from gmrm_tpu_torch.ops import scan_kernel_wave as sw
from gmrm_tpu_torch.ops import sweep_kernel as swk
from gmrm_tpu_torch.ops.block_kernels import (
    block_cdot_plain, block_eps_update_plain_, block_update_cdot_plain_,
)
from gmrm_tpu_torch.ops.trait_chunks import LAUNCH_MAX_T, trait_chunks
from gmrm_tpu_torch.sampler.gibbs import marker_sweep
from gmrm_tpu_torch.sampler.state import state_from_numpy, static_from_numpy

torch.set_num_threads(2)

MB = 2560     # the anchor's bed bytes a row (N = 10,000, mb_pad 2,560)
K = 4
SHAPES = ([(T, 128) for T in (9, 16, 32, 33, 48)]
          + [(16, 256), (32, 256), (16, 512)])
PATHS = ("W=32", "W=1", "float64 W=1")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _groups(TG, T):
    """The trait groups of a scan's grid at TG traits a CTA."""
    return tuple((t0, min(T, t0 + TG)) for t0 in range(0, T, TG))


def _scan_plan(kernel, T, B, es=4):
    """The plan of a scan's launch at T traits; TG, the traits a CTA, last."""
    if kernel == "wave_scan":
        return sw.launch_plan(T, B, K, 32)
    return (sk._plan_f64_or_raise if es == 8 else sk._plan_f32_or_raise)(
        T, B, K)


def _covers(chunks, T):
    """Contiguous chunks of [0, T), all of one width but the last."""
    assert chunks[0][0] == 0 and chunks[-1][1] == T
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    widths = [t1 - t0 for t0, t1 in chunks]
    assert all(w == widths[0] for w in widths[:-1])
    assert 0 < widths[-1] <= widths[0]
    return widths[0]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("T,B", SHAPES, ids=[f"T{t}-B{b}" for t, b in SHAPES])
def test_every_planner_takes_the_shape(T, B, path):
    """Every kernel a path launches takes the shape: chunks of [0, T) for
    the launches with a trait limit, each chunk's width accepted by its
    launch planner (W = 32 the whole-sweep kernel (7/8), kernel 9 and the
    passes; W = 1 the passes; float64 W = 1 the passes at 8-byte values,
    B), and a plan of trait groups of [0, T) for the scans (W = 32 the
    wave scan, 3; W = 1 the serial scan, 6; float64 W = 1 C), the plan of
    a CTA of TG traits."""
    es = 8 if path.startswith("float64") else 4
    kernels = (("sweep_blocks", "block_sweep", "passes")
               if path == "W=32" else ("passes",))
    for kernel in kernels:
        width = _covers(trait_chunks(kernel, T, B, MB, es), T)
        if kernel == "passes":
            assert bk.pass_plan(width, B, MB, es) is not None
        else:
            assert width <= LAUNCH_MAX_T
    scan = "wave_scan" if path == "W=32" else "serial_scan"
    plan = _scan_plan(scan, T, B, es)
    TG = _covers(_groups(plan[-1], T), T)
    if scan == "wave_scan":
        assert plan == (*sw.wave_plan(TG, B, K, 32), TG)
    else:
        assert plan == (*sk.scan_plan(TG, B, K, es), TG)


@pytest.mark.parametrize("B", [16, 32, 64, 128, 256, 512])
def test_one_chunk_wherever_the_parent_planned(B):
    """Where the planners before chunking took T traits, the plan is the
    one chunk (0, T): the passes and kernels 7/8 and 9 up to 8 traits; one
    CTA of all T traits for the float32 serial scan up to 32 where
    scan_plan fits them and for the wave scan where wave_plan does; the
    float64 scan keeps its grid of f64_plan's trait groups."""
    for T in range(1, 9):
        for kernel in ("sweep_blocks", "block_sweep"):
            assert trait_chunks(kernel, T, B) == ((0, T),)
        for es in (4, 8):
            if bk.pass_plan(T, B, MB, es) is not None:
                assert trait_chunks("passes", T, B, mb=MB, es=es) == ((0, T),)
    for T in range(1, 33):
        if sk.scan_plan(T, B, K) is not None:
            assert sk._plan_f32_or_raise(T, B, K) == (
                *sk.scan_plan(T, B, K), T)
        if B % 16 == 0 and sw.wave_plan(T, B, K, 16) is not None:
            assert sw.launch_plan(T, B, K, 16) == (
                *sw.wave_plan(T, B, K, 16), T)
        assert sk._plan_f64_or_raise(T, B, K) == sk.f64_plan(T, B, K)


def test_pass_plan_splits_only_what_does_not_fit():
    """One launch of the passes carries 33 traits at B = 128 (S = 16,
    about 192 KB of shared memory); 48 do not fit, and take two launches
    of 24; a single trait too wide for shared memory is refused."""
    assert trait_chunks("passes", 33, 128, mb=MB) == ((0, 33),)
    assert bk.pass_plan(33, 128, MB).S == 16
    assert bk.pass_plan(48, 128, MB) is None
    assert trait_chunks("passes", 48, 128, mb=MB) == ((0, 24), (24, 48))
    with pytest.raises(ValueError, match="one\\s+trait|exceed"):
        trait_chunks("passes", 8, 4096, mb=MB)


# ---- the plain versions, chunk by chunk -----------------------------------

def _sweep_case(rng, T, B, nblocks, mb, nt, G=2):
    """The operands of one wave-mode sweep (sweep_blocks' order), the
    Gram cache of the bed's natural blocks with NT = nt masks."""
    m_pad = nblocks * B
    m_local = m_pad - 3
    bed = rng.integers(0, 256, size=(m_pad, mb), dtype=np.uint8)
    na = np.ones((nt, 4, mb), np.float32)
    if nt > 1:
        na *= rng.uniform(size=(nt, 4, mb)) > 0.03
    na_t = np.broadcast_to(na, (T, 4, mb)) if nt == 1 else na
    eps = (rng.normal(size=(T, 4, mb)) * na_t).astype(np.float32)
    sigmag = rng.uniform(0.05, 0.5, size=(T, G)).astype(np.float32)
    sigmag[1, 0] = 0.0                                   # an adaV group
    sigmae = rng.uniform(0.3, 0.9, size=T).astype(np.float32)
    pi = rng.dirichlet(np.ones(K), size=(T, G)).astype(np.float32)
    cva = np.sort(rng.uniform(1e-4, 1e-2, size=(G, K)), axis=1)
    cva[:, 0] = 0.0
    cvai = np.zeros_like(cva)
    cvai[:, 1:] = 1.0 / cva[:, 1:]
    nonas = np.full(T, 4.0 * mb - 5.0, np.float32)
    tables = swk.build_sweep_tables(
        _t(sigmag), _t(sigmae), _t(pi), _t(cva.astype(np.float32)),
        _t(cvai.astype(np.float32)), _t(nonas), 4.0 * mb)
    bed_t, na_in = _t(bed), _t(na)
    return dict(
        bed=bed_t, blkidx=_t(rng.permutation(nblocks).astype(np.int32)),
        win_p=_t(np.argsort(rng.uniform(size=(nblocks, B)),
                            axis=1).astype(np.int32)),
        m_local=m_local, gram_cache=swk.gram_cache_plain(bed_t, na_in, B),
        eps=_t(eps), na=na_in,
        mave=_t(rng.uniform(0.2, 1.8, size=(T, m_pad)).astype(np.float32)),
        msig=_t(rng.uniform(0.5, 2.0, size=(T, m_pad)).astype(np.float32)),
        beta_old=_t((rng.normal(size=(T, m_pad)) * 0.02).astype(np.float32)),
        comp_old=_t(rng.integers(0, K, size=(T, m_pad)).astype(np.int32)),
        acum_old=_t(rng.uniform(size=(T, m_pad)).astype(np.float32)),
        grp=_t(rng.integers(0, G, size=m_pad).astype(np.int32)),
        u_p=_t(rng.uniform(size=(nblocks, T, B)).astype(np.float32)),
        z_p=_t(rng.normal(size=(nblocks, T, B)).astype(np.float32)),
        sigmag=_t(sigmag), lc=tables[0], rd=tables[1], sqb=tables[2],
        i2se=_t((1.0 / (2.0 * sigmae)).astype(np.float32)), nonas=_t(nonas))


# The axis along the traits of each operand of _sweep_case (None: shared).
_SWEEP_AXES = dict(bed=None, blkidx=None, win_p=None, m_local=None,
                   gram_cache=1, eps=0, na=0, mave=0, msig=0, beta_old=0,
                   comp_old=0, acum_old=0, grp=None, u_p=1, z_p=1, sigmag=0,
                   lc=1, rd=1, sqb=1, i2se=0, nonas=0)


def _chunk_of(ops, axes, t0, t1, nt):
    """The operands of traits t0 .. t1 - 1: each sliced along its trait
    axis; the Gram cache and na only when they hold a mask a trait."""
    out = {}
    for name, x in ops.items():
        ax = axes[name]
        if ax is None or (name in ("gram_cache", "na") and nt == 1):
            out[name] = x
        else:
            out[name] = x.narrow(ax, t0, t1 - t0).contiguous()
    return out


def _agree(got, want, comp_idx, name):
    """comp (and cass) exact; beta, acum and eps to the tolerances of
    tests/test_sweep_equivalence.py:119-132."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), w.numpy()
        if i in comp_idx:
            np.testing.assert_array_equal(g, w, f"{name}[{i}]")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name}[{i}]")


@pytest.mark.parametrize("nt", ["1", "T"])
def test_sweep_blocks_plain_by_chunks(nt):
    """Kernels 7/8's plain version on each of the chunks of 12 traits (two
    of 6) against all 12 at once."""
    rng = np.random.default_rng(71)
    T, B = 12, 16
    ops = _sweep_case(rng, T, B, 4, 40, 1 if nt == "1" else T)
    n = ops["na"].shape[0]
    chunks = trait_chunks("sweep_blocks", T, B)
    assert chunks == ((0, 6), (6, 12))
    args = list(_SWEEP_AXES)

    def run(o):
        o = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in o.items()}
        return swk.sweep_blocks_plain(*[o[k] for k in args], wave=8)

    whole = run(ops)
    parts = [run(_chunk_of(ops, _SWEEP_AXES, t0, t1, n))
             for t0, t1 in chunks]
    got = [torch.cat([p[i] for p in parts]) for i in range(4)]
    _agree(got, whole, (2,), f"sweep_blocks NT={nt}")


@pytest.mark.parametrize("nt", ["1", "T"])
def test_block_sweep_plain_by_chunks(nt):
    """Kernel 9's plain version (one shard's block step, its delta out) on
    each chunk of 12 traits against all 12 at once."""
    rng = np.random.default_rng(72)
    T, B = 12, 16
    ops = _sweep_case(rng, T, B, 3, 40, 1 if nt == "1" else T)
    n = ops["na"].shape[0]
    chunks = trait_chunks("block_sweep", T, B)
    names = ("bed", "win_p", "gram_cache", "eps", "na", "mave", "msig",
             "beta_old", "comp_old", "acum_old", "grp", "u_p", "z_p",
             "sigmag", "lc", "rd", "sqb", "i2se", "nonas")

    def run(o):
        o = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in o.items()}
        b = 1
        return swk.block_sweep_plain(
            o["blkidx"][b], o["m_local"], o["bed"], o["win_p"][b],
            o["gram_cache"], o["eps"], o["na"], o["mave"], o["msig"],
            o["beta_old"], o["comp_old"], o["acum_old"], o["grp"],
            o["u_p"][b], o["z_p"][b], o["sigmag"], o["lc"], o["rd"],
            o["sqb"], o["i2se"], o["nonas"], wave=8)

    assert set(names) <= set(_SWEEP_AXES)
    whole = run(ops)
    parts = [run(_chunk_of(ops, _SWEEP_AXES, t0, t1, n))
             for t0, t1 in chunks]
    got = [torch.cat([p[i] for p in parts]) for i in range(4)]
    _agree(got, whole, (2,), f"block_sweep NT={nt}")


def _scan_case(rng, T, B, G=2):
    """One block's operands of kernels 3 and 6 (per-marker tables
    gathered from group tables)."""
    ops = _sweep_case(rng, T, B, 1, 8, 1, G)
    grp = ops["grp"].long()
    live, zerob = sw.scan_masks(grp, torch.arange(B) < B - 2, ops["sigmag"])
    gs = _t((rng.normal(size=(T, B, B)) * 0.02).astype(np.float32))
    base = _t((rng.normal(size=(T, B)) * 5.0).astype(np.float32))
    return (base, ops["lc"][:, :, grp], ops["rd"][:, :, grp],
            ops["sqb"][:, :, grp], gs, ops["beta_old"], ops["comp_old"],
            ops["acum_old"], ops["u_p"][0], ops["z_p"][0], live, zerob,
            ops["i2se"])


# The trait axis of each operand of the scans (lc, rd, sqb are (K, T, B)).
_SCAN_AXES = (0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("kernel,T,B", [("serial_scan", 40, 32),
                                        ("wave_scan", 48, 128)])
def test_scans_plain_by_trait_groups(kernel, T, B):
    """Kernels 6 and 3 where one CTA cannot hold the traits: the plain
    version on each trait group of the plan against all traits at once."""
    rng = np.random.default_rng(73)
    ops = _scan_case(rng, T, B)
    chunks = _groups(_scan_plan(kernel, T, B)[-1], T)
    assert len(chunks) > 1

    def run(o):
        if kernel == "serial_scan":
            return sk.serial_scan_plain(*o)
        return sw.wave_scan_plain(*o, 32)

    whole = run(ops)
    parts = [run([x.narrow(ax, t0, t1 - t0) for x, ax in
                  zip(ops, _SCAN_AXES)]) for t0, t1 in chunks]
    got = [torch.cat([p[i] for p in parts]) for i in range(4)]
    _agree(got, whole, (2,), kernel)


@pytest.mark.parametrize("nt", ["1", "T"])
def test_passes_plain_by_chunks(nt):
    """The c-dot, the update and the fused pass (kernels 2, 4 and their
    fusion) on each of the passes' chunks of 48 traits at B = 128 against
    all 48 at once."""
    rng = np.random.default_rng(74 + (nt == "T"))
    T, B, mb = 48, 128, 48
    chunks = trait_chunks("passes", T, B, mb=MB)
    assert chunks == ((0, 24), (24, 48))
    bed = _t(rng.integers(0, 256, size=(3 * B, mb), dtype=np.uint8))
    rows = _t(np.stack([B + rng.permutation(B),
                        2 * B + rng.permutation(B)]).astype(np.int32))
    na = np.ones((T, 4, mb), np.float32)
    na *= rng.uniform(size=(1 if nt == "1" else T, 4, mb)) > 0.03
    na = _t(na)
    eps = _t(rng.normal(size=(T, 4, mb)).astype(np.float32)) * na
    mave, msig, d = (_t(rng.uniform(lo, hi, size=(2, T, B)).astype(
        np.float32)) for lo, hi in ((0.2, 1.8), (0.5, 2.0), (-0.05, 0.05)))

    def run(t0, t1):
        s = slice(t0, t1)
        e = eps[s].clone()
        c = block_cdot_plain(bed, rows[0], e, mave[0, s], msig[0, s])
        upd = block_eps_update_plain_(bed, rows[0], d[0, s], mave[0, s],
                                      na[s], e.clone())
        c2 = block_update_cdot_plain_(bed, rows[0], d[0, s], mave[0, s],
                                      na[s], e, rows[1], mave[1, s],
                                      msig[1, s])
        return c, upd, e, c2

    whole = run(0, T)
    parts = [run(t0, t1) for t0, t1 in chunks]
    got = [torch.cat([p[i] for p in parts]) for i in range(4)]
    _agree(got, whole, (), f"passes NT={nt}")


# ---- the wrappers launch once a chunk -------------------------------------

def _record(monkeypatch, module):
    calls = []
    monkeypatch.setattr(module._build, "launch",
                        lambda kernel, *args: calls.append((kernel, args)))
    return calls


def test_block_passes_launch_each_chunk(monkeypatch):
    """BlockPasses at 48 traits, B = 128: one launch a chunk, at the
    chunk's width and plan, on the chunk's rows of every operand; a stamp
    buffer is refused (it records one launch)."""
    T, B, nb, mb = 48, 128, 3, MB
    meta = torch.device("meta")
    bed = torch.empty((nb * B, mb), dtype=torch.uint8, device=meta)
    rows = torch.empty((nb, B), dtype=torch.int32, device=meta)
    mave, msig, d = (torch.empty((nb, T, B), device=meta) for _ in range(3))
    na, eps = (torch.empty((T, 4, mb), device=meta) for _ in range(2))
    passes = bk.BlockPasses(bed, rows, mave, msig, na)
    chunks = trait_chunks("passes", T, B, mb=mb)
    assert passes.chunks == chunks and len(chunks) == 2
    plans = {t1 - t0: bk.pass_plan(t1 - t0, B, mb) for t0, t1 in chunks}
    assert passes.scratch.numel() == max(p.scratch_words
                                         for p in plans.values())
    calls = _record(monkeypatch, bk)
    b = 1
    passes.cdot(b, eps)
    passes.update_(b, d, eps)
    passes.update_cdot_(b, d, eps)
    assert [k for k, _ in calls] == (["block_cdot"] * 2 + ["eps_update"] * 2
                                     + ["update_cdot"] * 2)
    ptr = torch.Tensor.data_ptr
    for i, (t0, t1) in enumerate(chunks):
        w, S = t1 - t0, plans[t1 - t0].S
        _, cd = calls[i]
        _, up = calls[2 + i]
        _, fu = calls[4 + i]
        assert cd[2] == ptr(eps[t0]) and cd[3] == ptr(mave[b, t0])
        assert cd[4] == ptr(msig[b, t0]) and cd[5] == ptr(passes.c[b, t0])
        assert cd[7:11] == (w, B, mb, S)
        assert up[2] == ptr(d[b, t0]) and up[4] == ptr(na[t0])
        assert up[5] == ptr(eps[t0]) and up[6:10] == (w, B, mb, S)
        assert fu[3] == ptr(d[b, t0]) and fu[5] == ptr(mave[b + 1, t0])
        assert fu[8] == ptr(eps[t0]) and fu[9] == ptr(passes.c[b + 1, t0])
        assert fu[11:15] == (w, B, mb, S)
    with pytest.raises(ValueError, match="one launch"):
        passes.cdot(b, eps, stamps=torch.empty(1))


@pytest.mark.parametrize("nt", [1, 12])
def test_sweep_wrappers_launch_each_chunk(monkeypatch, nt):
    """SweepBlocks (kernels 7/8) and ShardedBlockSweep (kernel 9) at 12
    traits: one launch a chunk of 6, each with the chunk's first trait and
    the run's 12, on the run's whole operands; planned at the chunk's
    width and masks."""
    T, B, nblocks, mb, G = 12, 16, 3, 64, 2
    m_pad = nblocks * B
    meta = torch.device("meta")
    f32, i32 = torch.float32, torch.int32

    def e(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=meta)

    planned = []

    def fake_plan(*key):
        planned.append(key)
        return {"grid": 9, "scratch_bytes": 64 * key[0], "cap": 4,
                "slot_words": 10 * key[0]}

    monkeypatch.setattr(swk, "sweep_plan", fake_plan)
    monkeypatch.setattr(swk, "block_sweep_plan", fake_plan)
    calls = _record(monkeypatch, swk)
    chunks = trait_chunks("sweep_blocks", T, B)
    assert chunks == ((0, 6), (6, 12))
    tb = (T, m_pad)
    swk.SweepBlocks()(
        e(m_pad, mb, dtype=torch.uint8), e(nblocks, dtype=i32),
        e(nblocks, B, dtype=i32), m_pad - 1, e(nblocks, nt, 2 * B, 2 * B),
        e(T, 4, mb), e(nt, 4, mb), e(*tb), e(*tb), e(*tb),
        e(*tb, dtype=i32), e(*tb), e(m_pad, dtype=i32), e(nblocks, T, B),
        e(nblocks, T, B), e(T, G), e(K, T, G), e(K, T, G), e(K, T, G),
        e(T), e(T), wave=8)
    assert planned == [(6, B, mb, 1 if nt == 1 else 6, K, 8)]
    assert [k for k, _ in calls] == ["sweep_blocks"] * 2
    for (_, args), (t0, t1) in zip(calls, chunks):
        assert args[26:31] == (t1 - t0, B, mb, nt, K)
        assert args[-2:] == (t0, T)

    planned.clear()
    calls.clear()
    shard = swk.ShardOperands(
        e(nblocks, dtype=i32), e(nblocks, B, dtype=i32), m_pad - 1,
        e(m_pad, mb, dtype=torch.uint8), e(nblocks, nt, 2 * B, 2 * B),
        e(*tb), e(*tb), e(*tb), e(*tb, dtype=i32), e(*tb),
        e(m_pad, dtype=i32), e(nblocks, T, B), e(nblocks, T, B))
    sweep = swk.ShardedBlockSweep().sweep(
        [shard, shard], e(T, 4, mb), e(nt, 4, mb), e(T, G), e(K, T, G),
        e(K, T, G), e(K, T, G), e(T), e(T), wave=8)
    assert planned == [(6, B, mb, 1 if nt == 1 else 6, K, 8, 2)]
    assert sweep.scratch.numel() == 4 * 60
    sweep.step(1)
    assert [k for k, _ in calls] == ["block_sweep"] * 2
    for (_, args), (t0, t1) in zip(calls, chunks):
        assert args[1:4] == (0, 2, 1)
        assert args[16:20] == (t1 - t0, B, mb, nt)
        assert args[-2:] == (t0, T)
    with pytest.raises(ValueError, match="one launch"):
        sweep.step(1, stamps=e(9, swk.BS_NST, dtype=torch.int64))


@pytest.mark.parametrize("kernel,T,B", [("serial_scan", 40, 32),
                                        ("wave_scan", 48, 128)])
def test_scan_sweeps_launch_a_grid_of_trait_groups(monkeypatch, kernel, T,
                                                   B):
    """SerialScanSweep and WaveScanSweep where one CTA cannot hold the
    traits: one launch a block, its plan at the group's width and TG, the
    traits a CTA, last."""
    nb = 2
    meta = torch.device("meta")
    i32 = torch.int32

    def e(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=meta)

    ops = (e(T), e(nb, K, T, B), e(nb, K, T, B), e(nb, K, T, B),
           e(nb, T, B), e(nb, T, B, dtype=i32), e(nb, T, B), e(nb, T, B),
           e(nb, T, B), e(nb, T, B, dtype=i32), e(nb, T, B, dtype=i32),
           e(nb, T, B), e(T))
    width = _scan_plan(kernel, T, B)[-1]
    if kernel == "serial_scan":
        scan = sk.SerialScanSweep(*ops)
        assert scan.plan == (*sk.scan_plan(width, B, K), width)
    else:
        scan = sw.WaveScanSweep(*ops, wave=32)
        assert scan.plan == (*sw.wave_plan(width, B, K, 32), width)
    assert width < T
    calls = _record(monkeypatch, sk)
    scan.step(1, e(nb, T, B), e(1, T, B, B), 0, bc=1)
    assert [k for k, _ in calls] == [kernel]
    args = calls[0][1]
    n = len(scan.plan)
    assert args[-n:] == scan.plan and args[-1] == width
    shapes = (1, 1, 0, T, B, K) + ((32,) if kernel == "wave_scan" else ())
    assert args[-n - len(shapes):-n] == shapes


# ---- sweeps of 12 traits against the JAX package --------------------------

def _jax_setup(tmp, na_rate, wave):
    sim = simulate(tmp, n=400, m=96, n_traits=12, n_causal=24, h2=0.5,
                   n_groups=2, na_rate=na_rate, seed=12)
    opt = JaxOptions(bed_file=sim.bed, dim_file=sim.dim,
                     phen_files=sim.phens, group_index_file=sim.gri,
                     group_mixture_file=sim.grm, iterations=1, seed=3,
                     block_size=64 if wave > 1 else 32, wave_size=wave,
                     use_pallas=True,
                     output_thin_rate=10 ** 9)
    opt.validate()
    opt.load_group_mixtures()
    data = load_data(opt)
    return (opt, data, build_static(data, opt, jnp.float32),
            init_sampler_state(data, opt, jnp.float32))


def _leaves(x):
    return {k: (None if v is None else np.asarray(v))
            for k, v in vars(x).items() if k != "key"}


@pytest.mark.parametrize("wave,na_rate", [(32, 0.0), (1, 0.02)],
                         ids=["W32-NT1", "W1-NTT"])
def test_twelve_traits_against_the_jax_sweep(tmp_path, monkeypatch, wave,
                                             na_rate):
    """One sweep of 12 traits, with injected block order, row order and
    draws, through the port's marker_sweep (W > 1: the whole-sweep path;
    W = 1: the exact serial path) against the JAX package's sweep of the
    same W (W > 1: its whole-sweep Pallas kernel in interpret mode; W = 1:
    its XLA sweep): comp and cass exact, beta, eps and acum within
    tests/test_sweep_equivalence.py:119-132."""
    for mod in (jpk, jskw, jswk):
        monkeypatch.setattr(mod, "FORCE_INTERPRET", True)
    opt, data, static, state = _jax_setup(str(tmp_path), na_rate, wave)
    B = opt.block_size
    T, m_pad = state.betas.shape
    assert T == 12
    nblocks = m_pad // B
    rng = np.random.default_rng(1212)
    if wave > 1:
        pi_b = rng.permutation(nblocks).astype(np.int32)
        win = np.argsort(rng.uniform(size=(nblocks, B)),
                         axis=1).astype(np.int32)
        blocks = pi_b[:, None] * B + win
        kw = dict(use_pallas=True, pallas_upd=True, megakernel=True,
                  block_perm=(jnp.asarray(pi_b), jnp.asarray(win)))
    else:
        blocks = np.concatenate([rng.permutation(data.m_local),
                                 np.arange(data.m_local, m_pad)])
        kw = dict(use_pallas=False)
    blocks = blocks.reshape(nblocks, B).astype(np.int32)
    u = rng.uniform(size=(nblocks, T, B)).astype(np.float32)
    z = rng.normal(size=(nblocks, T, B)).astype(np.float32)
    eps = np.asarray(state.eps)
    sigmae = (0.5 * (eps.astype(np.float64) ** 2).sum(axis=(1, 2))
              / np.asarray(static.nonas)).astype(np.float32)
    betas = (rng.normal(size=(T, m_pad)) * 0.02).astype(np.float32)
    sigmag = np.asarray(state.sigmag).copy()
    sigmag[5, 0] = 0.0                                   # an adaV group
    shared_na = all(ph.nas == 0 for ph in data.phens)
    want = jax.device_get(jgibbs.marker_sweep(
        jnp.asarray(eps), jnp.asarray(betas), state.comp, state.acum,
        jnp.asarray(sigmag), jnp.asarray(sigmae), state.pi_est, static,
        jnp.asarray(blocks), jnp.asarray(u), jnp.asarray(z),
        shared_na=shared_na, wave_size=wave, **kw))

    dev = torch.device("cpu")
    ts = dataclasses.replace(static_from_numpy(_leaves(static), dev),
                             shared_na=shared_na)
    st = state_from_numpy(_leaves(state), dev)
    if wave > 1:
        assert ts.gram_cache is not None
    got = marker_sweep(
        torch.from_numpy(eps.copy()), torch.from_numpy(betas), st.comp,
        st.acum, torch.from_numpy(sigmag), torch.from_numpy(sigmae),
        st.pi_est, ts, torch.from_numpy(blocks), torch.from_numpy(u),
        torch.from_numpy(z), wave=wave)
    g_eps, g_beta, g_comp, g_acum, g_cass = (x.numpy() for x in got)
    w_eps, w_beta, w_comp, w_acum, w_cass = (np.asarray(x) for x in want)
    assert (g_comp[:, :data.m_local] != 0).any()
    np.testing.assert_array_equal(g_comp, w_comp)
    np.testing.assert_array_equal(g_cass, w_cass)
    np.testing.assert_allclose(g_beta, w_beta, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g_eps, w_eps, rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(g_acum, w_acum, rtol=1e-3, atol=1e-5)
