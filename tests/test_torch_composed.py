"""The composed W>1 sweep of the port on the CPU, and the two kernels it
and the startup reach that the other files do not cover.

- Kernel 1 (the Gram cache): its plain version against the JAX builder
  in interpret mode at the shapes that reach the CUDA kernel's partial
  128-tiles (B=192) and byte path (an mb that is no multiple of 16), at
  NT=1 and NT=T; its launch grid and refusals.
- Kernel 3 (the wave scan): the sweep interface ``WaveScanSweep`` against
  the one-block plain version and against ``make_block_scan_wave`` of the
  JAX package; its shared-memory plan and refusals.
- The composed sweep (``marker_sweep(megakernel=False)`` at W>1): the
  scaled Grams of a run of blocks against the per-block gather, the
  c-dot / scan / fused update-and-c-dot cadence, bit-equal to the
  per-block cadence the port ran before, and held against the JAX
  package's composed sweep.

The CUDA kernels themselves are checked against these plain versions on
the card by chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gmrm_tpu.ops.pallas_kernels as pk
import gmrm_tpu.ops.scan_kernel_wave as skw
import gmrm_tpu.ops.sweep_kernel as swk
from gmrm_tpu.sampler import gibbs as jgibbs
from gmrm_tpu_torch import runner
from gmrm_tpu_torch.config import Options
from gmrm_tpu_torch.ops import block_kernels as bk
from gmrm_tpu_torch.ops import scan_kernel_wave as tsw
from gmrm_tpu_torch.ops.block_gram import scale_gram
from gmrm_tpu_torch.ops.block_kernels import block_cdot, block_eps_update_
from gmrm_tpu_torch.ops.scan_kernel_wave import (
    WaveScanSweep, scan_masks, wave_plan, wave_scan, wave_scan_plain,
)
from gmrm_tpu_torch.ops.sweep_kernel import (
    build_gram_cache, build_sweep_tables, gram_cache_grid, gram_cache_plain,
)
from gmrm_tpu_torch.sampler import gibbs as tgibbs
from gmrm_tpu_torch.sampler.gibbs import (
    _natural_cass, cached_grams_scaled, marker_sweep,
)
from gmrm_tpu_torch.sampler.state import state_from_numpy, static_from_numpy
from test_torch_sampler import _leaves, small_setup  # noqa: F401 (fixture)

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---- kernel 1 -----------------------------------------------------------


@pytest.mark.parametrize("B,mb,shared_na", [(192, 512, True),
                                            (192, 512, False),
                                            (32, 203, True),
                                            (32, 203, False)])
def test_gram_cache_plain_matches_jax(B, mb, shared_na, monkeypatch):
    """The port's cache bit-equal to the JAX builder.  The JAX builder
    takes 512-byte lanes only, so at mb=203 it gets the bed padded with
    the missing code 0x55 and the mask with zeros, which add nothing."""
    monkeypatch.setattr(swk, "FORCE_INTERPRET", True)
    rng = np.random.default_rng(31 + B + mb + shared_na)
    T, nblocks = 3, 2
    bed = rng.integers(0, 256, size=(nblocks * B, mb), dtype=np.uint8)
    bed[-5:] = 0x55                                        # pad rows
    bed[:, -3:] = 0x55                                     # pad columns
    na = np.ones((T, 4, mb), np.float32)
    na[:, :, -3:] = 0
    if not shared_na:
        na *= rng.uniform(size=(T, 4, mb)) > 0.1
    pad = -mb % 512
    got = build_gram_cache(_t(bed), _t(na), block_size=B,
                           shared_na=shared_na)
    want = swk.build_gram_cache(
        jnp.asarray(np.pad(bed, ((0, 0), (0, pad)), constant_values=0x55)),
        jnp.asarray(np.pad(na, ((0, 0), (0, 0), (0, pad)))), block_size=B,
        shared_na=shared_na)
    assert got.shape == (nblocks, 1 if shared_na else T, 2 * B, 2 * B)
    assert got.abs().sum() > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The quadrants the kernel writes from one product: (b, a) = (a, b)^T.
    np.testing.assert_array_equal(got[:, :, B:, :B].numpy(),
                                  got[:, :, :B, B:].transpose(2, 3).numpy())


@pytest.mark.parametrize("B,tiles", [(32, 3), (128, 3), (192, 12), (256, 12),
                                     (384, 27)])
def test_gram_cache_grid(B, tiles):
    """Three quadrants of ceil(B / 128)^2 tiles a block and mask."""
    assert gram_cache_grid(B, 157, 4) == (tiles, 4, 157)
    assert gram_cache_grid(B, 65535, 1) == (tiles, 1, 65535)


def test_gram_cache_grid_refusals():
    for nblocks, nt in ((65536, 1), (3, 65536)):
        with pytest.raises(ValueError, match="grid limit"):
            gram_cache_grid(128, nblocks, nt)


def test_gram_cache_plain_blocks_are_their_rows_alone():
    """Every block's cache is the raw Gram of its own B rows: a bed of
    three blocks gives the caches of the three beds of one block."""
    rng = np.random.default_rng(5)
    B, mb = 16, 40
    bed = _t(rng.integers(0, 256, size=(3 * B, mb), dtype=np.uint8))
    na = _t((rng.uniform(size=(2, 4, mb)) > 0.1).astype(np.float32))
    whole = gram_cache_plain(bed, na, B)
    for b in range(3):
        assert torch.equal(whole[b],
                           gram_cache_plain(bed[b * B:(b + 1) * B], na, B)[0])


# ---- kernel 3 -----------------------------------------------------------


@pytest.mark.parametrize("T,B,K,W", [(4, 128, 4, 32), (2, 64, 4, 8),
                                     (8, 128, 16, 32), (4, 256, 4, 32),
                                     (8, 256, 16, 32), (3, 30, 3, 5),
                                     (1, 32, 2, 32)])
def test_wave_plan_fits_and_is_maximal(T, B, K, W):
    """The plan fits the CTA's shared memory, stages the tables while they
    fit and then as many waves' packed Gram rows, in wave order, as fit."""
    tab, gsw = wave_plan(T, B, K, W)
    cap = tsw.SMEM_BYTES // 4
    nw = B // W
    assert tsw._layout_words(T, B, K, W, tab, gsw) <= cap
    assert tab == 1 or tsw._layout_words(T, B, K, W, 1, 0) > cap
    assert 0 <= gsw <= nw - 1
    assert gsw == nw - 1 or tsw._layout_words(T, B, K, W, tab,
                                              gsw + 1) > cap


def test_wave_plan_values_and_refusals():
    # The anchor: tables and all three foldable waves staged (96 KB of
    # Gram rows beside the state).
    assert wave_plan(4, 128, 4, 32) == (1, 3)
    assert 4 * 4 * 32 * sum(128 - 32 * (w + 1) for w in range(3)) == 96 * 1024
    assert wave_plan(8, 256, 16, 32) == (0, 0)
    assert wave_plan(8, 1024, 4, 32) is None
    with pytest.raises(ValueError, match="divide"):
        wave_plan(4, 128, 4, 24)
    with pytest.raises(ValueError, match="shared"):
        tsw._plan_or_raise(8, 1024, 4, 32)
    # Any K (no MAX_K refusal): at K=17 the tables are staged beside the
    # state and two waves' rows; at K=65 they are not (400 KB at T=4), so
    # they stay in global memory and the rows take their place.
    assert tsw._plan_or_raise(4, 128, 17, 32) == (1, 2)
    assert tsw._plan_or_raise(4, 128, 65, 32) == (0, 3)
    assert 4 * tsw._layout_words(4, 128, 65, 32, 1, 0) > tsw.SMEM_BYTES
    assert tsw.launch_plan(4, 128, 65, 32) == (0, 3, 4)
    assert tsw.wave_stamp_names(2) == (
        "start", "operands staged", "wave 0 drawn",
        "wave 0 folded", "wave 1 drawn", "wave 1 folded")


def _scan_case(rng, T, B):
    """Three blocks' scan inputs as the JAX wave kernel takes them per
    block: an adaV group (sigmaG 0 for trait 0, group 1) and, in the last
    block, a quarter of pad slots."""
    nb, G, K = 3, 3, 4
    cva = np.tile([0.0, 1e-3, 1e-2, 5e-2], (G, 1))
    cvai = np.zeros_like(cva)
    cvai[:, 1:] = 1.0 / cva[:, 1:]
    sigmag = rng.uniform(0.1, 0.5, size=(T, G))
    sigmag[0, 1] = 0.0
    x = rng.normal(size=(nb, B, 300))
    gs = ((x @ x.transpose(0, 2, 1))[:, None]
          * rng.uniform(0.8, 1.2, (nb, T, 1, 1)))
    valid = np.ones((nb, B), bool)
    valid[-1, B - B // 4:] = False
    case = dict(
        c=rng.normal(size=(nb, T, B)) * 30.0, gs=gs,
        beta=rng.normal(size=(nb, T, B)) * 0.05
        * (rng.uniform(size=(nb, T, B)) > 0.5),
        comp=rng.integers(0, K, size=(nb, T, B)).astype(np.int32),
        acum=rng.uniform(size=(nb, T, B)),
        grp=rng.integers(0, G, size=(nb, B)).astype(np.int32),
        valid=valid, u=rng.uniform(size=(nb, T, B)),
        z=rng.normal(size=(nb, T, B)), sigmag=sigmag,
        sigmae=rng.uniform(0.5, 0.9, size=T),
        pi=rng.dirichlet(np.ones(K), size=(T, G)), cva=cva, cvai=cvai,
        nonas=rng.uniform(470.0, 495.0, size=T).round(), n_total=500.0)
    return {k: (v.astype(np.float32) if isinstance(v, np.ndarray)
                and v.dtype == np.float64 else v) for k, v in case.items()}


def _sweep_operands(case):
    """``WaveScanSweep``'s operands from a case, as the composed sweep
    builds them (sampler/gibbs.py _ComposedSweep)."""
    t = {k: (_t(v) if isinstance(v, np.ndarray) else v)
         for k, v in case.items()}
    lc, rd, sqb = build_sweep_tables(t["sigmag"], t["sigmae"], t["pi"],
                                     t["cva"], t["cvai"], t["nonas"],
                                     t["n_total"])
    grp = t["grp"].long()

    def per_block(tab):                       # (K, T, G) -> (nb, K, T, B)
        return tab[:, :, grp].movedim(2, 0).contiguous()

    masks = [scan_masks(grp[n], t["valid"][n], t["sigmag"])
             for n in range(grp.shape[0])]
    msig = torch.linspace(0.5, 2.0, t["beta"].numel()).reshape(
        t["beta"].shape)
    return (t["nonas"] - 1.0, per_block(lc), per_block(rd), per_block(sqb),
            t["beta"], t["comp"], t["acum"], t["u"], t["z"],
            torch.stack([m[0] for m in masks]),
            torch.stack([m[1] for m in masks]), msig,
            (1.0 / (2.0 * t["sigmae"])).contiguous())


@pytest.mark.parametrize("T,W", [(1, 4), (1, 8), (3, 4), (3, 8)])
def test_wave_scan_sweep_matches_one_block(T, W):
    """Three blocks through the sweep interface (out of order, one from a
    run of Grams and a c of its own) bit-equal to the one-block plain
    version on each block's slices; d bit-equal to msig * dbeta."""
    case = _scan_case(np.random.default_rng(40 + 10 * T + W), T, 32)
    ops = _sweep_operands(case)
    nm1, tabs, state, msig, i2se = ops[0], ops[1:4], ops[4:11], ops[11], \
        ops[12]
    c, gs = _t(case["c"]), _t(case["gs"])
    sweep = WaveScanSweep(*ops, wave=W)
    sweep.step(1, c, gs, 1, bc=1)
    sweep.step(0, c, gs, 0, bc=0)
    sweep.step(2, c[2:].clone(), gs[1:].clone(), 1)
    drawn = set()
    for b in range(3):
        base = c[b] + state[0][b] * nm1[:, None]
        want = wave_scan_plain(base, *(x[b] for x in tabs), gs[b],
                               *(x[b] for x in state), i2se, W)
        got = (sweep.dbeta[b], sweep.beta_new[b], sweep.comp_new[b],
               sweep.acum_new[b])
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert torch.equal(sweep.d[b], msig[b] * sweep.dbeta[b])
        # The one-block wrapper is the same function.
        for g, w in zip(wave_scan(base, *(x[b] for x in tabs), gs[b],
                                  *(x[b] for x in state), i2se, wave=W),
                        want):
            assert torch.equal(g, w)
        drawn |= set(want[2][state[5][b] != 0].tolist())
    assert len(drawn) > 1
    pad = ~_t(case["valid"])[2]
    assert torch.equal(sweep.beta_new[2][:, pad], state[0][2][:, pad])
    assert (sweep.dbeta[2][:, pad] == 0).all()


@pytest.mark.parametrize("T,W", [(1, 4), (3, 8)])
def test_wave_scan_sweep_matches_pallas(T, W, monkeypatch):
    """The sweep interface against ``make_block_scan_wave`` in interpret
    mode, block by block: comp exact, the rest at the tolerances of
    tests/test_torch_ops.py (the JAX kernel folds with one MXU dot)."""
    monkeypatch.setattr(skw, "FORCE_INTERPRET", True)
    case = _scan_case(np.random.default_rng(70 + 10 * T + W), T, 32)
    sweep = WaveScanSweep(*_sweep_operands(case), wave=W)
    c, gs = _t(case["c"]), _t(case["gs"])
    call = skw.make_block_scan_wave(W)
    for b in range(3):
        sweep.step(b, c, gs, b, bc=b)
        want = call(*[jnp.asarray(case[k][b]) for k in (
            "c", "gs", "beta", "comp", "acum", "grp", "valid", "u", "z")],
            *[jnp.asarray(case[k]) for k in (
                "sigmag", "sigmae", "pi", "cva", "cvai", "nonas")],
            case["n_total"], interpret=True)
        np.testing.assert_array_equal(sweep.comp_new[b].numpy(),
                                      np.asarray(want.comp_new))
        for name, got in (("dbeta_eff", sweep.dbeta[b]),
                          ("beta_new", sweep.beta_new[b]),
                          ("acum_new", sweep.acum_new[b])):
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


# ---- the composed sweep -------------------------------------------------


def _cached_gram_scaled(gram_cache, blk, win2, mave_blk, msig_blk):
    """One block's scaled Gram as the composed sweep gathered it before
    runs of blocks: blk (1,), win2 (2B,)."""
    gf = gram_cache.index_select(0, blk)[0]                # (NT, 2B, 2B)
    gf = gf.index_select(1, win2).index_select(2, win2)
    return scale_gram(gf, mave_blk, msig_blk)


@pytest.mark.parametrize("run", [1, 3, 5])
@pytest.mark.parametrize("nt", [1, 2])
def test_cached_grams_scaled_bit_equal(run, nt):
    """The scaled Grams of runs of 1, 3 and all 5 blocks bit-equal to the
    per-block gather and scaling."""
    rng = np.random.default_rng(90 + run + nt)
    T, B, nblocks, mb = 2, 16, 5, 24
    bed = _t(rng.integers(0, 256, size=(nblocks * B, mb), dtype=np.uint8))
    na = _t((rng.uniform(size=(nt, 4, mb)) > 0.1).astype(np.float32))
    cache = gram_cache_plain(bed, na, B)
    blk = _t(rng.permutation(nblocks))
    win = _t(np.argsort(rng.uniform(size=(nblocks, B)), axis=1))
    win2 = torch.cat([win, win + B], dim=1)
    mave = _t(rng.uniform(0.2, 1.8, size=(nblocks, T, B)).astype(np.float32))
    msig = _t(rng.uniform(0.5, 2.0, size=(nblocks, T, B)).astype(np.float32))
    for s in range(0, nblocks, run):
        got = cached_grams_scaled(cache, blk[s:s + run], win2[s:s + run],
                                  mave[s:s + run], msig[s:s + run])
        assert got.shape == (min(run, nblocks - s), T, B, B)
        for n in range(got.shape[0]):
            want = _cached_gram_scaled(cache, blk[s + n:s + n + 1],
                                       win2[s + n], mave[s + n],
                                       msig[s + n])
            assert torch.equal(got[n], want)


def _per_block_sweep(eps, betas, comp, acum, sigmag, sigmae, pi_est, static,
                     blocks, u_all, z_all, wave):
    """The composed W>1 sweep at the cadence the port ran before the sweep
    interface: per block the one-block c-dot, the block's cached Gram
    gathered and scaled, the one-block wave scan on base = c + beta (nonas
    - 1) and the one-block update with d = msig * dbeta; the blocks'
    results stacked after the loop."""
    nblocks, B = blocks.shape
    f32, i32 = torch.float32, torch.int32
    lc_t, rd_t, sqb_t = build_sweep_tables(sigmag, sigmae, pi_est,
                                           static.cva, static.cvai,
                                           static.nonas, static.n_total)
    i2se = (1.0 / (2.0 * sigmae.to(f32))).contiguous()
    perm = blocks.reshape(-1).long()
    rows = perm.to(i32).reshape(nblocks, B)
    blk_idx = perm.reshape(nblocks, B)[:, :1] // B
    win = perm.reshape(nblocks, B) - blk_idx * B
    win2 = torch.cat([win, win + B], dim=1)

    def split(y):
        y = y.reshape(*y.shape[:-1], nblocks, B)
        return y.movedim(-2, 0).contiguous()

    grp_p = static.group_of[perm]
    mave_p, msig_p = split(static.mave[:, perm]), split(static.msig[:, perm])
    beta_p = split(betas[:, perm])
    comp_p, acum_p = split(comp.to(i32)[:, perm]), split(acum[:, perm])
    lc_p, rd_p, sqb_p = (split(x[:, :, grp_p]) for x in (lc_t, rd_t, sqb_t))
    live, zerob = scan_masks(grp_p, perm < static.m_local, sigmag)
    live_p, zerob_p = split(live), split(zerob)
    nm1 = static.nonas.to(f32) - 1.0
    outs = []
    for b in range(nblocks):
        c = block_cdot(static.bed, rows[b], eps, mave_p[b], msig_p[b])
        gs = _cached_gram_scaled(static.gram_cache, blk_idx[b], win2[b],
                                 mave_p[b], msig_p[b])
        dbeta, beta_new, comp_new, acum_new = wave_scan(
            c + beta_p[b] * nm1[:, None], lc_p[b], rd_p[b], sqb_p[b], gs,
            beta_p[b], comp_p[b], acum_p[b], u_all[b], z_all[b], live_p[b],
            zerob_p[b], i2se, wave=wave)
        block_eps_update_(static.bed, rows[b], msig_p[b] * dbeta, mave_p[b],
                          static.na, eps)
        outs.append((beta_new, comp_new, acum_new))
    new = []
    for k, like in enumerate((betas, comp.to(i32), acum)):
        y = torch.stack([o[k] for o in outs]).movedim(0, 1).reshape(
            like.shape)
        out = torch.empty_like(like)
        out[:, perm] = y
        new.append(out)
    K = static.cva.shape[1]
    cass = _natural_cass(new[1], static.group_of, sigmag, static.m_local, K)
    return (eps, *new, cass)


def _wave_sweep_args(sim, block_size, wave, seed):
    """One W>1 sweep's arguments on ``sim`` from the port's own loaders: a
    block-preserving shuffle, injected draws, a non-zero beta and an adaV
    group."""
    opt = Options(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                  group_index_file=sim.gri, group_mixture_file=sim.grm,
                  iterations=1, seed=3, block_size=block_size,
                  wave_size=wave)
    opt.validate()
    opt.load_group_mixtures()
    data = runner.load_data(opt)
    static = runner.build_static(data, opt, "cpu")
    state = runner.init_sampler_state(data, opt, "cpu")
    assert static.gram_cache is not None
    T, m_pad = state.betas.shape
    nblocks = m_pad // block_size
    rng = np.random.default_rng(seed)
    blocks = (rng.permutation(nblocks)[:, None] * block_size
              + np.argsort(rng.uniform(size=(nblocks, block_size)), axis=1))
    sigmag = state.sigmag.clone()
    sigmag[0, 0] = 0.0
    sigmae = 0.5 * (state.eps * state.eps).sum(dim=(1, 2)) / static.nonas
    betas = _t((rng.normal(size=(T, m_pad)) * 0.02).astype(np.float32))
    return (state.eps, betas, state.comp, state.acum, sigmag, sigmae,
            state.pi_est, static, _t(blocks),
            _t(rng.uniform(size=(nblocks, T, block_size)).astype(np.float32)),
            _t(rng.normal(size=(nblocks, T, block_size)).astype(np.float32)))


@pytest.mark.parametrize("run", [3, None])
def test_composed_sweep_cadence_bit_equal(sim_medium, monkeypatch, run):
    """One composed marker_sweep at W=8 on sim_medium (8 blocks of 32),
    the Grams in runs of 3 and of all blocks: the c-dot of block 0, then
    per block the wave scan of the sweep interface and the update fused
    with the next c-dot, the last block's update alone; eps, betas, comp,
    acum and cass bit-equal to the per-block cadence of before."""
    args = _wave_sweep_args(sim_medium, 32, 8, 17)
    nb = args[8].shape[0]
    assert nb == 8
    if run is not None:
        monkeypatch.setattr(tgibbs, "gram_run_blocks", lambda *a: run)
    calls, depth = [], [0]

    def spy(cls, name, tag):
        real = getattr(cls, name)

        def wrapped(self, b, *rest, **kw):
            # Calls from the sweep only: on the CPU update_cdot_ is update_
            # then cdot.
            if not depth[0]:
                calls.append((tag, b))
            depth[0] += 1
            try:
                return real(self, b, *rest, **kw)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(cls, name, wrapped)

    for name in ("cdot", "update_", "update_cdot_"):
        spy(bk.BlockPasses, name, name)
    spy(WaveScanSweep, "step", "scan")
    grams = []
    real_build = tgibbs._ComposedSweep._build_grams
    monkeypatch.setattr(tgibbs._ComposedSweep, "_build_grams",
                        lambda self, start: (grams.append(start),
                                             real_build(self, start))[1])
    got = marker_sweep(args[0].clone(), *args[1:], wave=8, megakernel=False)
    assert calls == ([("cdot", 0)]
                     + [c for b in range(nb - 1)
                        for c in (("scan", b), ("update_cdot_", b))]
                     + [("scan", nb - 1), ("update_", nb - 1)])
    assert grams == ([0, 3, 6] if run == 3 else [0])
    want = _per_block_sweep(args[0].clone(), *args[1:], wave=8)
    assert (got[2] != 0).any()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("wave", [8])
def test_composed_sweep_matches_jax_composed(small_setup, wave,  # noqa: F811
                                             monkeypatch):
    """The port's composed sweep against the JAX package's composed sweep
    (``megakernel=False``) with the same injected order and draws, with
    and without phenotype NAs, at the tolerances of
    tests/test_torch_sampler.py::test_sweep_matches_both_jax_paths."""
    for mod in (pk, skw, swk):
        monkeypatch.setattr(mod, "FORCE_INTERPRET", True)
    opt, data, static, state = small_setup
    shared_na = all(ph.nas == 0 for ph in data.phens)
    B = opt.block_size
    T, m_pad = state.betas.shape
    nblocks = m_pad // B
    rng = np.random.default_rng(3030 + wave)
    pi_b = rng.permutation(nblocks).astype(np.int32)
    win = np.argsort(rng.uniform(size=(nblocks, B)), axis=1).astype(np.int32)
    u = rng.uniform(size=(nblocks, T, B)).astype(np.float32)
    z = rng.normal(size=(nblocks, T, B)).astype(np.float32)
    eps = np.asarray(state.eps)
    nonas = np.asarray(static.nonas)
    sigmae = (0.5 * (eps.astype(np.float64) ** 2).sum(axis=(1, 2))
              / nonas).astype(np.float32)
    betas = (rng.normal(size=(T, m_pad)) * 0.02).astype(np.float32)
    sigmag = np.asarray(state.sigmag).copy()
    sigmag[1, 0] = 0.0                                   # an adaV group
    blocks = (pi_b[:, None] * B + win).reshape(nblocks, B)
    w_eps, w_beta, w_comp, w_acum, w_cass = jax.device_get(
        jgibbs.marker_sweep(
            jnp.asarray(eps), jnp.asarray(betas), state.comp, state.acum,
            jnp.asarray(sigmag), jnp.asarray(sigmae), state.pi_est, static,
            jnp.asarray(blocks), jnp.asarray(u), jnp.asarray(z),
            use_pallas=True, shared_na=shared_na, wave_size=wave,
            pallas_upd=True, megakernel=False,
            block_perm=(jnp.asarray(pi_b), jnp.asarray(win))))

    dev = torch.device("cpu")
    tstate = state_from_numpy(_leaves(state), dev)
    tstatic = static_from_numpy(_leaves(static), dev)
    got = marker_sweep(
        torch.from_numpy(eps.copy()), torch.from_numpy(betas),
        tstate.comp, tstate.acum, torch.from_numpy(sigmag),
        torch.from_numpy(sigmae), tstate.pi_est, tstatic,
        torch.from_numpy(blocks), torch.from_numpy(u), torch.from_numpy(z),
        wave=wave, megakernel=False)
    g_eps, g_beta, g_comp, g_acum, g_cass = (x.numpy() for x in got)
    assert (g_comp[:, :data.m_local] != 0).any()
    np.testing.assert_array_equal(g_comp, np.asarray(w_comp))
    np.testing.assert_array_equal(g_cass, np.asarray(w_cass))
    np.testing.assert_allclose(g_beta, np.asarray(w_beta), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(g_eps, np.asarray(w_eps), rtol=1e-3,
                               atol=2e-4)
    np.testing.assert_allclose(g_acum, np.asarray(w_acum), rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("wave", [1, 8])
def test_composed_sweep_is_freed_by_reference_counting(sim_medium, wave,
                                                       monkeypatch):
    """A finished sweep's object, which holds a run of scaled Grams and the
    sweep's arrays, is freed when marker_sweep returns, without the cycle
    collector: a chain of W=1 iterations would otherwise hold many sweeps'
    Grams on the card at once."""
    import gc
    import weakref
    if wave == 1:
        from test_torch_serial import _serial_sweep_args
        args = _serial_sweep_args(sim_medium, 32, 5)
    else:
        args = _wave_sweep_args(sim_medium, 32, wave, 23)
    made = []
    real_init = tgibbs._ComposedSweep.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        made.append(weakref.ref(self))
    monkeypatch.setattr(tgibbs._ComposedSweep, "__init__", init)
    gc.disable()
    try:
        marker_sweep(args[0].clone(), *args[1:], wave=wave, megakernel=False)
        assert len(made) == 1 and made[0]() is None
    finally:
        gc.enable()
