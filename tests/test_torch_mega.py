"""The whole-sweep path of the port (``sweep_blocks``, the default of wave
mode) against the JAX package's mega-kernels in interpret mode, resident
and N-tiled, and against the port's own composed per-block path.

On CPU tensors ``sweep_blocks`` runs its plain PyTorch version.  Both
packages get the same NumPy-seeded operands, block order, row order and
draws.  Tolerances are those of tests/test_sweep_kernel.py:57-66: ``comp``
and ``cass`` exact; beta, eps and acum to float32 sum-order noise (the TPU
kernel also splits eps into bf16 hi/lo halves).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gmrm_tpu.ops.pallas_kernels as pk
import gmrm_tpu.ops.scan_kernel_wave as skw
import gmrm_tpu.ops.sweep_kernel as swk
from gmrm_tpu.config import Options as JaxOptions
from gmrm_tpu.io.sim import simulate
from gmrm_tpu.runner import build_static, init_sampler_state, load_data
from gmrm_tpu.sampler import gibbs as jgibbs
from gmrm_tpu_torch.config import Options
from gmrm_tpu_torch.ops.sweep_kernel import build_sweep_tables, sweep_blocks
from gmrm_tpu_torch.runner import run_training
from gmrm_tpu_torch.sampler.dists import RngPlan
from gmrm_tpu_torch.sampler.gibbs import gibbs_iteration, marker_sweep
from gmrm_tpu_torch.sampler.state import state_from_numpy, static_from_numpy

torch.set_num_threads(2)


def _setup(out, **sim_kw):
    sim = simulate(out, **sim_kw)
    opt = JaxOptions(bed_file=sim.bed, dim_file=sim.dim,
                     phen_files=sim.phens, group_index_file=sim.gri,
                     group_mixture_file=sim.grm, iterations=1, seed=3,
                     block_size=32, wave_size=8, use_pallas=True,
                     output_thin_rate=10 ** 9)
    opt.validate()
    opt.load_group_mixtures()
    data = load_data(opt)
    static = build_static(data, opt, jnp.float32)
    state = init_sampler_state(data, opt, jnp.float32)
    return opt, data, static, state


@pytest.fixture(scope="module", params=[0.02, 0.0], ids=["na", "no_na"])
def small_setup(request, tmp_path_factory):
    """tests/test_torch_sampler.py:31-47: NT = T and NT = 1, two groups."""
    return _setup(str(tmp_path_factory.mktemp("megasmall")), n=600, m=128,
                  n_traits=2, n_causal=32, h2=0.5, n_groups=2,
                  na_rate=request.param, seed=7)


@pytest.fixture(scope="module")
def tall_setup(tmp_path_factory):
    """tests/test_sweep_kernel.py:134-149: mb_pad = 1024, two lane tiles
    once TILE_MAX_LANES is 1."""
    return _setup(str(tmp_path_factory.mktemp("megatall")), n=2500, m=64,
                  n_traits=2, n_causal=16, h2=0.5, n_groups=1, na_rate=0.0,
                  seed=11)


def _interpret(monkeypatch):
    for mod in (pk, skw, swk):
        monkeypatch.setattr(mod, "FORCE_INTERPRET", True)


def _leaves(x):
    return {k: (None if v is None else np.asarray(v))
            for k, v in vars(x).items() if k != "key"}


def _inputs(setup, wave, adav):
    """NumPy operands of one sweep: order, draws, a non-zero beta and, with
    ``adav``, a group whose variance is 0 for one trait."""
    opt, data, static, state = setup
    B = opt.block_size
    T, m_pad = state.betas.shape
    nblocks = m_pad // B
    rng = np.random.default_rng(2024 + wave)
    eps = np.asarray(state.eps)
    nonas = np.asarray(static.nonas)
    sigmag = np.asarray(state.sigmag).copy()
    if adav:
        sigmag[1, 0] = 0.0
    return dict(
        pi_b=rng.permutation(nblocks).astype(np.int32),
        win=np.argsort(rng.uniform(size=(nblocks, B)),
                       axis=1).astype(np.int32),
        u=rng.uniform(size=(nblocks, T, B)).astype(np.float32),
        z=rng.normal(size=(nblocks, T, B)).astype(np.float32),
        eps=eps, sigmag=sigmag,
        sigmae=(0.5 * (eps.astype(np.float64) ** 2).sum(axis=(1, 2))
                / nonas).astype(np.float32),
        betas=(rng.normal(size=(T, m_pad)) * 0.02).astype(np.float32),
        shared_na=all(ph.nas == 0 for ph in data.phens))


def _assert_sweeps_agree(got, want, name=""):
    g_eps, g_beta, g_comp, g_acum = (np.asarray(x) for x in got[:4])
    w_eps, w_beta, w_comp, w_acum = (np.asarray(x) for x in want[:4])
    np.testing.assert_array_equal(g_comp, w_comp, name)
    np.testing.assert_allclose(g_beta, w_beta, rtol=1e-4, atol=1e-5,
                               err_msg=name)
    np.testing.assert_allclose(g_eps, w_eps, rtol=1e-3, atol=2e-4,
                               err_msg=name)
    np.testing.assert_allclose(g_acum, w_acum, rtol=1e-3, atol=1e-5,
                               err_msg=name)
    if len(got) > 4:
        np.testing.assert_array_equal(np.asarray(got[4]),
                                      np.asarray(want[4]), name)


def _both_sweep_blocks(setup, wave, adav, tiled):
    """sweep_blocks_pallas (interpret mode) and the port's sweep_blocks on
    the same operands."""
    opt, data, static, state = setup
    x = _inputs(setup, wave, adav)
    nt = 1 if x["shared_na"] else state.betas.shape[0]
    jt = swk.build_sweep_tables(
        jnp.asarray(x["sigmag"]), jnp.asarray(x["sigmae"]), state.pi_est,
        static.cva, static.cvai, static.nonas, static.n_total)
    want = jax.device_get(swk.sweep_blocks_pallas(
        static.bed, jnp.asarray(x["pi_b"]), jnp.asarray(x["win"]),
        static.m_local, static.gram_cache, jnp.asarray(x["eps"]), static.na,
        static.mave, static.msig, jnp.asarray(x["betas"]), state.comp,
        state.acum, static.group_of, jnp.asarray(x["u"]),
        jnp.asarray(x["z"]), jnp.asarray(x["sigmag"]), *jt,
        (1.0 / (2.0 * jnp.asarray(x["sigmae"])))[:, None],
        static.nonas.astype(jnp.float32)[:, None], wave=wave,
        shared_na=x["shared_na"], tiled=tiled))

    dev = torch.device("cpu")
    ts = static_from_numpy(_leaves(static), dev)
    st = state_from_numpy(_leaves(state), dev)
    sigmag = torch.from_numpy(x["sigmag"])
    sigmae = torch.from_numpy(x["sigmae"])
    tt = build_sweep_tables(sigmag, sigmae, st.pi_est, ts.cva, ts.cvai,
                            ts.nonas, ts.n_total)
    got = sweep_blocks(
        ts.bed, torch.from_numpy(x["pi_b"]), torch.from_numpy(x["win"]),
        ts.m_local, ts.gram_cache, torch.from_numpy(x["eps"].copy()),
        ts.na[:nt].contiguous(), ts.mave, ts.msig,
        torch.from_numpy(x["betas"]), st.comp, st.acum, ts.group_of,
        torch.from_numpy(x["u"]), torch.from_numpy(x["z"]), sigmag, *tt,
        1.0 / (2.0 * sigmae), ts.nonas, wave=wave)
    return got, want, ts, sigmag


@pytest.mark.parametrize("wave", [8, 32])
def test_sweep_blocks_matches_pallas_megakernel(small_setup, wave,
                                                monkeypatch):
    """NT = T and NT = 1, an adaV group (sigmaG = 0 zeroes beta and sets
    acum to 1) and pad slots in the last block (they keep their state)."""
    _interpret(monkeypatch)
    got, want, ts, sigmag = _both_sweep_blocks(small_setup, wave, True,
                                               False)
    _assert_sweeps_agree(got, want)
    beta, acum = got[1].numpy(), got[3].numpy()
    adav = (ts.group_of.numpy() == 0) & (np.arange(beta.shape[1])
                                         < ts.m_local)
    assert adav.any() and (beta[1, adav] == 0).all()
    assert (acum[1, adav] == 1).all()
    assert (got[2].numpy()[:, :ts.m_local] != 0).any()


@pytest.mark.parametrize("tiled", [False, True], ids=["resident", "tiled"])
def test_sweep_blocks_matches_resident_and_tiled(tall_setup, tiled,
                                                 monkeypatch):
    """One port kernel stands for both TPU kernels: the resident one and
    the N-tiled one (two lane tiles of 512 at mb_pad = 1024)."""
    _interpret(monkeypatch)
    monkeypatch.setattr(swk, "TILE_MAX_LANES", 1)
    assert tall_setup[2].bed.shape[1] == 1024
    got, want, _, _ = _both_sweep_blocks(tall_setup, 8, False, tiled)
    _assert_sweeps_agree(got, want)


def test_marker_sweep_default_is_the_whole_sweep_path(small_setup,
                                                      monkeypatch):
    """megakernel=None and megakernel=False of the port agree with each
    other and with both JAX sweeps; None reaches sweep_blocks."""
    _interpret(monkeypatch)
    opt, data, static, state = small_setup
    wave = 8
    x = _inputs(small_setup, wave, True)
    B = opt.block_size
    blocks = x["pi_b"][:, None] * B + x["win"]
    want = {}
    for name, mega in (("mega", True), ("composed", False)):
        want[name] = jax.device_get(jgibbs.marker_sweep(
            jnp.asarray(x["eps"]), jnp.asarray(x["betas"]), state.comp,
            state.acum, jnp.asarray(x["sigmag"]), jnp.asarray(x["sigmae"]),
            state.pi_est, static, jnp.asarray(blocks), jnp.asarray(x["u"]),
            jnp.asarray(x["z"]), use_pallas=True, shared_na=x["shared_na"],
            wave_size=wave, pallas_upd=True, megakernel=mega,
            block_perm=(jnp.asarray(x["pi_b"]), jnp.asarray(x["win"]))))

    dev = torch.device("cpu")
    ts = static_from_numpy(_leaves(static), dev)
    st = state_from_numpy(_leaves(state), dev)
    import gmrm_tpu_torch.sampler.gibbs as tgibbs
    calls = []
    real = tgibbs.sweep_blocks
    monkeypatch.setattr(tgibbs, "sweep_blocks",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = {}
    for name, mega in (("default", None), ("composed", False)):
        got[name] = marker_sweep(
            torch.from_numpy(x["eps"].copy()), torch.from_numpy(x["betas"]),
            st.comp, st.acum, torch.from_numpy(x["sigmag"]),
            torch.from_numpy(x["sigmae"]), st.pi_est, ts,
            torch.from_numpy(blocks), torch.from_numpy(x["u"]),
            torch.from_numpy(x["z"]), wave=wave, megakernel=mega)
    assert len(calls) == 1
    _assert_sweeps_agree(got["default"], got["composed"], "port")
    for gname, g in got.items():
        for wname, w in want.items():
            _assert_sweeps_agree(g, w, f"{gname} vs jax {wname}")


def _port_start(setup):
    opt, data, static, state = setup
    dev = torch.device("cpu")
    return (state_from_numpy(_leaves(state), dev),
            static_from_numpy(_leaves(static), dev))


def test_megakernel_raises_without_prerequisites(small_setup):
    st, ts = _port_start(small_setup)
    with pytest.raises(ValueError, match="megakernel=True requires"):
        gibbs_iteration(st, ts, 1, RngPlan(3, "cpu"), block_size=32,
                        wave=1, megakernel=True)
    with pytest.raises(ValueError, match="megakernel=True requires"):
        ts.gram_cache = None
        gibbs_iteration(st, ts, 1, RngPlan(3, "cpu"), block_size=32,
                        wave=8, megakernel=True)


def test_megakernel_multi_iteration_chain(small_setup):
    """Three chained iterations, whole-sweep vs composed, stay in agreement
    through the eps feedback (tests/test_sweep_kernel.py:69-90)."""
    chains = {}
    for mega in (None, False):
        st, ts = _port_start(small_setup)
        rng = RngPlan(3, "cpu")
        for it in range(1, 4):
            st, _ = gibbs_iteration(st, ts, it, rng, block_size=32, wave=8,
                                    megakernel=mega)
        chains[mega] = st
    a, b = chains[False], chains[None]
    assert torch.equal(b.comp, a.comp) and torch.equal(b.cass, a.cass)
    assert (b.comp != 0).any()
    np.testing.assert_allclose(b.betas.numpy(), a.betas.numpy(), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(b.eps.numpy(), a.eps.numpy(), rtol=1e-3,
                               atol=2e-4)


def test_run_training_default_path_recovers_effects(sim_medium, tmp_path):
    """run_training at B=32, W=8 goes through the whole-sweep path on the
    CPU too, and the posterior means still track the true effects."""
    opt = Options(bed_file=sim_medium.bed, dim_file=sim_medium.dim,
                  phen_files=sim_medium.phens,
                  group_index_file=sim_medium.gri,
                  group_mixture_file=sim_medium.grm, iterations=30, seed=42,
                  out_dir=str(tmp_path / "out"), block_size=32, wave_size=8,
                  output_thin_rate=3)
    res = run_training(opt, device="cpu", verbose=False)
    assert opt.wave_size == 8
    assert "sweep_blocks" in res.kernel_launches
    assert set(res.kernel_launches.values()) == {0}      # CPU: plain only
    for t in range(len(sim_medium.phens)):
        r = np.corrcoef(res.beta_mean[t], sim_medium.beta_true[:, t])[0, 1]
        assert r >= 0.9, r
    assert os.path.exists(tmp_path / "out" / "test1.bet")
