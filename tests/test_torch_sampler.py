"""The port's sweep, hyperparameter block and samplers against the JAX
package, the float64 oracle and scipy.

The sweep runs from the JAX package's own state (``state_from_numpy`` /
``static_from_numpy``) with injected block order, row order and draws, so
both packages compute from the same numbers.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.stats as st
import torch

import gmrm_tpu.ops.pallas_kernels as pk
import gmrm_tpu.ops.scan_kernel_wave as skw
import gmrm_tpu.ops.sweep_kernel as swk
from gmrm_tpu import oracle
from gmrm_tpu.config import Options
from gmrm_tpu.io.sim import simulate
from gmrm_tpu.runner import build_static, init_sampler_state, load_data
from gmrm_tpu.sampler import gibbs as jgibbs
from gmrm_tpu_torch.sampler import dists
from gmrm_tpu_torch.sampler.gibbs import hyper_block, marker_sweep
from gmrm_tpu_torch.sampler.state import state_from_numpy, static_from_numpy

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=[0.02, 0.0], ids=["na", "no_na"])
def small_setup(request, tmp_path_factory):
    """tests/test_sweep_kernel.py:23-37, with and without phenotype NAs
    (NT = T and NT = 1)."""
    out = str(tmp_path_factory.mktemp("torchsweep"))
    sim = simulate(out, n=600, m=128, n_traits=2, n_causal=32, h2=0.5,
                   n_groups=2, na_rate=request.param, seed=7)
    opt = Options(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                  group_index_file=sim.gri, group_mixture_file=sim.grm,
                  iterations=1, seed=3, block_size=32, wave_size=8,
                  use_pallas=True, output_thin_rate=10 ** 9)
    opt.validate()
    opt.load_group_mixtures()
    data = load_data(opt)
    static = build_static(data, opt, jnp.float32)
    state = init_sampler_state(data, opt, jnp.float32)
    return opt, data, static, state


def _leaves(x):
    return {k: (None if v is None else np.asarray(v))
            for k, v in vars(x).items() if k != "key"}


@pytest.mark.parametrize("wave", [8, 32])
def test_sweep_matches_both_jax_paths(small_setup, wave, monkeypatch):
    for mod in (pk, skw, swk):
        monkeypatch.setattr(mod, "FORCE_INTERPRET", True)
    opt, data, static, state = small_setup
    shared_na = all(ph.nas == 0 for ph in data.phens)
    B = opt.block_size
    T, m_pad = state.betas.shape
    nblocks = m_pad // B
    rng = np.random.default_rng(2024 + wave)
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

    jargs = (jnp.asarray(eps), jnp.asarray(betas), state.comp, state.acum,
             jnp.asarray(sigmag), jnp.asarray(sigmae), state.pi_est, static)
    blocks = (pi_b[:, None] * B + win).reshape(nblocks, B)
    want = {}
    for name, mega in (("mega", True), ("composed", False)):
        want[name] = jax.device_get(jgibbs.marker_sweep(
            *jargs, jnp.asarray(blocks), jnp.asarray(u), jnp.asarray(z),
            use_pallas=True, shared_na=shared_na, wave_size=wave,
            pallas_upd=True, megakernel=mega,
            block_perm=(jnp.asarray(pi_b), jnp.asarray(win))))

    dev = torch.device("cpu")
    tstate = state_from_numpy(_leaves(state), dev)
    tstatic = static_from_numpy(_leaves(static), dev)
    got = marker_sweep(
        torch.from_numpy(eps.copy()), torch.from_numpy(betas),
        tstate.comp, tstate.acum, torch.from_numpy(sigmag),
        torch.from_numpy(sigmae), tstate.pi_est, tstatic,
        torch.from_numpy(blocks), torch.from_numpy(u), torch.from_numpy(z),
        wave=wave)
    g_eps, g_beta, g_comp, g_acum, g_cass = (x.numpy() for x in got)
    assert (g_comp[:, :data.m_local] != 0).any()
    for name, (w_eps, w_beta, w_comp, w_acum, w_cass) in want.items():
        # Tolerances of tests/test_sweep_kernel.py:57-66.
        np.testing.assert_array_equal(g_comp, np.asarray(w_comp), name)
        np.testing.assert_array_equal(g_cass, np.asarray(w_cass), name)
        np.testing.assert_allclose(g_beta, np.asarray(w_beta), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(g_eps, np.asarray(w_eps), rtol=1e-3,
                                   atol=2e-4, err_msg=name)
        np.testing.assert_allclose(g_acum, np.asarray(w_acum), rtol=1e-3,
                                   atol=1e-5, err_msg=name)


def test_hyper_block_matches_oracle(small_setup, monkeypatch):
    """Injected draws: every Gamma(a, 1) variate is its mean a, in both the
    port and the float64 oracle (oracle.py:231)."""
    opt, data, static, state = small_setup
    monkeypatch.setattr(dists, "gamma", lambda gen, shape: shape.float())
    rng = np.random.default_rng(9)
    T, m_pad = state.betas.shape
    G, K = opt.cva.shape
    betas = (rng.normal(size=(T, m_pad)) * 0.05).astype(np.float32)
    cass = rng.integers(0, 30, size=(T, G, K)).astype(np.int32)
    cass[0, 1] = 0                                  # an emptied group
    eps = np.array(state.eps)
    sigmag = np.array(state.sigmag)
    pi = np.array(state.pi_est)
    tstatic = static_from_numpy(_leaves(static), torch.device("cpu"))
    sg, se, pi_new, m0, _ = hyper_block(
        torch.from_numpy(betas), torch.from_numpy(cass),
        torch.from_numpy(eps), torch.from_numpy(sigmag),
        torch.from_numpy(pi), tstatic, gen=lambda name: None)

    group_of = np.asarray(static.group_of)
    mtot = np.asarray(static.mtotgrp)
    for t in range(T):
        ost = oracle.OracleState(
            eps=eps[t].reshape(-1).astype(np.float64),
            betas=betas[t].astype(np.float64), comp=None, acum=None,
            cass=cass[t].astype(np.int64), sigmag=sigmag[t].astype(float),
            sigmae=0.0, pi_est=pi[t].astype(float).copy(), mu=0.0,
            nonas=int(np.asarray(static.nonas)[t]))
        oracle.hyper_block(ost, group_of, mtot, data.n,
                           draw_inv_chisq=lambda a, b: b,
                           draw_gamma=lambda shape: shape)
        np.testing.assert_allclose(sg[t].numpy(), ost.sigmag, rtol=1e-5)
        np.testing.assert_allclose(pi_new[t].numpy(), ost.pi_est,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(se[t]), ost.sigmae, rtol=1e-5)
        np.testing.assert_array_equal(m0[t].numpy(), mtot - cass[t, :, 0])


@pytest.mark.parametrize("shape", [0.3, 1.0, 50.0])
def test_samplers_follow_their_laws(shape):
    """KS tests against scipy: Gamma, scaled inverse chi-squared and a
    Dirichlet marginal (Beta(a_i, sum a - a_i))."""
    n = 4000
    plan = dists.RngPlan(17, "cpu")
    a = torch.full((n,), shape)
    g = dists.gamma(plan.gen(1, "sigmag"), a).double().numpy()
    assert st.kstest(g, "gamma", args=(shape,)).pvalue > 1e-3

    nu, s2 = 2.0 * shape, 0.7
    x = dists.inv_scaled_chisq(plan.gen(1, "sigmae"), torch.full((n,), nu),
                               torch.full((n,), s2)).double().numpy()
    law = st.invgamma(0.5 * nu, scale=0.5 * nu * s2)
    assert st.kstest(x, law.cdf).pvalue > 1e-3

    alpha = torch.tensor([shape, 2.0, 0.5]).expand(n, 3)
    p = dists.dirichlet_from_counts(plan.gen(1, "pi"), alpha).double()
    np.testing.assert_allclose(p.sum(1).numpy(), 1.0, rtol=1e-6)
    marg = st.beta(shape, 2.5)
    assert st.kstest(p[:, 0].numpy(), marg.cdf).pvalue > 1e-3


def test_rng_plan_streams_are_independent_of_order():
    plan = dists.RngPlan(5, "cpu")
    first = torch.rand(4, generator=plan.gen(3, "u"))
    torch.rand(100, generator=plan.gen(3, "z"))
    again = torch.rand(4, generator=plan.gen(3, "u"))
    other = torch.rand(4, generator=plan.gen(4, "u"))
    assert torch.equal(first, again)
    assert not torch.equal(first, other)


def _gamma_unsplit(gen, shape):
    """dists.gamma as one function, its draws inline (the form before it
    was split into a draw half and an arithmetic half)."""
    f64 = torch.float64
    a = shape.to(f64)
    small = a < 1.0
    ab = torch.where(small, a + 1.0, a)
    d = ab - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    x = torch.randn((dists.ROUNDS,) + a.shape, generator=gen, dtype=f64)
    uu = torch.rand((dists.ROUNDS,) + a.shape, generator=gen, dtype=f64)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(uu) < 0.5 * x * x + d - d * v
                    + d * torch.log(torch.where(v > 0, v, 1.0)))
    first = ok.to(torch.int32).argmax(0, keepdim=True)
    g = (d * v).gather(0, first)[0]
    boost = torch.rand(a.shape, generator=gen, dtype=f64)
    return torch.where(small, g * boost ** (1.0 / a), g).to(torch.float32)


@pytest.mark.parametrize("shapes", [
    [0.05, 0.3, 0.5, 0.999], [0.99, 1.0, 1.0001, 1.2], [4999.5, 5000.0,
                                                        5012.25]],
    ids=["below_1", "near_1", "near_5e3"])
def test_gamma_draw_and_arithmetic_halves_are_gamma(shapes):
    """The draw half (gamma_draws, into buffers) and the arithmetic half
    (gamma_from_draws) together give dists.gamma's numbers bit for bit, on
    the same generator, as does dists.gamma itself."""
    shape = torch.tensor(shapes).repeat(3, 1)
    plan = dists.RngPlan(23, "cpu")
    want = _gamma_unsplit(plan.gen(2, "pi"), shape)
    bufs = dists.gamma_draws(plan.gen(2, "pi"), shape.shape, "cpu")
    again = dists.gamma_draws(plan.gen(2, "pi"), shape.shape, "cpu",
                              out=tuple(torch.zeros_like(b) for b in bufs))
    for got in (dists.gamma_from_draws(shape, bufs),
                dists.gamma_from_draws(shape, again),
                dists.gamma(plan.gen(2, "pi"), shape)):
        assert got.dtype == torch.float32
        assert torch.equal(got, want)
    assert (want > 0).all()


@pytest.mark.parametrize("block, wave", [(32, 8), (64, 32)],
                         ids=["W8", "W32"])
def test_whole_sweep_iteration_is_gibbs_iteration(sim_medium, block, wave):
    """The restructured default iteration (draws into buffers, the
    arithmetic before and after the sweep split out, the state updated in
    place) gives gibbs_iteration's state and IterAux bit for bit over three
    iterations, the first with its sigmaE from the residual."""
    from gmrm_tpu_torch.config import Options as PortOptions
    from gmrm_tpu_torch.runner import (
        build_static as port_static, init_sampler_state as port_state,
        load_data as port_load,
    )
    from gmrm_tpu_torch.sampler.gibbs import gibbs_iteration
    from gmrm_tpu_torch.sampler.whole_sweep import WholeSweepIteration

    opt = PortOptions(bed_file=sim_medium.bed, dim_file=sim_medium.dim,
                      phen_files=sim_medium.phens,
                      group_index_file=sim_medium.gri,
                      group_mixture_file=sim_medium.grm, iterations=3,
                      seed=5, block_size=block, wave_size=wave)
    opt.validate()
    opt.load_group_mixtures()
    data = port_load(opt)
    static = port_static(data, opt, "cpu")
    eager = port_state(data, opt, "cpu")
    step = WholeSweepIteration(port_state(data, opt, "cpu"), static,
                               dists.RngPlan(opt.seed, "cpu"),
                               block_size=block, wave=wave)
    rng = dists.RngPlan(opt.seed, "cpu")
    for it in (1, 2, 3):
        eager, want = gibbs_iteration(eager, static, it, rng,
                                      block_size=block, wave=wave)
        got_state, got = step(it)
        for name in ("eps", "betas", "comp", "acum", "cass", "sigmag",
                     "sigmae", "pi_est", "mu", "epssum"):
            assert torch.equal(getattr(got_state, name),
                               getattr(eager, name)), (it, name)
        assert torch.equal(got.m0, want.m0) and torch.equal(got.e_sqn,
                                                            want.e_sqn)
    assert (eager.comp != 0).any()
