"""Any number of mixture components (K > 16) on the port's single-device
float32 paths, against the JAX package on the CPU.

The port's CUDA kernels take any K: past 16 components the wave draw of
kernels 3, 7/8 and 9 walks K with no register array of it
(csrc/sweep_math.cuh ``gmrm_wave_draw_any``) and kernel 6 gives a trait
all 32 lanes of its scanning warp (csrc/serial_scan.cu
``scan_step_any``); their plain versions, which run here, take any K as
they did.  One sweep at K = 17, 33 and 65 (a .grm of K strictly
ascending variances, two groups, one with sigmaG = 0), with injected
block order, row order, u and z, through the port's ``marker_sweep``
against the JAX package's ``marker_sweep`` of the same path:

- W > 1, the whole-sweep path (kernels 7/8) against the JAX whole-sweep
  Pallas kernel (``megakernel=True``), in interpret mode;
- W > 1, the composed path (``megakernel=False``: kernel 3 per block)
  against the JAX composed sweep, its wave kernel in interpret mode;
- W = 1, the exact serial path (kernel 6) against the JAX package's
  Pallas serial scan (interpret mode, as the CPU resolves it).

comp and cass exact; beta, acum and eps within
tests/test_sweep_equivalence.py:119-132.  chip_smoke.py phase 11 holds
the kernels to these plain versions on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmrm_tpu.ops.pallas_kernels as jpk
import gmrm_tpu.ops.scan_kernel_wave as jskw
import gmrm_tpu.ops.sweep_kernel as jswk
from gmrm_tpu.config import Options as JaxOptions
from gmrm_tpu.io.sim import simulate
from gmrm_tpu.runner import build_static, init_sampler_state, load_data
from gmrm_tpu.sampler import gibbs as jgibbs
from gmrm_tpu_torch.sampler.gibbs import marker_sweep
from gmrm_tpu_torch.sampler.state import state_from_numpy, static_from_numpy

torch.set_num_threads(2)

KS = (17, 33, 65)
# tests/test_sweep_equivalence.py:119-132
BETA_TOL = dict(rtol=2e-3, atol=2e-4)
ACUM_TOL = dict(rtol=5e-3, atol=5e-4)
EPS_TOL = dict(rtol=5e-3, atol=2e-3)


def mixtures(K):
    """K strictly ascending variances: 0, then K - 1 log-spaced from 1e-4
    to 5e-2, so that the draws reach the top components."""
    return np.concatenate([[0.0], np.logspace(-4, np.log10(5e-2), K - 1)])


def any_k_setup(tmp, K, wave, dtype="float32", na_rate=0.02, m=120,
                n_traits=2, B=32):
    """A JAX plan of m markers in blocks of B with a K-column .grm (two
    groups) at the wave and dtype asked: (opt, data, static, state)."""
    sim = simulate(tmp, n=300, m=m, n_traits=n_traits, n_causal=m // 4,
                   h2=0.5, n_groups=2, na_rate=na_rate, seed=1700 + K,
                   mixtures=mixtures(K))
    opt = JaxOptions(bed_file=sim.bed, dim_file=sim.dim,
                     phen_files=sim.phens, group_index_file=sim.gri,
                     group_mixture_file=sim.grm, iterations=1, seed=3,
                     block_size=B, wave_size=wave, use_pallas=True,
                     dtype=dtype, output_thin_rate=10 ** 9)
    opt.validate()
    opt.load_group_mixtures()
    assert opt.cva.shape[1] == K
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    data = load_data(opt)
    return opt, data, build_static(data, opt, jdt), init_sampler_state(
        data, opt, jdt)


def leaves(x):
    return {k: (None if v is None else np.asarray(v))
            for k, v in vars(x).items() if k != "key"}


def sweep_inputs(data, static, state, seed, block_mode, fdt=np.float32,
                 B=32):
    """Injected order and draws, a start state with betas off zero and an
    adaV group (trait 1, group 0): (blocks, pi_b, win, u, z, eps, sigmae,
    betas, sigmag)."""
    T, m_pad = state.betas.shape
    nblocks = m_pad // B
    rng = np.random.default_rng(seed)
    if block_mode:
        pi_b = rng.permutation(nblocks).astype(np.int32)
        win = np.argsort(rng.uniform(size=(nblocks, B)),
                         axis=1).astype(np.int32)
        blocks = (pi_b[:, None] * B + win).astype(np.int32)
    else:
        pi_b = win = None
        blocks = np.concatenate([rng.permutation(data.m_local),
                                 np.arange(data.m_local, m_pad)]).reshape(
            nblocks, B).astype(np.int32)
    u = rng.uniform(size=(nblocks, T, B)).astype(fdt)
    z = rng.normal(size=(nblocks, T, B)).astype(fdt)
    eps = np.asarray(state.eps)
    sigmae = (0.5 * (eps.astype(np.float64) ** 2).sum(axis=(1, 2))
              / np.asarray(static.nonas)).astype(fdt)
    betas = (rng.normal(size=(T, m_pad)) * 0.02).astype(fdt)
    sigmag = np.asarray(state.sigmag).copy()
    sigmag[1, 0] = 0.0
    return blocks, pi_b, win, u, z, eps, sigmae, betas, sigmag


def port_sweep(data, static, state, inputs, wave, megakernel=None):
    blocks, _, _, u, z, eps, sigmae, betas, sigmag = inputs
    dev = torch.device("cpu")
    ts = dataclasses.replace(
        static_from_numpy(leaves(static), dev),
        shared_na=all(ph.nas == 0 for ph in data.phens))
    st = state_from_numpy(leaves(state), dev)
    got = marker_sweep(
        torch.from_numpy(eps.copy()), torch.from_numpy(betas), st.comp,
        st.acum, torch.from_numpy(sigmag), torch.from_numpy(sigmae),
        st.pi_est, ts, torch.from_numpy(blocks), torch.from_numpy(u),
        torch.from_numpy(z), wave=wave, megakernel=megakernel)
    return [x.numpy() for x in got]


def assert_sweeps_agree(got, want, m_local, K, beta_tol=BETA_TOL,
                        acum_tol=ACUM_TOL, eps_tol=EPS_TOL):
    """comp and cass exact, the rest within the tolerances; the draws
    leave component 0 and reach a component past the sixteenth (index 16
    or more)."""
    g_eps, g_beta, g_comp, g_acum, g_cass = got
    w_eps, w_beta, w_comp, w_acum, w_cass = (np.asarray(x) for x in want)
    assert g_cass.shape[-1] == K
    assert (g_comp[:, :m_local] != 0).any()
    assert g_comp.max() >= 16
    np.testing.assert_array_equal(g_comp, w_comp)
    np.testing.assert_array_equal(g_cass, w_cass)
    np.testing.assert_allclose(g_beta, w_beta, **beta_tol)
    np.testing.assert_allclose(g_acum, w_acum, **acum_tol)
    np.testing.assert_allclose(g_eps, w_eps, **eps_tol)


@pytest.mark.parametrize("path", ["whole-sweep", "composed", "W=1"])
@pytest.mark.parametrize("K", KS)
def test_sweep_at_any_k_matches_jax(tmp_path, monkeypatch, K, path):
    """One sweep of 4 blocks of 32 (8 pad slots, 2% phenotype NAs, so a
    mask a trait; two waves of 16 a block at W > 1) at K components
    through the port's path against the JAX package's, same order and
    draws."""
    for mod in (jpk, jskw, jswk):
        monkeypatch.setattr(mod, "FORCE_INTERPRET", True)
    wave = 1 if path == "W=1" else 16
    opt, data, static, state = any_k_setup(str(tmp_path), K, wave)
    block_mode = wave > 1
    inputs = sweep_inputs(data, static, state, 4000 + K, block_mode)
    blocks, pi_b, win, u, z, eps, sigmae, betas, sigmag = inputs
    kw = dict(use_pallas=True, wave_size=wave,
              shared_na=all(ph.nas == 0 for ph in data.phens))
    if block_mode:
        assert static.gram_cache is not None
        kw.update(pallas_upd=True, megakernel=path == "whole-sweep",
                  block_perm=(jnp.asarray(pi_b), jnp.asarray(win)))
    want = jax.device_get(jgibbs.marker_sweep(
        jnp.asarray(eps), jnp.asarray(betas), state.comp, state.acum,
        jnp.asarray(sigmag), jnp.asarray(sigmae), state.pi_est, static,
        jnp.asarray(blocks), jnp.asarray(u), jnp.asarray(z), **kw))
    got = port_sweep(data, static, state, inputs, wave,
                     megakernel=False if path == "composed" else None)
    assert_sweeps_agree(got, want, data.m_local, K)
