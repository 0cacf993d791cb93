"""More than 256 annotation groups: the port against the JAX package at
G = 300, on the CPU.

The JAX package's fused Pallas kernels carry group ids through bf16
one-hot permutes, so it runs such a ``.grm`` only with ``--use-pallas 0``
(gmrm_tpu/config.py:157-167); the port has no such ceiling.  Here it is
held to the JAX package's XLA path:

- one sweep with injected order and draws, at W=1 (a uniform order)
  against ``marker_sweep(use_pallas=False)``, and at W=8 in block mode
  (the port's whole-sweep path from its Gram cache, and its composed path)
  against the JAX XLA Gram and update around the float32
  ``wave_reference`` scan (tests/test_torch_float64_wave.py: the JAX XLA
  ``block_scan`` wave by wave), the JAX side taking the port's block order
  and row order as its ``block_perm``;
- three whole iterations in lockstep at W=1 (test_torch_chain_lockstep);
- the port's command line on the 300-group ``.grm`` without
  ``--use-pallas 0``, which the JAX package's options refuse.

Tolerances: comp and cass exact; betas, eps and acum as
tests/test_sweep_kernel.py:57-66.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmrm_tpu.ops.scan_kernel_wave as skw
from gmrm_tpu.config import OptionsError
from gmrm_tpu.io.sim import simulate
from gmrm_tpu.runner import build_static, init_sampler_state, load_data
from gmrm_tpu.sampler import gibbs as jgibbs
from gmrm_tpu_torch import cli
from gmrm_tpu_torch.io.writers import read_history
from gmrm_tpu_torch.ops.sweep_kernel import build_gram_cache
from gmrm_tpu_torch.sampler.gibbs import marker_sweep
from gmrm_tpu_torch.sampler.state import state_from_numpy, static_from_numpy
from test_torch_chain_lockstep import PATHS, jax_options, run_lockstep
from test_torch_float64_wave import wave_reference
import torch_chain_script as cs

torch.set_num_threads(2)

CPU = torch.device("cpu")
B = 32
G = 300


@pytest.fixture(scope="module")
def groups_sim(tmp_path_factory):
    """1,216 markers (38 blocks of 32) in 300 groups of 4 or 5, 2 traits
    with 2% NAs, K = 4."""
    return simulate(str(tmp_path_factory.mktemp("groups300")), n=400,
                    m=1_216, n_traits=2, n_causal=300, h2=0.5,
                    n_groups=G, na_rate=0.02, seed=31,
                    mixtures=np.array([0.0, 0.001, 0.01, 0.05]))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    (g_eps, g_beta, g_comp, g_acum, g_cass) = got
    (w_eps, w_beta, w_comp, w_acum, w_cass) = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(g_comp, w_comp)
    np.testing.assert_array_equal(g_cass, w_cass)
    np.testing.assert_allclose(g_beta, w_beta, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g_eps, w_eps, rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(g_acum, w_acum, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("wave, mega", [(1, None), (8, None), (8, False)],
                         ids=["W1", "W8", "W8_composed"])
def test_sweep_at_300_groups_matches_jax_xla(groups_sim, wave, mega,
                                             monkeypatch):
    monkeypatch.setattr(skw, "make_block_scan_wave", wave_reference)
    opt = jax_options(groups_sim, 1, False, "float32")
    assert opt.n_groups == G
    data = load_data(opt)
    static = build_static(data, opt, jnp.float32)
    state = init_sampler_state(data, opt, jnp.float32)
    T, m_pad = state.betas.shape
    nblocks = m_pad // B
    rng = np.random.default_rng(300 + wave)
    if wave > 1:
        pi_b = rng.permutation(nblocks).astype(np.int32)
        win = np.argsort(rng.uniform(size=(nblocks, B)),
                         axis=1).astype(np.int32)
        blocks = pi_b[:, None] * B + win
        jkw = dict(use_pallas=True, pallas_gram=False, wave_size=wave,
                   block_perm=(jnp.asarray(pi_b), jnp.asarray(win)))
    else:
        blocks = np.concatenate([rng.permutation(data.m_local),
                                 np.arange(data.m_local, m_pad)]
                                ).reshape(nblocks, B).astype(np.int32)
        jkw = dict(use_pallas=False)
    u = rng.uniform(size=(nblocks, T, B)).astype(np.float32)
    z = rng.normal(size=(nblocks, T, B)).astype(np.float32)
    eps = np.asarray(state.eps)
    sigmae = (0.5 * (eps.astype(np.float64) ** 2).sum(axis=(1, 2))
              / np.asarray(static.nonas)).astype(np.float32)
    betas = (rng.normal(size=(T, m_pad)) * 0.02).astype(np.float32)
    sigmag = np.asarray(state.sigmag).copy()
    sigmag[1, ::7] = 0.0                                 # adaV groups

    want = jgibbs.marker_sweep(
        jnp.asarray(eps), jnp.asarray(betas), state.comp, state.acum,
        jnp.asarray(sigmag), jnp.asarray(sigmae), state.pi_est, static,
        jnp.asarray(blocks), jnp.asarray(u), jnp.asarray(z), **jkw)

    tstatic = static_from_numpy(cs.leaves(static), CPU)
    if wave > 1:
        tstatic = dataclasses.replace(tstatic, gram_cache=build_gram_cache(
            tstatic.bed, tstatic.na, block_size=B, shared_na=False))
    tstate = state_from_numpy(cs.leaves(state), CPU)
    got = marker_sweep(_t(eps), _t(betas), tstate.comp, tstate.acum,
                       _t(sigmag), _t(sigmae), tstate.pi_est, tstatic,
                       _t(blocks.astype(np.int64)), _t(u), _t(z), wave=wave,
                       megakernel=mega)
    got = [x.numpy() for x in got]
    assert got[4].shape == (T, G, 4)
    assert (got[2][:, :data.m_local] != 0).any()
    _close(got, want)


def test_whole_iterations_at_300_groups(groups_sim, monkeypatch, tmp_path):
    """Three whole W=1 iterations in lockstep with the JAX XLA iteration."""
    run_lockstep(groups_sim, PATHS["w1_xla"], monkeypatch, tmp_path,
                 iters=3)


def test_cli_takes_300_groups_without_use_pallas_0(groups_sim, tmp_path):
    """The JAX package's options refuse the .grm with its Pallas kernels
    on; the port's command line trains on it with its defaults (W=1 and,
    with --wave-size 8, the whole-sweep path) and writes finite
    histories."""
    jopt = jax_options(groups_sim, 8, True, "float32")
    with pytest.raises(OptionsError, match="256 annotation groups"):
        jopt.check_group_limit()
    base = ["--bed-file", groups_sim.bed, "--dim-file", groups_sim.dim,
            "--phen-files", ",".join(groups_sim.phens),
            "--group-index-file", groups_sim.gri,
            "--group-mixture-file", groups_sim.grm, "--block-size", str(B),
            "--iterations", "3", "--seed", "5", "--verbosity", "-1"]
    for extra in ([], ["--wave-size", "8"]):
        out = str(tmp_path / f"out{len(extra)}")
        assert cli.main(base + extra + ["--out-dir", out],
                        device="cpu") == 0
        its, bet = read_history(os.path.join(out, "test1.bet"), "f8")
        assert list(its) == [1, 2, 3] and np.isfinite(bet).all()
        assert bet.shape[1] == groups_sim.m and (bet != 0).any()
        with open(os.path.join(out, "test1.csv")) as fh:
            row = fh.readline().split(",")
        assert int(row[1]) == G
