"""Any number of mixture components (K > 16) on the port's marker-sharded
W > 1 sweep (kernel 9 on the card), against the JAX package's fused
sharded sweep on the CPU.

One sweep of 2 shards at K = 17, 33 and 65 (98 markers, a .grm of K
strictly ascending variances, two groups) through the port's
``marker_sweep_sharded`` against the JAX package's
``marker_sweep(fused=True)`` under ``shard_map`` on two virtual devices,
its block-step Pallas kernel in interpret mode, from the same global
arrays, per-shard Gram caches, block and row orders and draws
(tests/test_torch_sharded.py's construction).  comp and cass exact; beta,
acum and eps within tests/test_sweep_equivalence.py:119-132.
chip_smoke.py phase 11 holds kernel 9 to this plain version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import gmrm_tpu.ops.sweep_kernel as jswk
from gmrm_tpu.io.sim import simulate
from gmrm_tpu.parallel import mesh as jmesh
from gmrm_tpu.parallel.runner import _static_specs
from gmrm_tpu.sampler import gibbs as jgibbs
from gmrm_tpu.sampler.state import StaticInputs as JaxStatic
from gmrm_tpu.sampler.state import pi_prior_from_cva
from test_torch_any_k import ACUM_TOL, BETA_TOL, EPS_TOL, KS, mixtures
from test_torch_sharded import _global_inputs, _interpret, _port_sharded_sweep


@pytest.mark.parametrize("K", KS)
def test_sharded_sweep_at_any_k_matches_jax(tmp_path, monkeypatch, K):
    """Two shards of 49 markers, blocks of 16, W = 8, at K components."""
    _interpret(monkeypatch)
    D, B, W = 2, 16, 8
    sim = simulate(str(tmp_path), n=402, m=98, n_traits=1, n_causal=24,
                   h2=0.5, n_groups=2, na_rate=0.03, seed=1900 + K,
                   mixtures=mixtures(K))
    g = _global_inputs(sim, D, B, mb_pad=512)
    assert g["cva"].shape[1] == K
    mps = g["mps"]
    nblocks = mps // B
    mesh = jmesh.make_marker_mesh(D)
    axis = jmesh.MARKER_AXIS
    f32 = jnp.float32
    lv = g["leaves"]
    cache_fn = jax.jit(jax.shard_map(
        lambda bb, nn: jswk.build_gram_cache(bb, nn, block_size=B,
                                             shared_na=True),
        mesh=mesh, in_specs=(P(axis), P()), out_specs=P(axis),
        check_vma=False))
    gram_cache = cache_fn(jnp.asarray(lv["bed"]), jnp.asarray(lv["na"]))
    static = JaxStatic(gram_cache=gram_cache,
                       **{k: jnp.asarray(v) for k, v in lv.items()})

    rng = np.random.default_rng(2100 + K)
    pi_b = np.stack([rng.permutation(nblocks) for _ in range(D)])
    win = np.stack([np.stack([rng.permutation(B) for _ in range(nblocks)])
                    for _ in range(D)])
    perm = pi_b[:, :, None] * B + win                   # (D, nblocks, B)
    u = rng.uniform(size=(D, nblocks, 1, B)).astype(np.float32)
    z = rng.normal(size=(D, nblocks, 1, B)).astype(np.float32)
    sigmag0 = rng.uniform(0.05, 0.5, size=g["cva"].shape[0])

    def sweep(eps, betas, comp, acum, sigmag, sigmae, pi_est, static,
              blocks, u_all, z_all, pi_b_d, win_d):
        eps, betas, comp, acum, cass_local = jgibbs.marker_sweep(
            eps, betas, comp, acum, sigmag, sigmae, pi_est, static, blocks,
            u_all, z_all, axis_name=axis, use_pallas=True, shared_na=True,
            wave_size=W, block_perm=(pi_b_d, win_d), fused=True)
        return eps, betas, comp, acum, jax.lax.psum(cass_local, axis)

    sh, sh2, rep = P(axis), P(None, axis), P()
    sweep_sh = jax.jit(jax.shard_map(
        sweep, mesh=mesh,
        in_specs=(rep, sh2, sh2, sh2, rep, rep, rep, _static_specs(True),
                  sh, sh, sh, sh, sh),
        out_specs=(rep, sh2, sh2, sh2, rep), check_vma=False))
    want = jax.device_get(sweep_sh(
        jnp.asarray(g["eps0"]), jnp.zeros((1, D * mps), f32),
        jnp.zeros((1, D * mps), jnp.int32), jnp.zeros((1, D * mps), f32),
        jnp.asarray(sigmag0[None], f32), jnp.asarray([0.6], f32),
        jnp.asarray(pi_prior_from_cva(g["cva"])[None], f32), static,
        jnp.asarray(perm.reshape(D * nblocks, B).astype(np.int32)),
        jnp.asarray(u.reshape(D * nblocks, 1, B)),
        jnp.asarray(z.reshape(D * nblocks, 1, B)),
        jnp.asarray(pi_b.reshape(-1).astype(np.int32)),
        jnp.asarray(win.reshape(D * nblocks, B).astype(np.int32))))

    leaves = dict(lv, gram_cache=np.asarray(gram_cache), shared_na=True)
    got = _port_sharded_sweep(g, D, leaves, perm, u, z, sigmag0, W)
    assert got[4].shape[-1] == K
    assert got[2].max() >= 16
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    np.testing.assert_array_equal(got[4], np.asarray(want[4]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), **BETA_TOL)
    np.testing.assert_allclose(got[3], np.asarray(want[3]), **ACUM_TOL)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **EPS_TOL)
