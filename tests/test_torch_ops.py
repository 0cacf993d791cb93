"""The port's decode, marker statistics and kernels (plain PyTorch versions
on CPU) against the JAX package on the same NumPy inputs.

The JAX Pallas kernels run in interpret mode on the CPU, as the JAX
package's own tests run them.  The CUDA kernels themselves are checked
against these plain versions on the card by chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import gmrm_tpu.ops.pallas_kernels as pk
import gmrm_tpu.ops.scan_kernel_wave as skw
import gmrm_tpu.ops.sweep_kernel as swk
from gmrm_tpu.ops.blockops import marker_stats_jax
from gmrm_tpu.ops.decode import decode_planes_jax
from gmrm_tpu_torch.ops.block_kernels import block_cdot, block_eps_update_
from gmrm_tpu_torch.ops.blockops import marker_stats
from gmrm_tpu_torch.ops.decode import (
    decode_planes, from_phase_planes, to_phase_planes,
)
from gmrm_tpu_torch.ops.sweep_kernel import build_gram_cache
from gmrm_tpu_torch.sampler.scan import block_scan_wave

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_decode_planes_matches_jax():
    """All 256 byte values, plus the phase-plane round trip."""
    bed = np.arange(256, dtype=np.uint8).reshape(4, 64)
    a, b = decode_planes(_t(bed))
    aj, bj = decode_planes_jax(jnp.asarray(bed))
    np.testing.assert_array_equal(a.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(b.numpy(), np.asarray(bj))
    v = np.random.default_rng(0).normal(size=(3, 40))
    np.testing.assert_array_equal(from_phase_planes(to_phase_planes(v)), v)


@pytest.mark.parametrize("with_nas", [False, True])
def test_marker_stats_matches_jax(with_nas):
    rng = np.random.default_rng(5 + with_nas)
    T, M, mb = 3, 70, 96
    bed = rng.integers(0, 256, size=(M, mb), dtype=np.uint8)
    na = np.ones((T, 4, mb), np.float32)
    if with_nas:
        na *= rng.uniform(size=(T, 4, mb)) > 0.05
    nonas = na.reshape(T, -1).sum(1).astype(np.float32)
    mave, msig = marker_stats(_t(bed), _t(na), _t(nonas), chunk=32)
    mj, sj = marker_stats_jax(jnp.asarray(bed), jnp.asarray(na),
                              jnp.asarray(nonas), chunk=32)
    np.testing.assert_allclose(mave.numpy(), np.asarray(mj), rtol=1e-6)
    np.testing.assert_allclose(msig.numpy(), np.asarray(sj), rtol=1e-6)


@pytest.mark.parametrize("shared_na", [True, False])
def test_gram_cache_bit_equal(shared_na, monkeypatch):
    """NT = 1 (shared NA mask) and NT = T: bit-equal to build_gram_cache."""
    monkeypatch.setattr(swk, "FORCE_INTERPRET", True)
    rng = np.random.default_rng(11 + shared_na)
    T, B, nblocks, mb = 2, 16, 3, 512
    bed = rng.integers(0, 256, size=(nblocks * B, mb), dtype=np.uint8)
    bed[-3:] = 0x55                                        # pad rows
    na = np.ones((T, 4, mb), np.float32)
    if not shared_na:
        na *= rng.uniform(size=(T, 4, mb)) > 0.1
    got = build_gram_cache(_t(bed), _t(na), block_size=B,
                           shared_na=shared_na)
    want = swk.build_gram_cache(jnp.asarray(bed), jnp.asarray(na),
                                block_size=B, shared_na=shared_na)
    assert got.shape == (nblocks, 1 if shared_na else T, 2 * B, 2 * B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _block_case(rng, T, B, mb, with_nas):
    """The inputs of tests/test_gram_kernel.py:26-36."""
    bed = rng.integers(0, 256, size=(B, mb), dtype=np.uint8)
    na = np.ones((T, 4, mb), np.float32)
    if with_nas:
        na *= (rng.uniform(size=(T, 4, mb)) > 0.03)
    eps = rng.normal(size=(T, 4, mb)).astype(np.float32) * na
    mave = rng.uniform(0.2, 1.8, size=(T, B)).astype(np.float32)
    msig = rng.uniform(0.5, 2.0, size=(T, B)).astype(np.float32)
    return bed, eps, na, mave, msig


# Tolerance: the JAX kernels carry eps and d as bf16 hi/lo pairs, about
# 2^-17 relative; the port's sums are plain float32.
@pytest.mark.parametrize("mb", [300, 700, 512])
def test_block_cdot_matches_pallas(mb, monkeypatch):
    monkeypatch.setattr(pk, "FORCE_INTERPRET", True)
    rng = np.random.default_rng(mb)
    T, B = 3, 32
    bed, eps, _, mave, msig = _block_case(rng, T, B, mb, with_nas=True)
    # Processing order through row indices into a larger bed.
    win = rng.permutation(B).astype(np.int32)
    full = np.concatenate([rng.integers(0, 256, (B, mb), np.uint8), bed])
    got = block_cdot(_t(full), _t(B + win), _t(eps), _t(mave[:, win]),
                     _t(msig[:, win]))
    want = pk.block_cdot_pallas(jnp.asarray(bed[win]), jnp.asarray(eps),
                                jnp.asarray(mave[:, win]),
                                jnp.asarray(msig[:, win]), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("mb", [300, 700])
def test_block_eps_update_matches_pallas(mb, monkeypatch):
    monkeypatch.setattr(pk, "FORCE_INTERPRET", True)
    rng = np.random.default_rng(mb + 1)
    T, B = 3, 32
    bed, eps, na, mave, _ = _block_case(rng, T, B, mb, with_nas=True)
    d = (rng.normal(size=(T, B))
         * (rng.uniform(size=(T, B)) > 0.5)).astype(np.float32)
    rows = np.arange(B, dtype=np.int32)
    out = block_eps_update_(_t(bed), _t(rows), _t(d), _t(mave), _t(na),
                            _t(eps.copy()))
    deps = pk.block_eps_update_pallas(jnp.asarray(bed), jnp.asarray(d),
                                      jnp.asarray(na), jnp.asarray(mave),
                                      interpret=True)
    np.testing.assert_allclose(out.numpy() - eps, np.asarray(deps),
                               rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("wave", [8, 32])
def test_block_scan_wave_matches_pallas(wave, monkeypatch):
    """A group with sigmaG == 0 (adaV) and pad markers included."""
    monkeypatch.setattr(skw, "FORCE_INTERPRET", True)
    rng = np.random.default_rng(100 + wave)
    T, B, G, K = 2, 64, 3, 4
    cva = np.tile([0.0, 1e-3, 1e-2, 5e-2], (G, 1))
    cvai = np.zeros_like(cva)
    cvai[:, 1:] = 1.0 / cva[:, 1:]
    n_total = 500.0
    nonas = np.array([490.0, 480.0])
    grp = rng.integers(0, G, size=B).astype(np.int32)
    valid = np.arange(B) < B - 5
    sigmag = rng.uniform(0.1, 0.5, size=(T, G))
    sigmag[0, 1] = 0.0
    sigmae = np.array([0.6, 0.8])
    pi = rng.dirichlet(np.ones(K), size=(T, G))
    x = rng.normal(size=(B, 600))
    gs = np.stack([x @ x.T] * T) * rng.uniform(0.8, 1.2, (T, 1, 1))
    c = rng.normal(size=(T, B)) * 30.0
    beta_old = rng.normal(size=(T, B)) * 0.05 * (rng.uniform(size=(T, B))
                                                 > 0.5)
    comp_old = rng.integers(0, K, size=(T, B)).astype(np.int32)
    acum_old = rng.uniform(size=(T, B))
    u = rng.uniform(size=(T, B))
    z = rng.normal(size=(T, B))
    args = (c, gs, beta_old, comp_old, acum_old, grp, valid, u, z, sigmag,
            sigmae, pi, cva, cvai, nonas, n_total)
    f32 = [a.astype(np.float32) if isinstance(a, np.ndarray)
           and a.dtype == np.float64 else a for a in args]
    got = block_scan_wave(*[_t(a) if isinstance(a, np.ndarray)
                            else torch.tensor(a) for a in f32], wave=wave)
    want = skw.make_block_scan_wave(wave)(
        *[jnp.asarray(a) for a in f32], interpret=True)
    live = valid[None, :] & (sigmag[:, grp] != 0)
    assert len(np.unique(got.comp_new.numpy()[live])) > 1
    np.testing.assert_array_equal(got.comp_new.numpy(),
                                  np.asarray(want.comp_new))
    np.testing.assert_array_equal(got.cass_inc.numpy(),
                                  np.asarray(want.cass_inc))
    for name in ("dbeta_eff", "beta_new", "acum_new"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
