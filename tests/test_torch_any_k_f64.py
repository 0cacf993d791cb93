"""Any number of mixture components (K > 16) on the port's float64 paths
(kernels C and E on the card), against the JAX package's float64 sweeps
on the CPU.

One sweep at K = 17, 33 and 65 (tests/test_torch_any_k.py's dataset and
draws, float64) through the port's ``marker_sweep`` against the JAX
package's float64 ``marker_sweep`` under ``jax.enable_x64``:

- W = 1 against its XLA sweep (the JAX package's float64 W=1 path);
- W = 16 against its wave sweep with the wave scan patched to the
  float64 reference of tests/test_torch_float64_wave.py (the JAX wave
  kernel narrows a float64 run to float32, which the port does not).

comp and cass exact; beta, acum and eps within rtol 1e-9, atol 1e-11
(tests/test_torch_float64.py).  chip_smoke.py phase 11 holds kernels C
and E to these plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gmrm_tpu.ops.scan_kernel_wave as skw
from gmrm_tpu.sampler import gibbs as jgibbs
from test_torch_any_k import (
    KS, any_k_setup, assert_sweeps_agree, port_sweep, sweep_inputs,
)
from test_torch_float64_wave import wave_reference

F64_TOL = dict(rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("wave", [1, 16])
@pytest.mark.parametrize("K", KS)
def test_f64_sweep_at_any_k_matches_jax(tmp_path, monkeypatch, K, wave):
    """One float64 sweep of 4 blocks of 32 at K components (W = 1: a
    uniform order, the pad slots last, as the float64 W > 1 path also
    draws) against the JAX package's float64 sweep of that wave, same order
    and draws."""
    monkeypatch.setattr(skw, "make_block_scan_wave", wave_reference)
    with jax.enable_x64(True):
        opt, data, static, state = any_k_setup(str(tmp_path), K, wave,
                                               dtype="float64")
        assert static.gram_cache is None
        inputs = sweep_inputs(data, static, state, 5000 + K, False,
                              np.float64)
        blocks, _, _, u, z, eps, sigmae, betas, sigmag = inputs
        want = jax.device_get(jgibbs.marker_sweep(
            jnp.asarray(eps), jnp.asarray(betas), state.comp, state.acum,
            jnp.asarray(sigmag), jnp.asarray(sigmae), state.pi_est, static,
            jnp.asarray(blocks), jnp.asarray(u), jnp.asarray(z),
            use_pallas=wave > 1, wave_size=wave,
            shared_na=all(ph.nas == 0 for ph in data.phens)))
    assert np.asarray(want[0]).dtype == np.float64
    got = port_sweep(data, static, state, inputs, wave)
    assert got[0].dtype == got[1].dtype == np.float64
    assert_sweeps_agree(got, want, data.m_local, K, F64_TOL, F64_TOL,
                        F64_TOL)
