"""The port's float64 path (``--dtype float64``: the exact serial W=1
sweep, on one device and marker-sharded, and predict) against the JAX
package's float64 functions and the float64 oracle, on the CPU.

The JAX side runs inside ``jax.enable_x64(True)``, which is scoped to the
block; the JAX command line at float64, which turns x64 on for its whole
process (gmrm_tpu/cli.py:107-110), runs in a subprocess.  The port is held
to the JAX package's XLA sweep (``use_pallas=False``), the path its
float64 run takes: its Pallas scans narrow a float64 chain to float32.
On the CPU every wrapper takes its plain float64 version; chip_smoke.py
holds kernels A-D against those versions on the card.

Tolerances: comp and cass exact; betas, acum and eps within rtol 1e-9,
atol 1e-11: both sides are float64 and take their sums (at most 4 mb
terms) in other orders.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmrm_tpu import oracle
from gmrm_tpu.config import Options as JaxOptions
from gmrm_tpu.io.sim import simulate
from gmrm_tpu.ops.blockops import _block_gram_wide, block_eps_update
from gmrm_tpu.predict import _chunked_predict_sums
from gmrm_tpu.runner import build_static as jax_build_static
from gmrm_tpu.runner import init_sampler_state as jax_init_state
from gmrm_tpu.runner import load_data as jax_load_data
from gmrm_tpu.sampler import gibbs as jgibbs
from gmrm_tpu.sampler.scan import block_scan as jax_block_scan
from gmrm_tpu_torch import checkpoint, cli
from gmrm_tpu_torch import runner as trunner
from gmrm_tpu_torch.config import Options, resolve_plan
from gmrm_tpu_torch.io.writers import read_history
from gmrm_tpu_torch.ops.block_gram import (
    block_gram_scaled, blocks_gram_scaled, gram_run_blocks,
)
from gmrm_tpu_torch.ops.block_kernels import (
    BlockPasses, block_cdot, block_eps_update_, block_update_cdot_,
)
from gmrm_tpu_torch.ops.decode import (
    decode_planes, from_phase_planes, to_phase_planes,
)
from gmrm_tpu_torch.ops.predict_sums import predict_sums
from gmrm_tpu_torch.parallel.distributed import Communicator
from gmrm_tpu_torch.parallel.runner import run_training_sharded
from gmrm_tpu_torch.sampler import dists
from gmrm_tpu_torch.sampler import gibbs as tgibbs
from gmrm_tpu_torch.sampler.gibbs import (
    hyper_block, marker_sweep, marker_sweep_sharded,
)
from gmrm_tpu_torch.sampler.scan import block_scan
from gmrm_tpu_torch.sampler.state import (
    pi_prior_from_cva, state_from_numpy, static_from_numpy,
)
from test_scan_kernel import _random_case
from test_sweep_equivalence import _setup
from test_torch_predict import _parse as mlma_fields
from test_torch_sharded import _gather, _global_inputs

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CPU = torch.device("cpu")
F64 = torch.float64
RTOL, ATOL = 1e-9, 1e-11


def _t(x):
    return torch.from_numpy(np.array(x))


def _leaves(x):
    return {k: (None if v is None else np.asarray(v))
            for k, v in vars(x).items() if k != "key"}


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


# --------------------------------------------------------------------------
# The W=1 sweep
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[0.02, 0.0], ids=["na", "no_na"])
def setup64(request, tmp_path_factory):
    """tests/test_torch_serial.py's serial_setup at float64: 120 markers in
    4 blocks of 32, the JAX package's float64 static inputs and state."""
    out = str(tmp_path_factory.mktemp("f64"))
    sim = simulate(out, n=600, m=120, n_traits=2, n_causal=32, h2=0.5,
                   n_groups=2, na_rate=request.param, seed=11)
    opt = JaxOptions(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                     group_index_file=sim.gri, group_mixture_file=sim.grm,
                     iterations=1, seed=3, block_size=32, wave_size=1,
                     use_pallas=False, dtype="float64",
                     output_thin_rate=10 ** 9)
    opt.validate()
    opt.load_group_mixtures()
    with jax.enable_x64(True):
        data = jax_load_data(opt)
        static = jax_build_static(data, opt, jnp.float64)
        state = jax_init_state(data, opt, jnp.float64)
    assert static.gram_cache is None and state.eps.dtype == jnp.float64
    return opt, data, static, state


def _sweep_inputs(data, static, state, seed):
    B = 32
    T, m_pad = state.betas.shape
    nblocks = m_pad // B
    rng = np.random.default_rng(seed)
    perm = np.concatenate([rng.permutation(data.m_local),
                           np.arange(data.m_local, m_pad)])
    blocks = perm.reshape(nblocks, B).astype(np.int32)
    u = rng.uniform(size=(nblocks, T, B))
    z = rng.normal(size=(nblocks, T, B))
    eps = np.asarray(state.eps)
    sigmae = 0.5 * (eps ** 2).sum(axis=(1, 2)) / np.asarray(static.nonas)
    betas = rng.normal(size=(T, m_pad)) * 0.02
    sigmag = np.asarray(state.sigmag).copy()
    sigmag[1, 0] = 0.0                                   # an adaV group
    return blocks, u, z, eps, sigmae, betas, sigmag


def test_sweep_matches_jax_xla_sweep_at_f64(setup64):
    """The port's float64 W=1 sweep against the JAX package's float64 XLA
    sweep, from its own float64 state, with the same order and draws."""
    opt, data, static, state = setup64
    shared_na = all(ph.nas == 0 for ph in data.phens)
    blocks, u, z, eps, sigmae, betas, sigmag = _sweep_inputs(
        data, static, state, 2025)
    with jax.enable_x64(True):
        want = jax.device_get(jgibbs.marker_sweep(
            jnp.asarray(eps), jnp.asarray(betas), state.comp, state.acum,
            jnp.asarray(sigmag), jnp.asarray(sigmae), state.pi_est, static,
            jnp.asarray(blocks), jnp.asarray(u), jnp.asarray(z),
            use_pallas=False, shared_na=shared_na, wave_size=1))
    assert want[0].dtype == np.float64
    tstate = state_from_numpy(_leaves(state), CPU)
    tstatic = dataclasses.replace(static_from_numpy(_leaves(static), CPU),
                                  shared_na=shared_na)
    assert tstatic.na.dtype == F64 and tstate.pi_est.dtype == F64
    got = marker_sweep(_t(eps.copy()), _t(betas), tstate.comp, tstate.acum,
                       _t(sigmag), _t(sigmae), tstate.pi_est, tstatic,
                       _t(blocks), _t(u), _t(z), wave=1)
    g_eps, g_beta, g_comp, g_acum, g_cass = (x.numpy() for x in got)
    assert g_eps.dtype == g_beta.dtype == g_acum.dtype == np.float64
    assert (g_comp[:, :data.m_local] != 0).any()
    w_eps, w_beta, w_comp, w_acum, w_cass = want
    np.testing.assert_array_equal(g_comp, np.asarray(w_comp))
    np.testing.assert_array_equal(g_cass, np.asarray(w_cass))
    _close(g_beta, w_beta, "betas")
    _close(g_acum, w_acum, "acum")
    _close(g_eps, w_eps, "eps")


def _static64(n, m, m_pad, napad, mave, msig, gidx, cva, cvai, nonas, bed):
    """Float64 static inputs of one trait from the oracle's statistics."""
    group_p = np.zeros(m_pad, np.int32)
    group_p[:m] = gidx
    return static_from_numpy(dict(
        bed=bed, na=to_phase_planes(napad)[None].astype(np.float64),
        mave=np.pad(mave, (0, m_pad - m))[None],
        msig=np.pad(msig, (0, m_pad - m))[None], group_of=group_p,
        mtotgrp=np.bincount(gidx, minlength=cva.shape[0]),
        nonas=np.asarray([float(nonas)]), cva=cva, cvai=cvai, n_total=n,
        m_local=m), CPU)


@pytest.mark.parametrize("block_size", [8, 32, 96])
def test_sweep_matches_serial_oracle_at_f64(sim_small, block_size):
    """Two float64 W=1 sweeps against oracle.sweep_serial, the float64
    per-marker recursion, with the same permutation and draws
    (tests/test_torch_serial.py's float32 test at float64 tolerances)."""
    (n, m, m_pad, B, a, b, napad, mave, msig, gidx, cva, cvai,
     ost, static, rng) = _setup(sim_small, block_size)
    tstatic = _static64(n, m, m_pad, napad, mave, msig, gidx, cva, cvai,
                        ost.nonas, np.asarray(static.bed))
    nblocks = m_pad // B
    eps = _t(to_phase_planes(ost.eps)[None].astype(np.float64))
    betas = torch.zeros((1, m_pad), dtype=F64)
    comp = torch.zeros((1, m_pad), dtype=torch.int32)
    acum = torch.zeros((1, m_pad), dtype=F64)
    for sweep in range(2):
        perm = rng.permutation(m)
        u = rng.uniform(size=m)
        z = rng.normal(size=m)
        oracle.sweep_serial(ost, a, b, napad, mave, msig, gidx, cva, cvai,
                            perm, u, z, n)
        blocks = np.concatenate([perm, np.arange(m, m_pad)])
        u_pad = np.zeros(m_pad)
        u_pad[:m] = u
        z_pad = np.zeros(m_pad)
        z_pad[:m] = z
        eps, betas, comp, acum, cass = marker_sweep(
            eps, betas, comp, acum, _t(ost.sigmag[None].astype(np.float64)),
            torch.tensor([ost.sigmae], dtype=F64), _t(ost.pi_est[None]),
            tstatic, _t(blocks.reshape(nblocks, B)),
            _t(u_pad.reshape(nblocks, 1, B)),
            _t(z_pad.reshape(nblocks, 1, B)), wave=1)
        msg = f"sweep {sweep}"
        np.testing.assert_array_equal(comp.numpy()[0, :m], ost.comp, msg)
        np.testing.assert_array_equal(cass.numpy()[0], ost.cass, msg)
        _close(betas.numpy()[0, :m], ost.betas, msg)
        _close(acum.numpy()[0, :m], ost.acum, msg)
        _close(from_phase_planes(eps.numpy())[0], ost.eps, msg)
        ost.cass[:] = 0


# --------------------------------------------------------------------------
# Each float64 plain version against its JAX float64 function
# --------------------------------------------------------------------------

def _block_case(rng, T, B, mb, nt):
    """A bed twice the block, rows in a random order, NA masks (per trait
    when nt > 1) and float64 eps, mave, msig."""
    bed = rng.integers(0, 256, size=(2 * B, mb), dtype=np.uint8)
    na = np.ones((T, 4, mb))
    if nt > 1:
        na *= rng.uniform(size=(T, 4, mb)) > 0.03
    eps = rng.normal(size=(T, 4, mb)) * na
    mave = rng.uniform(0.2, 1.8, size=(T, B))
    msig = rng.uniform(0.5, 2.0, size=(T, B))
    rows = rng.permutation(2 * B)[:B].astype(np.int32)
    return bed, rows, na, eps, mave, msig


@pytest.mark.parametrize("B, mb", [(32, 300), (192, 203)],
                         ids=["B32_mb300", "B192_mb203"])
@pytest.mark.parametrize("nt", [1, 3], ids=["shared_na", "per_trait_na"])
def test_gram_cdot_and_update_plain_match_jax_wide(nt, B, mb):
    """Kernels A and B's plain versions (the wrappers on CPU tensors)
    against the JAX package's float64 route: the scaled Gram and c from
    ``_block_gram_wide``, and ``block_eps_update(dtype=float64)``, also at
    the card's gate shapes B=192 (bands outside their tile) and mb=203
    (rows not on 16 bytes).  The port's Gram is the quadrant expression,
    JAX's a direct product: within 1e-11 of max|gs|."""
    rng = np.random.default_rng(41 + nt)
    T = 3
    bed, rows, na, eps, mave, msig = _block_case(rng, T, B, mb, nt)
    d = rng.normal(size=(T, B)) * 0.1
    with jax.enable_x64(True):
        craw, graw = _block_gram_wide(jnp.asarray(bed[rows]),
                                      jnp.asarray(eps), jnp.asarray(na),
                                      jnp.asarray(mave), dtype=jnp.float64)
        deps = block_eps_update(jnp.asarray(bed[rows]), jnp.asarray(d),
                                jnp.asarray(na), jnp.asarray(mave),
                                dtype=jnp.float64)
        craw, graw, deps = (np.asarray(x) for x in (craw, graw, deps))
    assert graw.dtype == np.float64
    want_c = msig * craw
    want_gs = msig[:, :, None] * msig[:, None, :] * graw
    na_in = _t(na[:1] if nt == 1 else na)
    c, gs = block_gram_scaled(_t(bed), _t(rows), _t(eps), na_in, _t(mave),
                              _t(msig))
    assert c.dtype == gs.dtype == F64
    np.testing.assert_allclose(c.numpy(), want_c, rtol=RTOL,
                               atol=1e-11 * np.abs(want_c).max())
    np.testing.assert_allclose(gs.numpy(), want_gs, rtol=RTOL,
                               atol=1e-11 * np.abs(want_gs).max())
    assert torch.equal(block_cdot(_t(bed), _t(rows), _t(eps), _t(mave),
                                  _t(msig)), c)
    # A run of two blocks: each Gram bit-equal to its block alone.
    run = blocks_gram_scaled(_t(bed), _t(np.stack([rows, rows[::-1]])),
                             na_in, _t(np.stack([mave, mave[:, ::-1]])),
                             _t(np.stack([msig, msig[:, ::-1]])))
    assert torch.equal(run[0], gs)
    target = torch.zeros((T, 4, mb), dtype=F64)
    block_eps_update_(_t(bed), _t(rows), _t(d), _t(mave), _t(na), target)
    np.testing.assert_allclose(target.numpy(), deps, rtol=RTOL,
                               atol=1e-11 * np.abs(deps).max())
    # The sweep interface: the update and the next c-dot, at float64.
    passes = BlockPasses(_t(bed), _t(np.stack([rows, rows])),
                         _t(np.stack([mave, mave])),
                         _t(np.stack([msig, msig])), _t(na))
    assert passes.c.dtype == F64
    e2 = _t(eps.copy())
    passes.update_cdot_(0, _t(np.stack([d, d])), e2)
    want_e2 = _t(eps.copy())
    block_eps_update_(_t(bed), _t(rows), _t(d), _t(mave), _t(na), want_e2)
    assert torch.equal(e2, want_e2)
    assert torch.equal(passes.c[1], block_cdot(_t(bed), _t(rows), want_e2,
                                               _t(mave), _t(msig)))


@pytest.mark.parametrize("nt", [1, 3], ids=["shared_na", "per_trait_na"])
def test_fused_plain_matches_jax_wide_over_two_blocks(nt):
    """Kernel B's fused pass (block b's update, then block b + 1's c-dot
    from the updated residual) through the one-block wrapper and through
    BlockPasses on the CPU, against the JAX package's float64 route over
    the same two consecutive blocks: ``block_eps_update(dtype=float64)``,
    then ``_block_gram_wide``'s craw on the updated residual.  Tolerance:
    rtol 1e-9 and 1e-11 of the largest magnitude (float64 sums of at most
    4 mb terms in other orders, as RTOL says); the wrapper and BlockPasses
    bit-equal."""
    rng = np.random.default_rng(61 + nt)
    T, B, mb = 3, 32, 300
    bed, rows, na, eps, mave, msig = _block_case(rng, T, B, mb, nt)
    rows_next = np.setdiff1d(np.arange(2 * B), rows).astype(np.int32)
    rows_next = rng.permutation(rows_next).astype(np.int32)
    mave_next = rng.uniform(0.2, 1.8, size=(T, B))
    msig_next = rng.uniform(0.5, 2.0, size=(T, B))
    d = rng.normal(size=(T, B)) * 0.1
    with jax.enable_x64(True):
        deps = block_eps_update(jnp.asarray(bed[rows]), jnp.asarray(d),
                                jnp.asarray(na), jnp.asarray(mave),
                                dtype=jnp.float64)
        want_eps = jnp.asarray(eps) + deps
        craw, _ = _block_gram_wide(jnp.asarray(bed[rows_next]), want_eps,
                                   jnp.asarray(na), jnp.asarray(mave_next),
                                   dtype=jnp.float64)
        want_eps, craw = np.asarray(want_eps), np.asarray(craw)
    want_c = msig_next * craw
    got_eps = _t(eps.copy())
    got_c = block_update_cdot_(_t(bed), _t(rows), _t(d), _t(mave), _t(na),
                               got_eps, _t(rows_next), _t(mave_next),
                               _t(msig_next))
    assert got_c.dtype == got_eps.dtype == F64
    np.testing.assert_allclose(got_eps.numpy(), want_eps, rtol=RTOL,
                               atol=1e-11 * np.abs(want_eps).max())
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=RTOL,
                               atol=1e-11 * np.abs(want_c).max())
    passes = BlockPasses(_t(bed), _t(np.stack([rows, rows_next])),
                         _t(np.stack([mave, mave_next])),
                         _t(np.stack([msig, msig_next])), _t(na))
    e2 = _t(eps.copy())
    passes.update_cdot_(0, _t(np.stack([d, d])), e2)
    assert torch.equal(e2, got_eps) and torch.equal(passes.c[1], got_c)


def test_f64_sweep_block_steps_follow_the_fused_cadence(setup64,
                                                       monkeypatch):
    """A float64 W=1 marker_sweep (4 blocks of 32) on one device: the c-dot
    of block 0, then per block kernel B's fused step, the last block's
    update alone, as the float32 sweep; eps, betas, comp, acum and cass
    bit-equal to the three-call cadence (c-dot, scan, update per block;
    forced by a target that is a new view of eps)."""
    opt, data, static, state = setup64
    blocks, u, z, eps, sigmae, betas, sigmag = _sweep_inputs(
        data, static, state, 7)
    tstate = state_from_numpy(_leaves(state), CPU)
    tstatic = static_from_numpy(_leaves(static), CPU)
    nb = blocks.shape[0]
    calls, depth = [], [0]
    for name in ("cdot", "update_", "update_cdot_"):
        real = getattr(BlockPasses, name)

        def spy(self, b, *rest, _real=real, _name=name):
            if not depth[0]:
                calls.append((_name, b))
            depth[0] += 1
            try:
                return _real(self, b, *rest)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(BlockPasses, name, spy)

    def sweep():
        return marker_sweep(_t(eps.copy()), _t(betas), tstate.comp,
                            tstate.acum, _t(sigmag), _t(sigmae),
                            tstate.pi_est, tstatic, _t(blocks), _t(u), _t(z),
                            wave=1)
    got = sweep()
    assert calls == ([("cdot", 0)]
                     + [("update_cdot_", b) for b in range(nb - 1)]
                     + [("update_", nb - 1)])
    calls.clear()
    step = tgibbs._ComposedSweep.step
    monkeypatch.setattr(tgibbs._ComposedSweep, "step",
                        lambda self, b, e, target:
                        step(self, b, e, target.view_as(target)))
    want = sweep()
    assert calls == [(name, b) for b in range(nb)
                     for name in ("cdot", "update_")]
    assert got[0].dtype == F64 and (got[2] != 0).any()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["plain", "adav", "overflow", "k8", "k16",
                                  "b37"])
def test_block_scan_matches_jax_at_f64(case):
    """Kernel C's plain version, through sampler/scan.block_scan, against
    the JAX package's XLA block_scan at float64, on the cases of
    tests/test_scan_kernel.py:57-80, with 8 and 16 components and a block
    of 37 markers (not a multiple of 4: no bulk copies on the card)."""
    seed = {"plain": 0, "adav": 1, "overflow": 2, "k8": 3, "k16": 4,
            "b37": 5}[case]
    rng = np.random.default_rng(seed)
    K = {"k8": 8, "k16": 16}.get(case, 4)
    T, B, G = 3, 37 if case == "b37" else 32, 2
    args = [np.asarray(x) for x in _random_case(
        rng, T, B, G, K, adav_group=0 if case == "adav" else None,
        overflow=case == "overflow")]
    args = [x.astype(np.float64) if x.dtype == np.float32 else x
            for x in args]
    # The case's Gram is a float32 product, symmetric only to its rounding;
    # the port reads gs[t, j, i] where the JAX scan reads gs[t, i, j].
    args[1] = 0.5 * (args[1] + args[1].transpose(0, 2, 1))
    got = block_scan(*[_t(a) for a in args[:15]], float(args[15]))
    assert got.beta_new.dtype == F64
    with jax.enable_x64(True):
        want = jax.device_get(jax_block_scan(*[jnp.asarray(a)
                                               for a in args]))
    assert want.beta_new.dtype == np.float64
    np.testing.assert_array_equal(got.comp_new.numpy(), want.comp_new)
    np.testing.assert_array_equal(got.cass_inc.numpy(), want.cass_inc)
    live = args[6][None, :] & (args[9][:, args[5]] != 0)
    assert len(np.unique(got.comp_new.numpy()[live])) > 1
    for name in ("dbeta_eff", "beta_new", "acum_new"):
        _close(getattr(got, name).numpy(), getattr(want, name), name)


def test_predict_sums_plain_match_jax_at_f64(sim_small):
    """Kernel D's plain version against ``_chunked_predict_sums(dtype=
    float64)``: xtx bit-equal, xty within 1e-11 sum|val*y| + 1e-12."""
    from gmrm_tpu_torch.io.bed import read_bed
    from gmrm_tpu_torch.io.grouping import read_dim
    from gmrm_tpu_torch.io.phen import read_phen
    n, m = read_dim(sim_small.dim)
    bed = read_bed(sim_small.bed, n, m)
    for phen in sim_small.phens:
        ph = read_phen(phen, n)
        na = to_phase_planes(ph.na_vector_padded())
        y = to_phase_planes(ph.epsilon_padded())
        with jax.enable_x64(True):
            w_xtx, w_xty = (np.asarray(x) for x in _chunked_predict_sums(
                bed, jnp.asarray(na), jnp.asarray(y), dtype=jnp.float64))
        assert w_xty.dtype == np.float64
        xtx, xty = predict_sums(_t(bed), _t(na), _t(y))
        assert xty.dtype == F64
        np.testing.assert_array_equal(xtx.numpy(), w_xtx)
        a, _ = decode_planes(_t(bed), F64)
        bound = 1e-11 * np.abs(a.numpy() * na * y).sum(axis=(1, 2)) + 1e-12
        assert (np.abs(xty.numpy() - w_xty) <= bound).all()


def test_hyper_block_matches_oracle_at_f64(setup64, monkeypatch):
    """The hyperparameter block at float64 with injected draws (every
    Gamma(a, 1) variate is its mean a) against the float64 oracle
    (oracle.py:231): the draws come back float64."""
    opt, data, static, state = setup64
    monkeypatch.setattr(dists, "gamma", lambda gen, shape: shape)
    rng = np.random.default_rng(9)
    T, m_pad = state.betas.shape
    G, K = opt.cva.shape
    betas = rng.normal(size=(T, m_pad)) * 0.05
    cass = rng.integers(0, 30, size=(T, G, K)).astype(np.int32)
    cass[0, 1] = 0                                  # an emptied group
    eps = np.array(state.eps)
    sigmag = np.array(state.sigmag)
    pi = np.array(state.pi_est)
    tstatic = static_from_numpy(_leaves(static), CPU)
    sg, se, pi_new, m0, _ = hyper_block(
        _t(betas), _t(cass), _t(eps), _t(sigmag), _t(pi), tstatic,
        gen=lambda name: None)
    assert sg.dtype == se.dtype == pi_new.dtype == F64
    group_of = np.asarray(static.group_of)
    mtot = np.asarray(static.mtotgrp)
    for t in range(T):
        ost = oracle.OracleState(
            eps=eps[t].reshape(-1), betas=betas[t], comp=None, acum=None,
            cass=cass[t].astype(np.int64), sigmag=sigmag[t].copy(),
            sigmae=0.0, pi_est=pi[t].copy(), mu=0.0,
            nonas=int(np.asarray(static.nonas)[t]))
        oracle.hyper_block(ost, group_of, mtot, data.n,
                           draw_inv_chisq=lambda a, b: b,
                           draw_gamma=lambda shape: shape)
        np.testing.assert_allclose(sg[t].numpy(), ost.sigmag, rtol=1e-12)
        np.testing.assert_allclose(pi_new[t].numpy(), ost.pi_est,
                                   rtol=1e-12)
        np.testing.assert_allclose(float(se[t]), ost.sigmae, rtol=1e-12)
        np.testing.assert_array_equal(m0[t].numpy(), mtot - cass[t, :, 0])


# --------------------------------------------------------------------------
# The sharded W=1 sweep
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shard_sim64(tmp_path_factory):
    """tests/test_torch_sharded.py's shard_sim: 98 markers, so 2 shards of
    49 and 4 shards of 25, 25, 24, 24."""
    return simulate(str(tmp_path_factory.mktemp("shardsim64")), n=402, m=98,
                    n_traits=2, n_causal=24, h2=0.5, n_groups=2,
                    na_rate=0.03, seed=20260817,
                    mixtures=np.array([0.0, 0.001, 0.01, 0.05]))


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_sweep_matches_replay_oracle_at_f64(shard_sim64, D):
    """The float64 sharded W=1 sweep (blocks of 4) against the float64
    D-rank replay oracle (oracle.py:139) with injected randomness, as
    tests/test_torch_sharded.py holds the float32 one."""
    B = 4
    g = _global_inputs(shard_sim64, D, B)
    mps = g["mps"]
    nblocks = mps // B
    G, K = g["cva"].shape
    rng = np.random.default_rng(4711 + D)
    sigmag0 = rng.uniform(0.05, 0.5, size=G)
    ph = g["ph"]
    ost = oracle.OracleState(
        eps=ph.epsilon_padded().copy(), betas=np.zeros(g["m"]),
        comp=np.zeros(g["m"], np.int64), acum=np.zeros(g["m"]),
        cass=np.zeros((G, K), np.int64), sigmag=sigmag0.copy(), sigmae=0.6,
        pi_est=pi_prior_from_cva(g["cva"]).copy(), mu=0.0, nonas=ph.nonas)
    perms = [rng.permutation(mps) for _ in range(D)]
    us = [rng.uniform(size=mps) for _ in range(D)]
    zs = [rng.normal(size=mps) for _ in range(D)]
    oracle.sweep_replay_sharded(
        ost, g["a"], g["b"], g["napad"], g["mave"], g["msig"], g["gidx"],
        g["cva"], g["cvai"], g["blocks_glob"], perms, us, zs, B, g["n"])

    def shardpad(x):
        out = np.zeros(D * mps)
        for i, (s, ln) in enumerate(g["blocks_glob"]):
            out[i * mps:i * mps + ln] = x[s:s + ln]
        return out

    mb = g["leaves"]["bed"].shape[1]
    eps0 = np.zeros((1, 4, mb))
    eps0[0, :, :(ph.epsilon_padded().shape[0] // 4)] = to_phase_planes(
        ph.epsilon_padded())
    leaves = dict(g["leaves"], gram_cache=None,
                  na=g["leaves"]["na"].astype(np.float64),
                  mave=shardpad(g["mave"])[None],
                  msig=shardpad(g["msig"])[None],
                  nonas=np.asarray([float(ph.nonas)]), cva=g["cva"],
                  cvai=g["cvai"], n_total=g["n"])
    statics = static_from_numpy(leaves, CPU, n_shards=D)
    states = state_from_numpy(dict(
        eps=eps0, betas=np.zeros((1, D * mps)),
        comp=np.zeros((1, D * mps), np.int32), acum=np.zeros((1, D * mps)),
        cass=np.zeros((1, G, K), np.int32), sigmag=sigmag0[None],
        sigmae=np.asarray([0.6]), pi_est=pi_prior_from_cva(g["cva"])[None],
        mu=np.zeros(1), epssum=np.zeros(1)), CPU, n_shards=D)
    assert statics[0].mave.dtype == states[0].eps.dtype == F64
    first = states[0]
    eps, marker_states, cass = marker_sweep_sharded(
        first.eps, [(s.betas, s.comp, s.acum) for s in states], first.sigmag,
        first.sigmae, first.pi_est, statics,
        [_t(p.reshape(nblocks, B).astype(np.int64)) for p in perms],
        [_t(x.reshape(nblocks, 1, B)) for x in us],
        [_t(x.reshape(nblocks, 1, B)) for x in zs], wave=1,
        comm=Communicator(CPU))

    def glob(k):
        return torch.cat([ms[k] for ms in marker_states], dim=1).numpy()
    assert eps.dtype == F64
    np.testing.assert_array_equal(_gather(glob(1), g), ost.comp,
                                  err_msg="component choices diverged")
    np.testing.assert_array_equal(cass.numpy()[0], ost.cass)
    _close(_gather(glob(0), g), ost.betas, "betas")
    _close(_gather(glob(2), g), ost.acum, "acum")
    _close(from_phase_planes(eps.numpy())[0], ost.eps, "eps")


# --------------------------------------------------------------------------
# The plan, the startup cache and checkpoints at float64
# --------------------------------------------------------------------------

def _opt(sim, out, **kw):
    base = dict(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                group_index_file=sim.gri, group_mixture_file=sim.grm,
                iterations=4, seed=5, out_dir=out, block_size=16,
                dtype="float64")
    base.update(kw)
    return Options(**base)


def test_explicit_wave_at_f64_is_not_covered(sim_small, tmp_path, capsys):
    """--dtype float64 plans W = 1 when no wave is named (the port's auto
    plan at float64); an explicit --wave-size 32 is kept, on one device and
    sharded, with the block guard's warning below 64 blocks; --wave-size 1
    stays 1; and the command line trains float64 at --wave-size 32 (the
    float64 wave path, tests/test_torch_float64_wave.py)."""
    opt = _opt(sim_small, str(tmp_path), block_size=64)
    resolve_plan(opt, "cpu", sim_small.m)
    assert opt.wave_size == 1
    for m_local in (sim_small.m, sim_small.m // 2):
        opt = _opt(sim_small, str(tmp_path), block_size=64, wave_size=32)
        assert resolve_plan(opt, "cpu", m_local, verbose=True) < 64
        assert opt.wave_size == 32 and not opt.wave_auto
        assert "WARNING: only" in capsys.readouterr().out
    opt = _opt(sim_small, str(tmp_path), wave_size=1)
    resolve_plan(opt, "cuda", sim_small.m)
    assert opt.wave_size == 1
    out = str(tmp_path / "cli")
    argv = ["--bed-file", sim_small.bed, "--dim-file", sim_small.dim,
            "--phen-files", ",".join(sim_small.phens), "--group-index-file",
            sim_small.gri, "--group-mixture-file", sim_small.grm,
            "--block-size", "32", "--wave-size", "32", "--dtype", "float64",
            "--iterations", "2", "--verbosity", "-1", "--out-dir", out]
    assert cli.main(argv, device="cpu") == 0
    its, bet = read_history(os.path.join(out, "test1.bet"), "f8")
    assert list(its) == [1, 2] and np.isfinite(bet).all()


def _static_of(opt, cache_dir=""):
    opt.cache_dir = cache_dir
    opt.validate()
    opt.load_group_mixtures()
    resolve_plan(opt, "cpu", 10 ** 6)
    data = trunner.load_data(opt)
    cache = trunner.startup_cache(data, opt)
    return trunner.build_static(data, opt, CPU, cache), cache


def test_f32_cache_entry_is_not_served_to_f64(sim_small, tmp_path):
    """An f32 run's --cache-dir entry is not served to an f64 run of the
    same data: the f64 run goes cold and its mave/msig are float64 and
    equal to a build without the cache; its own entry then serves it."""
    cache_dir = str(tmp_path / "cache")
    s32, c32 = _static_of(_opt(sim_small, "", dtype="float32"), cache_dir)
    assert not c32.warm and s32.mave.dtype == torch.float32
    s64, c64 = _static_of(_opt(sim_small, ""), cache_dir)
    assert not c64.warm and c64.path != c32.path
    bare, _ = _static_of(_opt(sim_small, ""))
    assert s64.mave.dtype == s64.msig.dtype == F64
    assert torch.equal(s64.mave, bare.mave)
    assert torch.equal(s64.msig, bare.msig)
    warm, c64b = _static_of(_opt(sim_small, ""), cache_dir)
    assert c64b.warm and warm.mave.dtype == F64
    assert torch.equal(warm.mave, bare.mave)
    assert torch.equal(warm.msig, bare.msig)


def _outputs(out, sim):
    return [open(os.path.join(out, os.path.basename(p)[:-5] + sfx),
                 "rb").read()
            for p in sim.phens for sfx in (".csv", ".bet", ".cpn")]


@pytest.mark.parametrize("shards", [1, 2])
def test_f64_chain_resumes_byte_equal(sim_small, tmp_path, shards):
    """An f64 chain cut at 2 with a checkpoint and resumed to 5 writes the
    bytes of the uninterrupted f64 chain, on one device and at S=2; the
    resumed state is float64."""
    def run(out, **kw):
        opt = _opt(sim_small, out, **{"iterations": 5, **kw})
        if shards == 1:
            return trunner.run_training(opt, device="cpu", verbose=False)
        return run_training_sharded(opt, n_devices=shards, device="cpu",
                                    verbose=False)

    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")
    whole = run(full)
    run(cut, iterations=2, checkpoint_every=2)
    res = run(cut, resume=True)
    assert res.iters_run == 3
    st = res.state if shards == 1 else res.state[0]
    assert st.eps.dtype == st.betas.dtype == st.sigmag.dtype == F64
    assert _outputs(cut, sim_small) == _outputs(full, sim_small)
    w = whole.state if shards == 1 else whole.state[0]
    assert torch.equal(st.eps, w.eps)


def test_f32_checkpoint_resumes_in_f64(sim_small, tmp_path):
    """A float32 checkpoint resumed with --dtype float64 continues in
    float64, from the float32 values cast up, as gmrm_tpu/checkpoint.py's
    load in the run's dtype gives."""
    out = str(tmp_path / "o")
    trunner.run_training(
        _opt(sim_small, out, dtype="float32", iterations=2,
             checkpoint_every=2), device="cpu", verbose=False)
    opt = _opt(sim_small, out, resume=True)
    path = checkpoint.checkpoint_path(out)
    layout = dict(block_size=16, wave_size=1, interleave=0,
                  m_total=sim_small.m)
    s32, it, _, _ = checkpoint.load_checkpoint(path, CPU, opt.seed, layout,
                                               torch.float32)
    s64, _, _, _ = checkpoint.load_checkpoint(path, CPU, opt.seed, layout,
                                              F64)
    assert it == 2 and s32.betas.dtype == torch.float32
    for f in checkpoint.STATE_FIELDS:
        a, b = getattr(s32, f), getattr(s64, f)
        if a.is_floating_point():
            assert b.dtype == F64 and torch.equal(b, a.double()), f
        else:
            assert torch.equal(a, b), f
    res = trunner.run_training(opt, device="cpu", verbose=False)
    assert res.iters_run == 2
    assert res.state.eps.dtype == res.state.sigmae.dtype == F64
    assert np.isfinite(res.state.sigmag.numpy()).all()


# --------------------------------------------------------------------------
# The command line at float64
# --------------------------------------------------------------------------

@pytest.mark.parametrize("devices", ["1", "2"])
def test_cli_trains_resumes_and_predicts_at_f64(sim_small, tmp_path,
                                                devices):
    """python -m gmrm_tpu_torch --dtype float64 trains (one device and
    --devices 2), resumes to the bytes of an uninterrupted run, and
    predicts; the .mlma matches the JAX command line's float64 predict
    (run in a subprocess): ids exact, fields within 1e-10 relative plus
    the last printed digit."""
    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")
    argv = ["--bed-file", sim_small.bed, "--dim-file", sim_small.dim,
            "--phen-files", ",".join(sim_small.phens), "--group-index-file",
            sim_small.gri, "--group-mixture-file", sim_small.grm,
            "--block-size", "16", "--dtype", "float64", "--devices", devices,
            "--seed", "9", "--verbosity", "-1"]
    assert cli.main(argv + ["--iterations", "4", "--out-dir", full],
                    device="cpu") == 0
    assert cli.main(argv + ["--iterations", "2", "--checkpoint-every", "2",
                            "--out-dir", cut], device="cpu") == 0
    assert cli.main(argv + ["--iterations", "4", "--resume", "--out-dir",
                            cut], device="cpu") == 0
    its, bet = read_history(os.path.join(full, "test1.bet"), "f8")
    assert list(its) == [1, 2, 3, 4] and np.isfinite(bet).all()
    assert _outputs(cut, sim_small) == _outputs(full, sim_small)
    if devices == "2":
        return
    pargv = ["--predict", "--bed-file", sim_small.bed, "--dim-file",
             sim_small.dim, "--phen-files", ",".join(sim_small.phens),
             "--bim-file", sim_small.bim, "--ref-bim-file", sim_small.bim,
             "--dtype", "float64"]
    jdir = str(tmp_path / "jax")
    os.makedirs(jdir)
    for p in sim_small.phens:
        b = os.path.basename(p)[:-5] + ".bet"
        with open(os.path.join(full, b), "rb") as src, \
                open(os.path.join(jdir, b), "wb") as dst:
            dst.write(src.read())
    assert cli.main(pargv + ["--out-dir", full], device="cpu") == 0
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "gmrm_tpu", *pargv,
                           "--out-dir", jdir], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for p in sim_small.phens:
        name = os.path.basename(p)[:-5] + ".mlma"
        ids_t, f_t = mlma_fields(open(os.path.join(full, name), "rb").read())
        ids_j, f_j = mlma_fields(open(os.path.join(jdir, name), "rb").read())
        assert ids_t == ids_j and len(ids_t) == sim_small.m
        np.testing.assert_array_equal(np.isnan(f_t), np.isnan(f_j))
        live = ~np.isnan(f_j)
        np.testing.assert_allclose(f_t[live], f_j[live], rtol=1e-10,
                                   atol=2e-15)


def test_gram_runs_count_f64_bytes(sim_small, monkeypatch):
    """A float64 sweep sizes its runs of Grams for 8 bytes an entry: the
    anchor's 157 blocks still fit one run, on a sweep of 7,813 blocks
    fewer blocks fit than at float32, and as many as for 2 T float32
    Grams."""
    from gmrm_tpu_torch.sampler import gibbs as tgibbs
    assert gram_run_blocks(4, 128, 157, 8) == 157
    assert (gram_run_blocks(4, 128, 7813, 8)
            < gram_run_blocks(4, 128, 7813))
    assert (gram_run_blocks(4, 128, 7813, 8)
            == gram_run_blocks(8, 128, 7813))
    seen = []

    def spy(T, B, nblocks, elem=4):
        seen.append((T, elem))
        return gram_run_blocks(T, B, nblocks, elem)

    monkeypatch.setattr(tgibbs, "gram_run_blocks", spy)
    for dtype, elem in (("float64", 8), ("float32", 4)):
        opt = _opt(sim_small, "", dtype=dtype, iterations=1)
        trunner.run_training(opt, device="cpu", verbose=False)
        assert seen[-1] == (2, elem), dtype
