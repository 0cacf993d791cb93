"""The port's exact serial (W=1) path against the JAX package and the
float64 oracle: the block-Gram and serial-scan kernels' plain versions,
the W=1 sweep, and W=1 training end to end on the CPU.

The JAX Pallas kernels run in interpret mode on the CPU, as the JAX
package's own tests run them.  The CUDA kernels are checked against these
plain versions on the card by chip_smoke.py.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gmrm_tpu.ops.sweep_kernel as swk
from gmrm_tpu import oracle
from gmrm_tpu.config import Options
from gmrm_tpu.io.sim import simulate
from gmrm_tpu.io.writers import read_history
from gmrm_tpu.ops.decode import from_phase_planes, to_phase_planes
from gmrm_tpu.ops.pallas_kernels import block_gram_scaled_pallas
from gmrm_tpu.ops.scan_kernel import block_scan_pallas
from gmrm_tpu.runner import build_static as jax_build_static
from gmrm_tpu.runner import init_sampler_state as jax_init_state
from gmrm_tpu.runner import load_data as jax_load_data
from gmrm_tpu.sampler import gibbs as jgibbs
from gmrm_tpu.sampler.scan import block_scan as jax_block_scan
from gmrm_tpu_torch import runner
from gmrm_tpu_torch.ops import scan_kernel as tscan
from gmrm_tpu_torch.ops.block_gram import (
    block_gram_scaled, block_gram_scaled_plain, blocks_gram_scaled,
    gram_run_blocks,
)
from gmrm_tpu_torch.ops.decode import decode_planes
from gmrm_tpu_torch.ops.scan_kernel_wave import scan_masks
from gmrm_tpu_torch.ops.sweep_kernel import (
    build_sweep_tables, gram_cache_plain,
)
from gmrm_tpu_torch.sampler import gibbs as tgibbs
from gmrm_tpu_torch.sampler.dists import RngPlan
from gmrm_tpu_torch.sampler.gibbs import block_order, marker_sweep
from gmrm_tpu_torch.sampler.scan import block_scan
from gmrm_tpu_torch.sampler.state import state_from_numpy, static_from_numpy
from test_scan_kernel import _random_case
from test_sweep_equivalence import _setup

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _leaves(x):
    return {k: (None if v is None else np.asarray(v))
            for k, v in vars(x).items() if k != "key"}


def _gram_case(rng, T, B, mb, nt):
    """tests/test_gram_kernel.py:26-36 inputs, in a bed twice the block."""
    bed = rng.integers(0, 256, size=(2 * B, mb), dtype=np.uint8)
    na = np.ones((nt, 4, mb), np.float32)
    if nt > 1:
        na *= rng.uniform(size=(nt, 4, mb)) > 0.03
    eps = rng.normal(size=(T, 4, mb)).astype(np.float32) * na
    mave = rng.uniform(0.2, 1.8, size=(T, B)).astype(np.float32)
    msig = rng.uniform(0.5, 2.0, size=(T, B)).astype(np.float32)
    return bed, eps, na, mave, msig


@pytest.mark.parametrize("mb", [300, 700])
@pytest.mark.parametrize("nt", [1, 3], ids=["shared_na", "per_trait_na"])
def test_block_gram_matches_pallas(mb, nt):
    """Kernel 5's plain version against block_gram_scaled_pallas on the
    block's rows taken through a random index.  gs to the tolerance of
    test_gram_kernel.py:59-60.  The TPU kernel splits eps into bf16 hi/lo
    (about 2^-17 relative per term), which puts its c up to ~3e-4 off the
    full float32 sum at mb=700; so c is held to it with the scaled bf16-split
    tolerance of test_gram_kernel.py:68-70, and to the float64 sum at
    float32 precision."""
    rng = np.random.default_rng(mb + nt)
    T, B = 3, 32
    bed, eps, na, mave, msig = _gram_case(rng, T, B, mb, nt)
    rows = rng.choice(2 * B, size=B, replace=False).astype(np.int32)
    c, gs = block_gram_scaled(_t(bed), _t(rows), _t(eps), _t(na), _t(mave),
                              _t(msig))
    na_full = np.broadcast_to(na, (T, 4, mb))
    cj, gj = block_gram_scaled_pallas(
        jnp.asarray(bed[rows]), jnp.asarray(eps), jnp.asarray(na_full),
        jnp.asarray(mave), jnp.asarray(msig), shared_na=nt == 1,
        interpret=True)
    np.testing.assert_allclose(gs.numpy(), np.asarray(gj), rtol=2e-5,
                               atol=2e-3)
    a64, b64 = decode_planes(_t(bed[rows]), torch.float64)
    e64 = torch.from_numpy(eps.astype(np.float64)).reshape(T, -1)
    craw = (e64 @ a64.reshape(B, -1).T
            - torch.from_numpy(mave.astype(np.float64))
            * (e64 @ b64.reshape(B, -1).T)).numpy()
    scale = np.abs(craw).max() + 1.0
    np.testing.assert_allclose(c.numpy() / scale, (msig * craw) / scale,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(c.numpy() / scale, np.asarray(cj) / scale,
                               rtol=0, atol=3e-5)


@pytest.mark.parametrize("nt", [1, 2])
def test_block_gram_raw_part_bit_equal(nt):
    """With mave = 0 and msig = 1 the scaled Gram is the raw A.A quadrant:
    bit-equal to the Gram cache of the same natural block, both the
    port's plain version and the JAX builder."""
    rng = np.random.default_rng(40 + nt)
    T, B, mb = 2, 16, 512
    bed, eps, na, _, _ = _gram_case(rng, T, B, mb, nt)
    bed[-3:] = 0x55                                        # pad rows
    rows = np.arange(B, 2 * B, dtype=np.int32)             # natural block 1
    _, gs = block_gram_scaled(_t(bed), _t(rows), _t(eps), _t(na),
                              torch.zeros(T, B), torch.ones(T, B))
    cache = gram_cache_plain(_t(bed), _t(na), B)[1, :, :B, :B]
    want = swk.build_gram_cache(jnp.asarray(bed),
                                jnp.asarray(np.broadcast_to(na, (T, 4, mb))),
                                block_size=B, shared_na=nt == 1)
    np.testing.assert_array_equal(
        gs.numpy(), np.broadcast_to(cache.numpy(), (T, B, B)))
    np.testing.assert_array_equal(cache.numpy(),
                                  np.asarray(want)[1, :, :B, :B])


@pytest.mark.parametrize("nt", [1, 3], ids=["shared_na", "per_trait_na"])
def test_blocks_gram_matches_pallas_and_plain(nt):
    """Kernel 5 over a run of blocks (plain version): three blocks of a
    shuffled bed whose pad rows come last, so the last block has pad slots.
    Block by block bit-equal to block_gram_scaled_plain, and against
    block_gram_scaled_pallas to the tolerance of
    test_block_gram_matches_pallas."""
    rng = np.random.default_rng(70 + nt)
    T, B, mb, nb = 3, 32, 300, 3
    m_real = nb * B - 5
    bed = rng.integers(0, 256, size=(nb * B, mb), dtype=np.uint8)
    bed[m_real:] = 0x55                                    # pad rows
    bed[:, mb - 7:] = 0x55                                 # pad columns
    na = np.ones((nt, 4, mb), np.float32)
    na[:, :, mb - 7:] = 0
    if nt > 1:
        na *= rng.uniform(size=(nt, 4, mb)) > 0.03
    eps = rng.normal(size=(T, 4, mb)).astype(np.float32)
    rows = np.concatenate([rng.permutation(m_real),
                           np.arange(m_real, nb * B)]).astype(np.int32)
    rows = rows.reshape(nb, B)
    real = (rows < m_real)[:, None, :]
    mave = (rng.uniform(0.2, 1.8, size=(nb, T, B)) * real).astype(np.float32)
    msig = (rng.uniform(0.5, 2.0, size=(nb, T, B)) * real).astype(np.float32)
    gs = blocks_gram_scaled(_t(bed), _t(rows), _t(na), _t(mave), _t(msig))
    assert gs.shape == (nb, T, B, B) and gs.dtype == torch.float32
    assert (gs[-1][:, -5:] == 0).all() and (gs[-1][:, :, -5:] == 0).all()
    na_full = np.broadcast_to(na, (T, 4, mb))
    for n in range(nb):
        _, want = block_gram_scaled_plain(_t(bed), _t(rows[n]), _t(eps),
                                          _t(na), _t(mave[n]), _t(msig[n]))
        assert torch.equal(gs[n], want), n
        _, gj = block_gram_scaled_pallas(
            jnp.asarray(bed[rows[n]]), jnp.asarray(eps),
            jnp.asarray(na_full), jnp.asarray(mave[n]), jnp.asarray(msig[n]),
            shared_na=nt == 1, interpret=True)
        np.testing.assert_allclose(gs[n].numpy(), np.asarray(gj), rtol=2e-5,
                                   atol=2e-3)


def test_gram_runs_stay_under_the_byte_budget(monkeypatch):
    """A run's scaled Grams fit the budget (the kernel keeps no raw Gram
    in device memory, so the masks do not count); never less than one
    block, never more than the sweep has."""
    import gmrm_tpu_torch.ops.block_gram as bgm
    assert gram_run_blocks(4, 128, 157) == 157
    assert gram_run_blocks(4, 128, 7813) == 512
    assert 512 * 4 * 4 * 128 ** 2 == bgm.GRAM_RUN_BYTES
    monkeypatch.setattr(bgm, "GRAM_RUN_BYTES", 1)
    assert gram_run_blocks(4, 128, 157) == 1


@pytest.mark.parametrize("case", ["plain", "adav", "overflow"])
def test_block_scan_matches_both_jax_scans(case):
    """The port's W=1 block scan against block_scan_pallas (interpret) and
    the XLA block_scan on the cases of tests/test_scan_kernel.py:57-80."""
    rng = np.random.default_rng({"plain": 0, "adav": 1, "overflow": 2}[case])
    T, B, G, K = 3, 32, 2, 4
    args = _random_case(rng, T, B, G, K,
                        adav_group=0 if case == "adav" else None,
                        overflow=case == "overflow")
    got = block_scan(*[torch.from_numpy(np.array(a)) for a in args])
    live = (np.asarray(args[6])[None, :]
            & (np.asarray(args[9])[:, np.asarray(args[5])] != 0))
    assert len(np.unique(got.comp_new.numpy()[live])) > 1
    for want in (block_scan_pallas(*args, interpret=True),
                 jax_block_scan(*args)):
        np.testing.assert_array_equal(got.comp_new.numpy(),
                                      np.asarray(want.comp_new))
        np.testing.assert_array_equal(got.cass_inc.numpy(),
                                      np.asarray(want.cass_inc))
        for name in ("dbeta_eff", "beta_new"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got.acum_new.numpy(),
                                   np.asarray(want.acum_new), rtol=1e-4,
                                   atol=1e-6)


def _sweep_arrays(args, K):
    """The sweep's (nb = 2, ..., B) operands of kernel 6 from one
    block_scan case: block 1 is the case, block 0 the same markers in
    reverse order.  Returns (scan, per-block block_scan arguments, c)."""
    (c, gs, beta_old, comp_old, acum_old, grp, valid, u, z, sigmag, sigmae,
     pi_est, cva, cvai, nonas, n_total) = [np.array(a) for a in args]
    rev = slice(None, None, -1)
    blocks = [
        (c[:, rev], gs[:, rev, rev], beta_old[:, rev], comp_old[:, rev],
         acum_old[:, rev], grp[rev], valid[rev], u[:, rev], z[:, rev]),
        (c, gs, beta_old, comp_old, acum_old, grp, valid, u, z)]
    blocks = [tuple(np.ascontiguousarray(x) for x in blk) for blk in blocks]
    hyper = (sigmag, sigmae, pi_est, cva, cvai, nonas, n_total)
    lc_t, rd_t, sqb_t = build_sweep_tables(
        _t(sigmag), _t(sigmae), _t(pi_est), _t(cva), _t(cvai), _t(nonas),
        float(n_total))

    def stack(k):
        return torch.stack([_t(blk[k]) for blk in blocks])

    grp_p = stack(5).long()                                # (nb, B)
    masks = [scan_masks(grp_p[n], _t(blk[6]), _t(sigmag))
             for n, blk in enumerate(blocks)]

    def per_block(tab):                       # (K, T, G) -> (nb, K, T, B)
        return tab[:, :, grp_p].movedim(2, 0).contiguous()

    rng = np.random.default_rng(5)
    msig_p = _t(rng.uniform(0.5, 2.0, size=stack(0).shape).astype(np.float32))
    scan = tscan.SerialScanSweep(
        _t(nonas) - 1.0, per_block(lc_t), per_block(rd_t), per_block(sqb_t),
        stack(2), stack(3), stack(4), stack(7), stack(8),
        torch.stack([m[0] for m in masks]),
        torch.stack([m[1] for m in masks]), msig_p,
        (1.0 / (2.0 * _t(sigmae))).contiguous())
    return scan, [blk + hyper for blk in blocks], stack(0), stack(1)


@pytest.mark.parametrize("case", ["plain", "adav", "overflow", "k8"])
def test_scan_sweep_arrays_match_one_block_and_jax(case):
    """Kernel 6 through the sweep's arrays and a block index: equal in
    every output to the one-block serial_scan_plain on the torch
    expression of base, d bit-equal to msig * dbeta, and against
    block_scan_pallas (interpret) and the XLA block_scan to the tolerances
    of test_block_scan_matches_both_jax_scans; also at K = 8."""
    seed = {"plain": 0, "adav": 1, "overflow": 2, "k8": 3}[case]
    rng = np.random.default_rng(seed)
    T, B, G, K = 3, 32, 2, 8 if case == "k8" else 4
    args = _random_case(rng, T, B, G, K,
                        adav_group=0 if case == "adav" else None,
                        overflow=case == "overflow")
    scan, jax_args, c_p, gs_p = _sweep_arrays(args, K)
    beta_p, comp_p, acum_p, u_all, z_all, live_p, zerob_p = scan.state
    for n in (1, 0):
        scan.step(n, c_p, gs_p, n, bc=n)
        base = c_p[n] + beta_p[n] * scan.nm1[:, None]
        want = tscan.serial_scan(
            base, *(x[n] for x in scan.tables), gs_p[n], beta_p[n],
            comp_p[n], acum_p[n], u_all[n], z_all[n], live_p[n], zerob_p[n],
            scan.i2se)
        got = (scan.dbeta[n], scan.beta_new[n], scan.comp_new[n],
               scan.acum_new[n])
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert torch.equal(scan.d[n], scan.msig_p[n] * scan.dbeta[n])
        assert len(np.unique(got[2].numpy()[live_p[n].numpy() != 0])) > 1
        jargs = [jnp.asarray(a) for a in jax_args[n]]
        for ref in (block_scan_pallas(*jargs, interpret=True),
                    jax_block_scan(*jargs)):
            np.testing.assert_array_equal(got[2].numpy(),
                                          np.asarray(ref.comp_new))
            np.testing.assert_allclose(got[0].numpy(),
                                       np.asarray(ref.dbeta_eff), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(got[1].numpy(),
                                       np.asarray(ref.beta_new), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(got[3].numpy(),
                                       np.asarray(ref.acum_new), rtol=1e-4,
                                       atol=1e-6)


@pytest.mark.parametrize("T,B,K,mode", [
    (4, 128, 4, 2), (4, 128, 8, 2), (4, 128, 16, 2), (8, 128, 8, 2),
    (8, 128, 16, 1), (8, 256, 8, 0), (8, 512, 4, 0), (16, 256, 8, 0),
    (1, 1, 2, 2)])
def test_scan_plan_fits_shared_memory(T, B, K, mode):
    """The kernel's shared memory plan: state and tables staged while a
    ring of 16 Gram rows fits beside them, else the large-block branch
    (mode 1: tables in global memory; mode 0: state too); always within
    one CTA's shared memory with at least two ring groups or every row."""
    plan = tscan.scan_plan(T, B, K)
    assert plan is not None and plan[0] == mode
    _, GR, NG = plan
    assert 4 * tscan._layout_words(T, B, K, *plan) <= tscan.SMEM_BYTES
    assert 1 <= NG <= tscan.MAX_NG
    assert GR in (1, 2, 4, 8) and NG & (NG - 1) == 0
    assert NG * GR >= B - 1 or NG >= (2 if GR > 1 else 4)


def test_scan_plan_refuses_what_cannot_fit():
    assert tscan.scan_plan(8, 1024, 4) is None
    with pytest.raises(ValueError, match="shared memory"):
        tscan._plan_or_raise(8, 1024, 4)
    # Any K: one CTA of 4 traits at K=17 stages its tables; at K=65 (3 K T
    # B values, 400 KB) it leaves them in global memory.
    assert tscan._plan_or_raise(4, 128, 17) == (2, 8, 4)
    assert tscan._plan_or_raise(4, 128, 65) == (1, 8, 8)
    assert 4 * tscan._layout_words(4, 128, 65, 2, 1, 1) > tscan.SMEM_BYTES
    with pytest.raises(ValueError, match="MAX_T"):
        tscan._plan_or_raise(33, 8, 4)


@pytest.fixture(scope="module", params=[0.02, 0.0], ids=["na", "no_na"])
def serial_setup(request, tmp_path_factory):
    """A W=1 plan of the JAX package: 120 markers in 4 blocks of 32 (so 8
    pad slots), with and without phenotype NAs (NT = T and NT = 1)."""
    out = str(tmp_path_factory.mktemp("torchserial"))
    sim = simulate(out, n=600, m=120, n_traits=2, n_causal=32, h2=0.5,
                   n_groups=2, na_rate=request.param, seed=11)
    opt = Options(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                  group_index_file=sim.gri, group_mixture_file=sim.grm,
                  iterations=1, seed=3, block_size=32, wave_size=1,
                  use_pallas=True, output_thin_rate=10 ** 9)
    opt.validate()
    opt.load_group_mixtures()
    data = jax_load_data(opt)
    static = jax_build_static(data, opt, jnp.float32)
    state = jax_init_state(data, opt, jnp.float32)
    return opt, data, static, state


def test_serial_sweep_matches_both_jax_paths(serial_setup):
    """The W=1 sweep from the JAX package's own W=1 state, whose
    gram_cache is None, against its Pallas and XLA sweeps with the same
    injected order and draws (tolerances of test_torch_sampler.py)."""
    opt, data, static, state = serial_setup
    assert static.gram_cache is None
    shared_na = all(ph.nas == 0 for ph in data.phens)
    B = opt.block_size
    T, m_pad = state.betas.shape
    nblocks = m_pad // B
    rng = np.random.default_rng(2025)
    perm = np.concatenate([rng.permutation(data.m_local),
                           np.arange(data.m_local, m_pad)])
    blocks = perm.reshape(nblocks, B).astype(np.int32)
    u = rng.uniform(size=(nblocks, T, B)).astype(np.float32)
    z = rng.normal(size=(nblocks, T, B)).astype(np.float32)
    eps = np.asarray(state.eps)
    sigmae = (0.5 * (eps.astype(np.float64) ** 2).sum(axis=(1, 2))
              / np.asarray(static.nonas)).astype(np.float32)
    betas = (rng.normal(size=(T, m_pad)) * 0.02).astype(np.float32)
    sigmag = np.asarray(state.sigmag).copy()
    sigmag[1, 0] = 0.0                                   # an adaV group

    jargs = (jnp.asarray(eps), jnp.asarray(betas), state.comp, state.acum,
             jnp.asarray(sigmag), jnp.asarray(sigmae), state.pi_est, static,
             jnp.asarray(blocks), jnp.asarray(u), jnp.asarray(z))
    want = {name: jax.device_get(jgibbs.marker_sweep(
        *jargs, use_pallas=pallas, shared_na=shared_na, wave_size=1))
        for name, pallas in (("pallas", True), ("xla", False))}

    dev = torch.device("cpu")
    tstate = state_from_numpy(_leaves(state), dev)
    tstatic = dataclasses.replace(static_from_numpy(_leaves(static), dev),
                                  shared_na=shared_na)
    assert tstatic.gram_cache is None
    got = marker_sweep(
        torch.from_numpy(eps.copy()), torch.from_numpy(betas),
        tstate.comp, tstate.acum, torch.from_numpy(sigmag),
        torch.from_numpy(sigmae), tstate.pi_est, tstatic,
        torch.from_numpy(blocks), torch.from_numpy(u), torch.from_numpy(z),
        wave=1)
    g_eps, g_beta, g_comp, g_acum, g_cass = (x.numpy() for x in got)
    assert (g_comp[:, :data.m_local] != 0).any()
    for name, (w_eps, w_beta, w_comp, w_acum, w_cass) in want.items():
        np.testing.assert_array_equal(g_comp, np.asarray(w_comp), name)
        np.testing.assert_array_equal(g_cass, np.asarray(w_cass), name)
        np.testing.assert_allclose(g_beta, np.asarray(w_beta), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(g_eps, np.asarray(w_eps), rtol=1e-3,
                                   atol=2e-4, err_msg=name)
        np.testing.assert_allclose(g_acum, np.asarray(w_acum), rtol=1e-3,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("block_size", [8, 32, 96])
def test_serial_sweep_matches_serial_oracle(sim_small, block_size):
    """Two W=1 sweeps against oracle.sweep_serial, the float64 per-marker
    recursion, with the same permutation and draws
    (tests/test_sweep_equivalence.py:81-134)."""
    (n, m, m_pad, B, a, b, napad, mave, msig, gidx, cva, cvai,
     ost, static, rng) = _setup(sim_small, block_size)
    dev = torch.device("cpu")
    tstatic = static_from_numpy(_leaves(static), dev)
    nblocks = m_pad // B
    eps = _t(to_phase_planes(ost.eps)[None].astype(np.float32))
    betas = torch.zeros((1, m_pad))
    comp = torch.zeros((1, m_pad), dtype=torch.int32)
    acum = torch.zeros((1, m_pad))
    for sweep in range(2):
        perm = rng.permutation(m)
        u = rng.uniform(size=m)
        z = rng.normal(size=m)
        oracle.sweep_serial(ost, a, b, napad, mave, msig, gidx, cva, cvai,
                            perm, u, z, n)
        blocks = np.concatenate([perm, np.arange(m, m_pad)])
        u_pad = np.zeros(m_pad, np.float32)
        u_pad[:m] = u
        z_pad = np.zeros(m_pad, np.float32)
        z_pad[:m] = z
        eps, betas, comp, acum, cass = marker_sweep(
            eps, betas, comp, acum, _t(ost.sigmag[None].astype(np.float32)),
            torch.tensor([ost.sigmae], dtype=torch.float32),
            _t(ost.pi_est[None].astype(np.float32)), tstatic,
            _t(blocks.reshape(nblocks, B)), _t(u_pad.reshape(nblocks, 1, B)),
            _t(z_pad.reshape(nblocks, 1, B)), wave=1)
        msg = f"sweep {sweep}"
        np.testing.assert_array_equal(comp.numpy()[0, :m], ost.comp, msg)
        np.testing.assert_allclose(betas.numpy()[0, :m], ost.betas,
                                   rtol=2e-3, atol=2e-4, err_msg=msg)
        np.testing.assert_allclose(acum.numpy()[0, :m], ost.acum, rtol=5e-3,
                                   atol=5e-4, err_msg=msg)
        np.testing.assert_array_equal(cass.numpy()[0], ost.cass, msg)
        np.testing.assert_allclose(from_phase_planes(eps.numpy())[0],
                                   ost.eps, rtol=5e-3, atol=2e-3,
                                   err_msg=msg)
        ost.cass[:] = 0


def test_uniform_shuffle_pins_pad_slots():
    """W=1: a uniform permutation of the real markers, pad slots last; the
    wave order keeps every row inside one natural block."""
    plan = RngPlan(4, "cpu")
    nblocks, B, m_local = 5, 8, 37
    blocks = block_order(plan, 2, nblocks, B, shuffle=True,
                         block_mode=False, m_local=m_local).reshape(-1)
    assert sorted(blocks.tolist()) == list(range(nblocks * B))
    assert blocks[m_local:].tolist() == list(range(m_local, nblocks * B))
    assert blocks[:m_local].tolist() != list(range(m_local))
    waves = block_order(plan, 2, nblocks, B, shuffle=True,
                        block_mode=True, m_local=m_local)
    assert ((waves // B) == (waves[:, :1] // B)).all()
    assert torch.equal(
        block_order(plan, 2, nblocks, B, shuffle=False,
                    block_mode=False, m_local=m_local).reshape(-1),
        torch.arange(nblocks * B))


def test_run_training_cpu_serial_auto(sim_medium, tmp_path):
    """sim_medium at B=32 has 8 blocks, so the auto plan resolves to W=1:
    the chain trains on the exact serial sweep, with storage in the
    original order and no Gram cache."""
    out = str(tmp_path / "out")
    opt = Options(bed_file=sim_medium.bed, dim_file=sim_medium.dim,
                  phen_files=sim_medium.phens,
                  group_index_file=sim_medium.gri,
                  group_mixture_file=sim_medium.grm, iterations=30, seed=42,
                  out_dir=out, block_size=32, output_thin_rate=3)
    res = runner.run_training(opt, device="cpu", verbose=False)
    assert opt.wave_size == 1 and res.iters_run == 30
    assert set(res.kernel_launches.values()) == {0}
    m = sim_medium.m
    for t, ph in enumerate(sim_medium.phens):
        base = os.path.join(out, os.path.splitext(os.path.basename(ph))[0])
        its, bet = read_history(base + ".bet", "f8")
        _, cpn = read_history(base + ".cpn", "i4")
        assert list(its) == list(range(3, 31, 3))
        assert bet.shape == (10, m) and cpn.shape == (10, m)
        assert np.isfinite(bet).all() and cpn.min() >= 0 and cpn.max() <= 3
        np.testing.assert_allclose(bet.mean(0), res.beta_mean[t], rtol=1e-12)
        r = np.corrcoef(res.beta_mean[t], sim_medium.beta_true[:, t])[0, 1]
        assert r > 0.85, r
    sg = res.state.sigmag.sum(dim=1).numpy()
    se = res.state.sigmae.numpy()
    np.testing.assert_allclose(sg / (sg + se), sim_medium.h2_realized,
                               atol=0.1)
    data = runner.load_data(opt)
    np.testing.assert_array_equal(data.inv_order, np.arange(m))
    assert runner.build_static(data, opt, "cpu").gram_cache is None


def _serial_sweep_args(sim, block_size, seed):
    """One W=1 sweep's arguments on ``sim`` from the port's own loaders:
    a uniform shuffle with pad slots last, injected draws, a non-zero beta
    and an adaV group."""
    opt = Options(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                  group_index_file=sim.gri, group_mixture_file=sim.grm,
                  iterations=1, seed=3, block_size=block_size, wave_size=1)
    opt.validate()
    opt.load_group_mixtures()
    data = runner.load_data(opt)
    static = runner.build_static(data, opt, "cpu")
    state = runner.init_sampler_state(data, opt, "cpu")
    T, m_pad = state.betas.shape
    nblocks = m_pad // block_size
    rng = np.random.default_rng(seed)
    perm = np.concatenate([rng.permutation(data.m_local),
                           np.arange(data.m_local, m_pad)])
    sigmag = state.sigmag.clone()
    sigmag[0, 0] = 0.0
    sigmae = 0.5 * (state.eps * state.eps).sum(dim=(1, 2)) / static.nonas
    betas = _t((rng.normal(size=(T, m_pad)) * 0.02).astype(np.float32))
    return (state.eps, betas, state.comp, state.acum, sigmag, sigmae,
            state.pi_est, static, _t(perm.reshape(nblocks, block_size)),
            _t(rng.uniform(size=(nblocks, T, block_size)).astype(np.float32)),
            _t(rng.normal(size=(nblocks, T, block_size)).astype(np.float32)))


def _gram_per_block_in_loop(bed, rows_all, na_in, mave_p, msig_p):
    """The cadence before the Grams were built ahead: each block's Gram
    from block_gram_scaled_plain on its own."""
    eps0 = torch.zeros((mave_p.shape[1], 4, bed.shape[1]))
    return torch.stack([
        block_gram_scaled_plain(bed, rows_all[n], eps0, na_in, mave_p[n],
                                msig_p[n])[1]
        for n in range(rows_all.shape[0])])


@pytest.mark.parametrize("run", [1, 3, 8])
def test_gram_regrouping_cannot_move_a_chain(sim_medium, monkeypatch, run):
    """One W=1 sweep on sim_medium (8 blocks of 32) with the Grams built
    ahead in runs of 1, 3 and all blocks: eps, betas, comp, acum and cass
    bit-equal to the same sweep with every block's Gram built on its own
    inside the loop."""
    args = _serial_sweep_args(sim_medium, 32, 99)
    assert args[8].shape[0] == 8

    def sweep():
        return marker_sweep(args[0].clone(), *args[1:], wave=1)

    monkeypatch.setattr(tgibbs, "gram_run_blocks", lambda *a: run)
    got = sweep()
    monkeypatch.setattr(tgibbs, "gram_run_blocks", lambda *a: 1)
    monkeypatch.setattr(tgibbs, "blocks_gram_scaled", _gram_per_block_in_loop)
    want = sweep()
    assert (got[2] != 0).any()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_divergence_message_names_the_ports_serial_path():
    with pytest.raises(FloatingPointError, match=r"with --wave-size 1\.$"):
        runner.check_finite_chain([[np.nan]], [1.0], 7)
