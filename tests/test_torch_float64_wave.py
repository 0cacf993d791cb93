"""The port's float64 wave path (``--dtype float64 --wave-size W``: the
composed W > 1 sweep on kernels A, B and E, on one device and
marker-sharded) against the JAX package's float64 functions, on the CPU.

The JAX package's own float64 W > 1 run narrows its wave scan to float32
(gmrm_tpu/ops/scan_kernel_wave.py:208, :269-272); the port scans in
double.  Its float64 reference is the JAX package's construction of the
wave relaxation (tests/test_scan_kernel.py:87-124) with no float32 cast:
its XLA ``block_scan`` applied wave by wave with the in-wave coupling
zeroed and the wave's rank-W fold before the next wave
(``wave_reference``).  The sweep tests patch
``gmrm_tpu.ops.scan_kernel_wave.make_block_scan_wave``, which
``gmrm_tpu.sampler.gibbs.marker_sweep`` imports at call time, with it: the
patched sweep is the JAX package's float64 W > 1 sweep (its Gram, update,
order and finish) with the scan at the precision asked for.  One test
records the divergence from the unpatched, narrowed run.

The JAX side runs inside ``jax.enable_x64(True)``.  On the CPU every
wrapper takes its plain float64 version; chip_smoke.py phase 7h holds
kernel E against that version on the card.

Tolerances: comp and cass exact; betas, acum and eps within rtol 1e-9,
atol 1e-11 (tests/test_torch_float64.py).
"""

import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import gmrm_tpu.ops.scan_kernel_wave as skw
from gmrm_tpu.parallel import mesh as jmesh
from gmrm_tpu.parallel.runner import _static_specs
from gmrm_tpu.sampler import gibbs as jgibbs
from gmrm_tpu.sampler.scan import BlockScanResult
from gmrm_tpu.sampler.scan import block_scan as jax_block_scan
from gmrm_tpu.sampler.state import StaticInputs as JaxStatic
from gmrm_tpu_torch import cli
from gmrm_tpu_torch import runner as trunner
from gmrm_tpu_torch.config import Options, resolve_plan
from gmrm_tpu_torch.io.writers import read_history
from gmrm_tpu_torch.ops import _build
from gmrm_tpu_torch.ops import scan_kernel_wave as sw
from gmrm_tpu_torch.parallel import runner as prunner
from gmrm_tpu_torch.parallel.distributed import Communicator
from gmrm_tpu_torch.parallel.runner import run_training_sharded
from gmrm_tpu_torch.sampler.dists import RngPlan
from gmrm_tpu_torch.sampler.gibbs import (
    _sweep_draws, marker_sweep, marker_sweep_sharded,
)
from gmrm_tpu_torch.sampler.scan import block_scan_wave
from gmrm_tpu_torch.sampler.state import (
    pi_prior_from_cva, state_from_numpy, static_from_numpy,
)
from test_scan_kernel import _random_case
from test_torch_float64 import _leaves, _opt, _outputs, _sweep_inputs
from test_torch_float64 import setup64  # noqa: F401  (a fixture)
from test_torch_float64 import shard_sim64  # noqa: F401  (a fixture)
from test_torch_sharded import _global_inputs

torch.set_num_threads(2)

CPU = torch.device("cpu")
F64 = torch.float64
RTOL, ATOL = 1e-9, 1e-11


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def wave_reference(wave):
    """``make_block_scan_wave(wave)``'s float64 reference: the JAX
    package's XLA ``block_scan`` on each wave of ``wave`` markers in turn,
    blind to each other (a zero in-wave Gram), each against c plus the
    folds of the earlier waves, and the wave's rank-W fold
    ``corr[t, i] += sum_j dbeta[t, j] gs[t, j, i]`` before the next
    (tests/test_scan_kernel.py:87-124 in jnp, in the operands' dtype, so
    that it traces under ``jit`` and ``shard_map``).  Accepts and ignores
    the ``axis_name`` and ``interpret`` keywords the sweep passes."""
    def scan(c, gs, beta_old, comp_old, acum_old, grp, valid, u, z, sigmag,
             sigmae, pi_est, cva, cvai, nonas, n_total, axis_name=None,
             interpret=False):
        T, B = c.shape
        corr = jnp.zeros_like(c)
        parts, cass = [], None
        for w0 in range(0, B, wave):
            s = slice(w0, w0 + wave)
            sub = jax_block_scan(
                c[:, s] + corr[:, s], jnp.zeros((T, wave, wave), c.dtype),
                beta_old[:, s], comp_old[:, s], acum_old[:, s], grp[s],
                valid[s], u[:, s], z[:, s], sigmag, sigmae, pi_est, cva,
                cvai, nonas, n_total)
            parts.append(sub)
            cass = sub.cass_inc if cass is None else cass + sub.cass_inc
            corr = corr + jnp.einsum("tw,twb->tb", sub.dbeta_eff,
                                     gs[:, s, :])

        def cat(name):
            return jnp.concatenate([getattr(p, name) for p in parts], axis=1)
        return BlockScanResult(
            dbeta_eff=cat("dbeta_eff"), beta_new=cat("beta_new"),
            comp_new=cat("comp_new"), acum_new=cat("acum_new"),
            cass_inc=cass)
    return scan


# --------------------------------------------------------------------------
# Kernel E's plain version
# --------------------------------------------------------------------------

def _scan_case(seed, T, B, K):
    """tests/test_scan_kernel.py's case at float64 with an adaV group and
    a strong symmetric Gram, so that the waves' blindness moves draws."""
    rng = np.random.default_rng(seed)
    args = [np.asarray(x) for x in _random_case(rng, T, B, 2, K)]
    args = [x.astype(np.float64) if x.dtype == np.float32 else x
            for x in args]
    gs = rng.normal(size=(T, B, B)) * 2.0
    args[1] = (gs + gs.transpose(0, 2, 1)) / 2
    args[9][1, 0] = 0.0                                 # an adaV group
    return args


@pytest.mark.parametrize("W", [4, 8, 32])
def test_wave_scan_plain_matches_jax_wave_reference_at_f64(W):
    """Kernel E's plain version, through sampler/scan.block_scan_wave (the
    one-block counterpart of ``make_block_scan_wave``), against the float64
    wave reference on a block of 32 markers (64 at W=32, two waves): comp
    and cass exact, the rest
    within the float64 tolerance; and the relaxation matters: the serial
    scan of the same block lands farther from it than 10^4 times the
    tolerance's atol."""
    T, B, K = 3, 64 if W == 32 else 32, 4
    args = _scan_case(100 + W, T, B, K)
    with jax.enable_x64(True):
        jargs = [jnp.asarray(a) for a in args]
        want = jax.device_get(wave_reference(W)(*jargs))
        serial = jax.device_get(jax_block_scan(*jargs))
    assert want.beta_new.dtype == np.float64
    got = block_scan_wave(*[_t(a) for a in args[:15]], float(args[15]),
                          wave=W)
    assert got.beta_new.dtype == got.dbeta_eff.dtype == F64
    np.testing.assert_array_equal(got.comp_new.numpy(), want.comp_new)
    np.testing.assert_array_equal(got.cass_inc.numpy(), want.cass_inc)
    for name in ("dbeta_eff", "beta_new", "acum_new"):
        _close(getattr(got, name).numpy(), getattr(want, name), name)
    live = args[6][None, :] & (args[9][:, args[5]] != 0)
    assert len(np.unique(got.comp_new.numpy()[live])) > 1
    assert np.abs(got.beta_new.numpy() - serial.beta_new).max() > 1e-7


def test_wave_scan_sweep_interface_is_the_one_block_plain_at_f64():
    """WaveScanSweep on float64 CPU tensors (two blocks, base formed from
    c, beta and nonas - 1, d = msig * dbeta) gives each block the bits of
    ``wave_scan`` on that block's own tensors."""
    T, B, K, W, nb = 2, 32, 4, 8, 2
    rng = np.random.default_rng(5)

    def f(*shape):
        return torch.from_numpy(rng.normal(size=shape))
    lc, rd = f(nb, K, T, B) - 2.0, f(nb, K, T, B).abs() * 1e-3
    sqb = f(nb, K, T, B).abs() * 0.01
    beta, acum, msig = f(nb, T, B) * 0.01, f(nb, T, B).abs(), f(nb, T, B)
    u = torch.from_numpy(rng.uniform(size=(nb, T, B)))
    z = f(nb, T, B)
    comp = torch.from_numpy(rng.integers(0, K, (nb, T, B)).astype(np.int32))
    live = torch.from_numpy((rng.uniform(size=(nb, T, B)) > 0.2)
                            .astype(np.int32))
    zerob = (1 - live) * torch.from_numpy(
        (rng.uniform(size=(nb, T, B)) > 0.5).astype(np.int32))
    nm1, i2se = f(T).abs() + 100.0, f(T).abs() + 0.5
    c, gs = f(nb, T, B) * 5.0, f(nb, T, B, B) * 0.1
    sweep = sw.WaveScanSweep(nm1, lc, rd, sqb, beta, comp, acum, u, z, live,
                             zerob, msig, i2se, wave=W)
    for b in range(nb):
        sweep.step(b, c, gs, b, bc=b)
        base = c[b] + beta[b] * nm1[:, None]
        want = sw.wave_scan(base, lc[b], rd[b], sqb[b], gs[b], beta[b],
                            comp[b], acum[b], u[b], z[b], live[b], zerob[b],
                            i2se, wave=W)
        got = (sweep.dbeta[b], sweep.beta_new[b], sweep.comp_new[b],
               sweep.acum_new[b])
        assert sweep.dbeta.dtype == F64
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert torch.equal(sweep.d[b], msig[b] * got[0])


# --------------------------------------------------------------------------
# The float64 W > 1 sweep, one device and sharded
# --------------------------------------------------------------------------

def _port_sweep(setup, W, seed):
    opt, data, static, state = setup
    blocks, u, z, eps, sigmae, betas, sigmag = _sweep_inputs(
        data, static, state, seed)
    tstate = state_from_numpy(_leaves(state), CPU)
    tstatic = dataclasses.replace(
        static_from_numpy(_leaves(static), CPU),
        shared_na=all(ph.nas == 0 for ph in data.phens))
    got = marker_sweep(_t(eps.copy()), _t(betas), tstate.comp, tstate.acum,
                       _t(sigmag), _t(sigmae), tstate.pi_est, tstatic,
                       _t(blocks), _t(u), _t(z), wave=W)
    return [x.numpy() for x in got], (blocks, u, z, eps, sigmae, betas,
                                      sigmag)


def _jax_sweep(setup, W, inputs):
    opt, data, static, state = setup
    blocks, u, z, eps, sigmae, betas, sigmag = inputs
    with jax.enable_x64(True):
        out = jax.device_get(jgibbs.marker_sweep(
            jnp.asarray(eps), jnp.asarray(betas), state.comp, state.acum,
            jnp.asarray(sigmag), jnp.asarray(sigmae), state.pi_est, static,
            jnp.asarray(blocks), jnp.asarray(u), jnp.asarray(z),
            use_pallas=True,
            shared_na=all(ph.nas == 0 for ph in data.phens), wave_size=W))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("W", [8, 32])
def test_f64_wave_sweep_matches_jax_sweep(setup64, W, monkeypatch):
    """The port's float64 W > 1 sweep (4 blocks of 32, a uniform order
    with the pad slots last, an adaV group) against the JAX package's
    ``marker_sweep(use_pallas=True, wave_size=W)`` at float64, its wave
    scan patched to the float64 reference, from its own float64 state
    with the same order and draws."""
    monkeypatch.setattr(skw, "make_block_scan_wave", wave_reference)
    got, inputs = _port_sweep(setup64, W, 3000 + W)
    want = _jax_sweep(setup64, W, inputs)
    g_eps, g_beta, g_comp, g_acum, g_cass = got
    w_eps, w_beta, w_comp, w_acum, w_cass = want
    assert g_eps.dtype == g_beta.dtype == w_eps.dtype == np.float64
    assert (g_comp[:, :setup64[1].m_local] != 0).any()
    np.testing.assert_array_equal(g_comp, w_comp)
    np.testing.assert_array_equal(g_cass, w_cass)
    _close(g_beta, w_beta, "betas")
    _close(g_acum, w_acum, "acum")
    _close(g_eps, w_eps, "eps")


def test_f64_wave_sweep_against_the_narrowed_jax_run(setup64, monkeypatch,
                                                     capsys):
    """The divergence the port does not copy: the JAX package's own
    float64 W=8 sweep, whose Pallas wave scan (interpret mode) narrows the
    scan to float32, against the port's double scan and the float64
    reference.  On the draws whose comp agrees the port is within float32
    tolerance of the narrowed run (the flips are printed; none are
    expected at this size), and it is at least 10^3 times closer to the
    float64 reference than the narrowed run is."""
    W = 8
    monkeypatch.setattr(skw, "FORCE_INTERPRET", True)
    got, inputs = _port_sweep(setup64, W, 4000)
    narrowed = _jax_sweep(setup64, W, inputs)
    monkeypatch.setattr(skw, "make_block_scan_wave", wave_reference)
    ref = _jax_sweep(setup64, W, inputs)
    same = got[2] == narrowed[2]
    flips = int((~same).sum())
    with capsys.disabled():
        print(f"\nfloat64 W={W}: {flips} of {same.size} draws flipped "
              f"against the narrowed JAX run")
    np.testing.assert_allclose(got[1][same], narrowed[1][same].astype(
        np.float64), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[3][same], narrowed[3][same].astype(
        np.float64), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[0], narrowed[0], rtol=1e-4, atol=1e-5)
    for k, name in ((1, "betas"), (0, "eps")):
        port_err = np.abs(got[k] - ref[k]).max()
        narrow_err = np.abs(narrowed[k].astype(np.float64) - ref[k]).max()
        assert narrow_err > 0 and 1e3 * port_err <= narrow_err, (
            name, port_err, narrow_err)


def _sharded_inputs(sim, D, B, seed):
    """Trait 0 of ``sim`` over D shards at float64 (the JAX package's
    global arrays, tests/test_torch_sharded.py), per shard a uniform order
    of its real markers with the pad slots last and float64 draws."""
    g = _global_inputs(sim, D, B)
    mps = g["mps"]
    nblocks = mps // B
    G, K = g["cva"].shape
    rng = np.random.default_rng(seed)
    sigmag0 = rng.uniform(0.05, 0.5, size=G)
    perms = np.stack([np.concatenate([rng.permutation(ln),
                                      np.arange(ln, mps)])
                      for _, ln in g["blocks_glob"]]).reshape(D, nblocks, B)
    u = rng.uniform(size=(D, nblocks, 1, B))
    z = rng.normal(size=(D, nblocks, 1, B))
    ph = g["ph"]

    def shardpad(x):
        out = np.zeros(D * mps)
        for i, (s, ln) in enumerate(g["blocks_glob"]):
            out[i * mps:i * mps + ln] = x[s:s + ln]
        return out
    lv = g["leaves"]
    leaves = dict(lv, na=lv["na"].astype(np.float64),
                  mave=shardpad(g["mave"])[None],
                  msig=shardpad(g["msig"])[None],
                  nonas=np.asarray([float(ph.nonas)]), cva=g["cva"],
                  cvai=g["cvai"], n_total=np.float64(g["n"]))
    eps0 = g["eps0"].astype(np.float64)
    return g, leaves, perms, u, z, sigmag0, eps0


@pytest.mark.parametrize("D", [2, 4])
def test_f64_wave_sharded_sweep_matches_jax_shard_map(shard_sim64, D,
                                                      monkeypatch):
    """The float64 W=4 sharded sweep (blocks of 8: the composed kernels
    into a zeroed delta, one sum per block step) against the JAX package's
    ``marker_sweep(use_pallas=True, wave_size=4)`` under ``shard_map`` at
    float64 with the wave scan patched to the float64 reference, from the
    same global arrays, orders and draws (tests/test_torch_sharded.py:365
    at float32)."""
    if len(jax.devices()) < D:
        pytest.skip(f"needs {D} virtual devices")
    monkeypatch.setattr(skw, "make_block_scan_wave", wave_reference)
    B, W = 8, 4
    g, leaves, perms, u, z, sigmag0, eps0 = _sharded_inputs(
        shard_sim64, D, B, 808 + D)
    mps = g["mps"]
    nblocks = mps // B
    G, K = g["cva"].shape
    mesh = jmesh.make_marker_mesh(D)
    axis = jmesh.MARKER_AXIS
    pi0 = pi_prior_from_cva(g["cva"])[None]

    def sweep(eps, betas, comp, acum, sigmag, sigmae, pi_est, static,
              blocks, u_all, z_all):
        eps, betas, comp, acum, cass_local = jgibbs.marker_sweep(
            eps, betas, comp, acum, sigmag, sigmae, pi_est, static, blocks,
            u_all, z_all, axis_name=axis, use_pallas=True, shared_na=True,
            wave_size=W)
        return eps, betas, comp, acum, jax.lax.psum(cass_local, axis)

    sh, sh2, rep = P(axis), P(None, axis), P()
    with jax.enable_x64(True):
        static = JaxStatic(**{k: jnp.asarray(v) for k, v in leaves.items()})
        sweep_sh = jax.jit(jax.shard_map(
            sweep, mesh=mesh,
            in_specs=(rep, sh2, sh2, sh2, rep, rep, rep,
                      _static_specs(False), sh, sh, sh),
            out_specs=(rep, sh2, sh2, sh2, rep), check_vma=False))
        want = [np.asarray(x) for x in jax.device_get(sweep_sh(
            jnp.asarray(eps0), jnp.zeros((1, D * mps)),
            jnp.zeros((1, D * mps), jnp.int32), jnp.zeros((1, D * mps)),
            jnp.asarray(sigmag0[None]), jnp.asarray([0.6]),
            jnp.asarray(pi0), static,
            jnp.asarray(perms.reshape(D * nblocks, B).astype(np.int32)),
            jnp.asarray(u.reshape(D * nblocks, 1, B)),
            jnp.asarray(z.reshape(D * nblocks, 1, B))))]
    assert want[1].dtype == np.float64

    statics = static_from_numpy(dict(leaves, gram_cache=None), CPU,
                                n_shards=D)
    states = state_from_numpy(dict(
        eps=eps0, betas=np.zeros((1, D * mps)),
        comp=np.zeros((1, D * mps), np.int32), acum=np.zeros((1, D * mps)),
        cass=np.zeros((1, G, K), np.int32), sigmag=sigmag0[None],
        sigmae=np.asarray([0.6]), pi_est=pi0, mu=np.zeros(1),
        epssum=np.zeros(1)), CPU, n_shards=D)
    assert statics[0].gram_cache is None and states[0].eps.dtype == F64
    first = states[0]
    eps, marker_states, cass = marker_sweep_sharded(
        first.eps, [(s.betas, s.comp, s.acum) for s in states], first.sigmag,
        first.sigmae, first.pi_est, statics,
        [_t(perms[d].astype(np.int64)) for d in range(D)],
        [_t(u[d]) for d in range(D)], [_t(z[d]) for d in range(D)], wave=W,
        comm=Communicator(CPU))

    def glob(k):
        return torch.cat([ms[k] for ms in marker_states], dim=1).numpy()
    assert glob(0).dtype == np.float64 and (glob(1) != 0).any()
    np.testing.assert_array_equal(glob(1), want[2])
    np.testing.assert_array_equal(cass.numpy(), want[4])
    _close(glob(0), want[1], "betas")
    _close(glob(2), want[3], "acum")
    _close(eps.numpy(), want[0], "eps")


def test_megakernel_true_raises_at_f64_wave(setup64):
    """A float64 W > 1 sweep has no Gram cache and takes the composed path;
    ``megakernel=True`` raises, as gibbs.py:189-200 of the JAX package
    does."""
    opt, data, static, state = setup64
    blocks, u, z, eps, sigmae, betas, sigmag = _sweep_inputs(
        data, static, state, 1)
    tstate = state_from_numpy(_leaves(state), CPU)
    tstatic = static_from_numpy(_leaves(static), CPU)
    with pytest.raises(ValueError, match="megakernel=True requires.*gram_cache=None"):
        marker_sweep(_t(eps), _t(betas), tstate.comp, tstate.acum,
                     _t(sigmag), _t(sigmae), tstate.pi_est, tstatic,
                     _t(blocks), _t(u), _t(z), wave=8, megakernel=True)


# --------------------------------------------------------------------------
# The plan at 8-byte values
# --------------------------------------------------------------------------

def test_wave_plan_at_f64_anchor_summed_by_hand():
    """The anchor (T=4, B=128, K=4, W=32) at 8-byte values: one trait a
    CTA, four CTAs.  A CTA's shared memory: the mbarriers (8 values), the
    state (10 x 128), i2se and nm1 (2 x 4), two waves' dbeta (64), the
    waves' offsets (8), the tables (3 x 512) and the three foldable waves'
    packed rows (32 rows each at strides 98, 66 and 34) make 9,240
    doubles, 73,920 bytes: every fold reads shared memory.  One CTA of the
    four traits held the tables and wave 0's rows only (24,088 doubles,
    192,704 bytes).  The float32 plan is unchanged."""
    assert sw.row_stride(96, 8) == 98 and sw.row_stride(64, 8) == 66
    assert sw.row_stride(32, 8) == 34
    words = 8 + 10 * 128 + 2 * 4 + 64 + 8 + 3 * 512 + 32 * (98 + 66 + 34)
    assert words == 9240
    assert sw.wave_plan(1, 128, 4, 32, 8) == (1, 3)
    assert sw._layout_words(1, 128, 4, 32, 1, 3, 8) == words
    assert 8 * words == 73920 <= sw.SMEM_BYTES
    assert sw.launch_plan(4, 128, 4, 32, 8) == (1, 3, 1)
    assert sw.wave_plan(4, 128, 4, 32, 8) == (1, 1)
    assert 8 * sw._layout_words(4, 128, 4, 32, 1, 1, 8) == 192704
    assert sw.wave_plan(4, 128, 4, 32) == (1, 3)
    assert sw.launch_plan(4, 128, 4, 32) == (1, 3, 4)


@pytest.mark.parametrize("T,B,K,W,plan", [
    (2, 128, 4, 32, (1, 3, 1)),       # every wave's rows staged
    (4, 128, 4, 8, (1, 15, 1)),       # all 15 foldable waves' rows staged
    (16, 128, 4, 32, (1, 3, 1)),      # one CTA staged nothing: now all
    (33, 128, 4, 32, (1, 3, 1)),      # a grid of 33 trait groups
])
def test_wave_launch_plan_at_f64(T, B, K, W, plan):
    """Kernel E's launch plans: each fits a CTA's shared memory at 8-byte
    values, stages the tables and every wave's rows, and takes F64_TG
    traits a CTA (float32 takes all T in one CTA at these shapes)."""
    got = sw.launch_plan(T, B, K, W, 8)
    assert got == plan
    tab, gsw, TG = got
    cap = sw.SMEM_BYTES // 8
    assert sw._layout_words(TG, B, K, W, tab, gsw, 8) <= cap
    assert (tab, gsw) == (1, B // W - 1)
    assert TG == min(T, sw.F64_TG)
    assert sw.launch_plan(T, B, K, W)[2] == T


def test_f64_row_stride_keeps_fold_lanes_off_each_others_banks():
    """A double row's stride is 2 past a multiple of 16 values (16 bytes,
    for the bulk copies): the fold's half-warp of 8-byte loads (split
    lanes h over rows, neighbouring outputs over columns) falls on
    distinct bank pairs at a split of 8 and at most two to a pair at 4
    and 2."""
    for rest in range(1, 200):
        rs = sw.row_stride(rest, 8)
        assert rest <= rs < rest + 16 and rs % 16 == 2 and rs % 2 == 0
        for split in (8, 4, 2):
            pairs = [(h * rs + c) % 16 for h in range(split)
                     for c in range(16 // split)]
            assert max(pairs.count(p) for p in set(pairs)) <= (
                1 if split == 8 else 2)


def test_wave_scan_sweep_plans_f64_on_8_byte_values(monkeypatch):
    """WaveScanSweep on float64 (meta) tensors plans at 8-byte values (one
    trait a CTA at the anchor: a grid of four) and launches kernel E's
    entry point, a block index a launch."""
    T, B, K, W, nb = 4, 128, 4, 32, 2
    meta = torch.device("meta")

    def e(*shape, dtype=F64):
        return torch.empty(shape, dtype=dtype, device=meta)
    i32 = torch.int32
    ops = (e(T), e(nb, K, T, B), e(nb, K, T, B), e(nb, K, T, B),
           e(nb, T, B), e(nb, T, B, dtype=i32), e(nb, T, B), e(nb, T, B),
           e(nb, T, B), e(nb, T, B, dtype=i32), e(nb, T, B, dtype=i32),
           e(nb, T, B), e(T))
    scan = sw.WaveScanSweep(*ops, wave=W)
    assert scan.plan == (1, 3, 1)
    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda kernel, *args: calls.append((kernel, args)))
    scan.step(1, e(nb, T, B), e(1, T, B, B), 0, bc=1)
    assert [k for k, _ in calls] == ["wave_scan_f64"]
    assert calls[0][1][-10:] == (1, 1, 0, T, B, K, W, 1, 3, 1)
    assert "wave_scan_f64" in _build.launch_counts()
    assert _build.SIGNATURES["gmrm_wave_scan_f64"] == _build.SIGNATURES[
        "gmrm_wave_scan"]


# --------------------------------------------------------------------------
# The run: order, startup, command line, checkpoints, cache
# --------------------------------------------------------------------------

def test_f64_wave_shuffle_is_uniform():
    """At float64 W > 1 (no Gram cache) the sweep's order is the uniform
    one of W = 1 (pad slots last, stream ``marker_order``), as the JAX
    package's ``block_mode`` requires float32; with a Gram cache (float32
    W > 1) it is the block-preserving shuffle."""
    nblocks, B, m_local, T = 5, 8, 37, 2
    plan = RngPlan(7, CPU)

    def order(wave, dtype, gram_cache):
        state = SimpleNamespace(
            betas=torch.zeros(T, nblocks * B, dtype=dtype),
            eps=torch.zeros(T, 1, 1, dtype=dtype))
        static = SimpleNamespace(m_local=m_local, gram_cache=gram_cache)
        return _sweep_draws(state, static, 3, plan, B, wave, True)[0]

    f64 = order(4, F64, None)
    assert torch.equal(f64, order(1, F64, None))
    flat = f64.reshape(-1)
    assert sorted(flat[:m_local].tolist()) == list(range(m_local))
    assert flat[m_local:].tolist() == list(range(m_local, nblocks * B))
    assert (flat[:m_local] // B != torch.arange(m_local) // B).any()
    f32 = order(4, torch.float32, torch.zeros(1))
    assert all(len(set((row // B).tolist())) == 1 for row in f32)


@pytest.mark.parametrize("shards", [1, 2])
def test_no_gram_cache_at_f64_wave(sim_small, tmp_path, shards):
    """A float64 W > 1 run builds no Gram cache (one device and per shard)
    and stores the markers block-interleaved; float32 W > 1 builds one."""
    for dtype, cached in (("float64", False), ("float32", True)):
        opt = _opt(sim_small, "", dtype=dtype, block_size=16, wave_size=8)
        opt.validate()
        opt.load_group_mixtures()
        resolve_plan(opt, "cpu", sim_small.m // shards)
        assert opt.wave_size == 8 and trunner.gram_cached(opt) == cached
        if shards == 1:
            data = trunner.load_data(opt)
            statics = [trunner.build_static(data, opt, CPU)]
            inv = data.inv_order
        else:
            data = prunner.load_data_process(opt, shards, interleave=True)
            statics = prunner.build_static_sharded(data, opt, CPU)
            inv = data.inv_orders[0]
        assert all((s.gram_cache is not None) == cached for s in statics)
        assert not np.array_equal(inv, np.arange(len(inv)))
        if dtype == "float64":
            assert statics[0].mave.dtype == F64


def _argv(sim, out, *extra):
    return ["--bed-file", sim.bed, "--dim-file", sim.dim, "--phen-files",
            ",".join(sim.phens), "--group-index-file", sim.gri,
            "--group-mixture-file", sim.grm, "--block-size", "64",
            "--wave-size", "32", "--dtype", "float64", "--seed", "9",
            "--verbosity", "-1", "--out-dir", out, *extra]


@pytest.mark.parametrize("devices", ["1", "2"])
def test_cli_trains_f64_wave(sim_small, tmp_path, devices):
    """python -m gmrm_tpu_torch --dtype float64 --wave-size 32 (blocks of
    64: two waves a block) trains, on one device and with --devices 2 (no
    SliceNotCovered), writes finite .bet histories, and two runs of one
    seed write the same bytes."""
    outs = [str(tmp_path / f"o{i}") for i in range(2)]
    for out in outs:
        assert cli.main(_argv(sim_small, out, "--iterations", "3",
                              "--devices", devices), device="cpu") == 0
    its, bet = read_history(os.path.join(outs[0], "test1.bet"), "f8")
    assert list(its) == [1, 2, 3] and np.isfinite(bet).all()
    assert (bet != 0).any()
    assert _outputs(outs[0], sim_small) == _outputs(outs[1], sim_small)


@pytest.mark.parametrize("shards", [1, 2])
def test_f64_wave_chain_resumes_byte_equal(sim_small, tmp_path, shards):
    """A float64 W=8 chain cut at 2 with a checkpoint and resumed to 5
    writes the bytes of the uninterrupted chain, on one device and at S=2;
    the checkpoint's layout stamps interleave 1 at the wave."""
    from gmrm_tpu_torch import checkpoint

    def run(out, **kw):
        opt = _opt(sim_small, out, **{"iterations": 5, "wave_size": 8,
                                      **kw})
        if shards == 1:
            return trunner.run_training(opt, device="cpu", verbose=False)
        return run_training_sharded(opt, n_devices=shards, device="cpu",
                                    verbose=False)

    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")
    whole = run(full)
    run(cut, iterations=2, checkpoint_every=2)
    opt = _opt(sim_small, cut, wave_size=8)
    layout = checkpoint.layout_of(opt, sim_small.m)
    assert layout["interleave"] == 1 and layout["wave_size"] == 8
    res = run(cut, resume=True)
    assert res.iters_run == 3
    st = res.state if shards == 1 else res.state[0]
    assert st.eps.dtype == st.betas.dtype == F64
    assert _outputs(cut, sim_small) == _outputs(full, sim_small)
    w = whole.state if shards == 1 else whole.state[0]
    assert torch.equal(st.eps, w.eps)


def test_f32_wave_cache_entry_is_not_served_to_f64_wave(sim_small,
                                                        tmp_path):
    """A float32 W > 1 run's --cache-dir entry (statistics and Gram cache)
    is not served to a float64 W > 1 run of the same data: the float64 run
    goes cold, keeps no Gram cache and gets float64 statistics equal to a
    build without the cache; its own entry then serves it warm."""
    cache_dir = str(tmp_path / "cache")

    def static_of(dtype, cache=""):
        opt = _opt(sim_small, "", dtype=dtype, block_size=16, wave_size=8,
                   cache_dir=cache)
        opt.validate()
        opt.load_group_mixtures()
        resolve_plan(opt, "cpu", sim_small.m)
        data = trunner.load_data(opt)
        entry = trunner.startup_cache(data, opt)
        return trunner.build_static(data, opt, CPU, entry), entry

    s32, c32 = static_of("float32", cache_dir)
    assert not c32.warm and s32.gram_cache is not None
    s64, c64 = static_of("float64", cache_dir)
    assert not c64.warm and c64.path != c32.path
    assert s64.gram_cache is None and s64.mave.dtype == F64
    bare, _ = static_of("float64")
    assert torch.equal(s64.mave, bare.mave)
    assert torch.equal(s64.msig, bare.msig)
    warm, c64b = static_of("float64", cache_dir)
    assert c64b.warm and warm.gram_cache is None
    assert torch.equal(warm.mave, bare.mave)
