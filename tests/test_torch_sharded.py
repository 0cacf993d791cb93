"""The marker-sharded path of the port against the JAX package.

- the fused per-block kernel's plain version (``block_sweep`` on CPU
  tensors) against ``block_sweep_pallas`` in interpret mode, and chained
  over a shard's blocks against the port's whole-sweep and composed paths;
- the sharded sweep against ``marker_sweep`` under ``shard_map`` with
  ``fused=True`` on the virtual CPU mesh (W > 1) and against the NumPy
  replay oracle ``oracle.sweep_replay_sharded`` (W = 1), all with injected
  order and draws;
- ``run_training_sharded`` end to end, two gloo processes against one, and
  the options the sharded path refuses or takes.

Tolerances: ``comp`` and ``cass`` exact; beta and acum rtol 1e-5 / atol
1e-6 and the residual rtol 1e-4 / atol 1e-5 against the JAX sharded sweep
(tests/test_sharding.py:476-481); against the TPU kernel alone the delta
carries the bf16 hi/lo split error of its products
(tests/test_torch_serial.py), so it is held relative to the largest delta.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

import gmrm_tpu.ops.pallas_kernels as pk
import gmrm_tpu.ops.scan_kernel_wave as skw
import gmrm_tpu.ops.sweep_kernel as swk
from gmrm_tpu import oracle
from gmrm_tpu.config import Options as JaxOptions
from gmrm_tpu.io.bed import decode_planes, read_bed, unpack_codes
from gmrm_tpu.io.grouping import read_dim, read_group_index
from gmrm_tpu.io.phen import read_phen
from gmrm_tpu.io.sim import simulate
from gmrm_tpu.io.writers import read_history
from gmrm_tpu.ops.decode import from_phase_planes, to_phase_planes
from gmrm_tpu.parallel import mesh as jmesh
from gmrm_tpu.parallel.runner import _static_specs
from gmrm_tpu.runner import build_static, init_sampler_state, load_data
from gmrm_tpu.sampler import gibbs as jgibbs
from gmrm_tpu.sampler.state import StaticInputs as JaxStatic
from gmrm_tpu.sampler.state import pad_bed, pi_prior_from_cva
from gmrm_tpu_torch import cli
from gmrm_tpu_torch.config import Options
from gmrm_tpu_torch.ops.sweep_kernel import (
    block_sweep, build_sweep_tables, sweep_blocks,
)
from gmrm_tpu_torch.parallel import mesh as tmesh
from gmrm_tpu_torch.parallel.distributed import (
    Communicator, local_shard_ids,
)
from gmrm_tpu_torch.parallel.runner import run_training_sharded
from gmrm_tpu_torch.sampler.dists import RngPlan
from gmrm_tpu_torch.sampler.gibbs import (
    gibbs_iteration_sharded, marker_sweep, marker_sweep_sharded,
)
from gmrm_tpu_torch.sampler.state import state_from_numpy, static_from_numpy

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CPU = torch.device("cpu")


def _interpret(monkeypatch):
    for mod in (pk, skw, swk):
        monkeypatch.setattr(mod, "FORCE_INTERPRET", True)


def _leaves(x):
    return {k: (None if v is None else np.asarray(v))
            for k, v in vars(x).items() if k != "key"}


# --------------------------------------------------------------------------
# Kernel 9 alone, on one device's arrays
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[0.02, 0.0], ids=["na", "no_na"])
def block_setup(request, tmp_path_factory):
    """One device's JAX static inputs and start state: 120 markers in 4
    blocks of 32 (8 pad slots in the last), 2 traits, 2 groups; NT = T with
    phenotype NAs, NT = 1 without."""
    sim = simulate(str(tmp_path_factory.mktemp("blocksweep")), n=600, m=120,
                   n_traits=2, n_causal=32, h2=0.5, n_groups=2,
                   na_rate=request.param, seed=7)
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
    assert int(static.m_local) == 120 and state.betas.shape[1] == 128
    return opt, data, static, state


def _sweep_inputs(setup, wave):
    """NumPy operands of one sweep: order, draws, a non-zero beta and a
    group whose variance is 0 for trait 1 (adaV)."""
    opt, data, static, state = setup
    B = opt.block_size
    T, m_pad = state.betas.shape
    nblocks = m_pad // B
    rng = np.random.default_rng(4242 + wave)
    eps = np.asarray(state.eps)
    nonas = np.asarray(static.nonas)
    sigmag = np.asarray(state.sigmag).copy()
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


def _port_operands(setup, x):
    opt, data, static, state = setup
    ts = static_from_numpy(_leaves(static), CPU)
    st = state_from_numpy(_leaves(state), CPU)
    sigmag = torch.from_numpy(x["sigmag"])
    sigmae = torch.from_numpy(x["sigmae"])
    tables = build_sweep_tables(sigmag, sigmae, st.pi_est, ts.cva, ts.cvai,
                                ts.nonas, ts.n_total)
    return ts, st, sigmag, sigmae, tables


@pytest.mark.parametrize("wave", [8, 32])
def test_block_sweep_matches_pallas_block_kernel(block_setup, wave,
                                                 monkeypatch):
    """Every block of the shard (one with pad slots, an adaV group) through
    ``block_sweep`` and ``block_sweep_pallas`` on the same residual: from
    the shard's whole arrays and from copies of the block's own slices
    (the port updates the marker state it is given in place)."""
    _interpret(monkeypatch)
    opt, data, static, state = block_setup
    x = _sweep_inputs(block_setup, wave)
    B = opt.block_size
    T = state.betas.shape[0]
    jt = swk.build_sweep_tables(
        jnp.asarray(x["sigmag"]), jnp.asarray(x["sigmae"]), state.pi_est,
        static.cva, static.cvai, static.nonas, static.n_total)
    ts, st, sigmag, sigmae, tables = _port_operands(block_setup, x)
    nt = ts.gram_cache.shape[1]
    assert nt == (1 if x["shared_na"] else T)
    eps = torch.from_numpy(x["eps"].copy())
    i2se = 1.0 / (2.0 * sigmae)
    whole = (torch.from_numpy(x["betas"].copy()), st.comp.clone(),
             st.acum.clone())
    drawn = set()
    for b in range(x["pi_b"].size):
        blk = int(x["pi_b"][b])
        rows = slice(blk * B, (blk + 1) * B)
        want = jax.device_get(swk.block_sweep_pallas(
            blk, static.m_local, static.bed[rows], jnp.asarray(x["win"][b]),
            static.gram_cache[blk:blk + 1], jnp.asarray(x["eps"]), static.na,
            static.mave[:, rows], static.msig[:, rows],
            jnp.asarray(x["betas"][:, rows]), state.comp[:, rows],
            state.acum[:, rows], static.group_of[rows],
            jnp.asarray(x["u"][b]), jnp.asarray(x["z"][b]),
            jnp.asarray(x["sigmag"]), *jt,
            (1.0 / (2.0 * jnp.asarray(x["sigmae"])))[:, None],
            static.nonas.astype(jnp.float32)[:, None], wave=wave,
            shared_na=x["shared_na"], interpret=True))
        tail = (torch.from_numpy(x["u"][b]), torch.from_numpy(x["z"][b]),
                sigmag, *tables, i2se, ts.nonas)
        sl = block_sweep(
            blk, ts.m_local, ts.bed[rows], torch.from_numpy(x["win"][b]),
            ts.gram_cache[blk:blk + 1], eps, ts.na, ts.mave[:, rows],
            ts.msig[:, rows], torch.from_numpy(x["betas"][:, rows].copy()),
            st.comp[:, rows].clone(), st.acum[:, rows].clone(),
            ts.group_of[rows], *tail, wave=wave)
        got = block_sweep(
            torch.tensor([blk]), torch.tensor([ts.m_local]), ts.bed,
            torch.from_numpy(x["win"][b]), ts.gram_cache, eps, ts.na,
            ts.mave, ts.msig, *whole, ts.group_of, *tail, wave=wave)
        assert got[1] is whole[0]
        np.testing.assert_array_equal(eps.numpy(), x["eps"])  # read-only
        for a, w in zip(sl, got):
            w = w if w.shape == a.shape else w[:, rows]
            assert torch.equal(a, w)
        np.testing.assert_array_equal(sl[2].numpy(), want[2])
        np.testing.assert_allclose(sl[1].numpy(), want[1], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(sl[3].numpy(), want[3], rtol=1e-5,
                                   atol=1e-6)
        scale = max(float(np.abs(want[0]).max()), 1e-3)
        np.testing.assert_allclose(sl[0].numpy(), want[0], rtol=1e-4,
                                   atol=1e-4 * scale)
        drawn |= set(want[2].reshape(-1).tolist())
    assert len(drawn) > 1
    beta, acum = whole[0].numpy(), whole[2].numpy()
    adav = (ts.group_of.numpy() == 0) & (np.arange(beta.shape[1])
                                         < ts.m_local)
    assert adav.any() and (beta[1, adav] == 0).all()
    assert (acum[1, adav] == 1).all()
    # Pad slots keep their state.
    np.testing.assert_array_equal(beta[:, ts.m_local:],
                                  x["betas"][:, ts.m_local:])


@pytest.mark.parametrize("wave", [8, 32])
def test_block_sweep_chain_matches_whole_sweep(block_setup, wave):
    """``block_sweep`` chained over all blocks of one shard, the residual
    moved by each delta, is the port's whole sweep: against ``sweep_blocks``
    and the composed path (tests/test_sweep_kernel.py:206 pattern)."""
    opt, data, static, state = block_setup
    x = _sweep_inputs(block_setup, wave)
    B = opt.block_size
    ts, st, sigmag, sigmae, tables = _port_operands(block_setup, x)
    nt = ts.gram_cache.shape[1]
    i2se = 1.0 / (2.0 * sigmae)
    eps = torch.from_numpy(x["eps"].copy())
    chain = (torch.from_numpy(x["betas"].copy()), st.comp.clone(),
             st.acum.clone())
    for b in range(x["pi_b"].size):
        deps = block_sweep(
            torch.from_numpy(x["pi_b"][b:b + 1]), ts.m_local, ts.bed,
            torch.from_numpy(x["win"][b]), ts.gram_cache, eps, ts.na,
            ts.mave, ts.msig, *chain, ts.group_of,
            torch.from_numpy(x["u"][b]), torch.from_numpy(x["z"][b]),
            sigmag, *tables, i2se, ts.nonas, wave=wave)[0]
        eps += deps
    whole = sweep_blocks(
        ts.bed, torch.from_numpy(x["pi_b"]), torch.from_numpy(x["win"]),
        ts.m_local, ts.gram_cache, torch.from_numpy(x["eps"].copy()),
        ts.na[:nt].contiguous(), ts.mave, ts.msig,
        torch.from_numpy(x["betas"]), st.comp, st.acum, ts.group_of,
        torch.from_numpy(x["u"]), torch.from_numpy(x["z"]), sigmag, *tables,
        i2se, ts.nonas, wave=wave)
    blocks = x["pi_b"][:, None] * B + x["win"]
    composed = marker_sweep(
        torch.from_numpy(x["eps"].copy()), torch.from_numpy(x["betas"]),
        st.comp, st.acum, sigmag, sigmae, st.pi_est, ts,
        torch.from_numpy(blocks), torch.from_numpy(x["u"]),
        torch.from_numpy(x["z"]), wave=wave, megakernel=False)
    for want in (whole, composed):
        assert torch.equal(chain[1], want[2])
        np.testing.assert_allclose(chain[0].numpy(), want[1].numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(chain[2].numpy(), want[3].numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(eps.numpy(), want[0].numpy(), rtol=1e-4,
                                   atol=1e-5)
    assert (chain[1][:, :ts.m_local] != 0).any()


# --------------------------------------------------------------------------
# The sharded sweep
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shard_sim(tmp_path_factory):
    """98 markers: 4 shards of 25, 25, 24, 24 and 8 shards of 13, 13, 12,
    ...: remainder markers either way."""
    return simulate(str(tmp_path_factory.mktemp("shardsim")), n=402, m=98,
                    n_traits=2, n_causal=24, h2=0.5, n_groups=2,
                    na_rate=0.03, seed=20260817,
                    mixtures=np.array([0.0, 0.001, 0.01, 0.05]))


def _global_inputs(sim, D, B, mb_pad=None):
    """The JAX package's global sharded arrays for trait 0 of ``sim`` over
    D shards (tests/test_sharding.py:100-165), statistics from the
    oracle."""
    n, m = read_dim(sim.dim)
    bed = read_bed(sim.bed, n, m)
    mb = bed.shape[1]
    mb_pad = mb_pad or mb
    ph = read_phen(sim.phens[0], n)
    napad = ph.na_vector_padded()
    a, b = decode_planes(unpack_codes(bed, 4 * mb))
    a, b = a * napad, b * napad
    mave, msig = oracle.marker_stats(a, b, napad, ph.nonas)
    opt = JaxOptions(group_mixture_file=sim.grm)
    opt.load_group_mixtures()
    G, K = opt.cva.shape
    gidx = read_group_index(sim.gri, G)
    blocks_glob = jmesh.marker_blocks(m, D)
    mps = -(-max(ln for _, ln in blocks_glob) // B) * B

    def shardpad(x):
        out = np.zeros(D * mps, dtype=np.float64)
        for i, (s, ln) in enumerate(blocks_glob):
            out[i * mps:i * mps + ln] = x[s:s + ln]
        return out

    def planes(vec):
        out = np.zeros((1, 4, mb_pad))
        out[0, :, :mb] = to_phase_planes(vec)
        return out.astype(np.float32)

    leaves = dict(
        bed=np.concatenate([pad_bed(bed[s:s + ln], mps, mb_pad)
                            for s, ln in blocks_glob], axis=0),
        na=planes(napad),
        mave=shardpad(mave)[None].astype(np.float32),
        msig=shardpad(msig)[None].astype(np.float32),
        group_of=shardpad(gidx).astype(np.int32),
        mtotgrp=np.bincount(gidx, minlength=G).astype(np.int32),
        nonas=np.asarray([ph.nonas], np.float32),
        cva=opt.cva.astype(np.float32), cvai=opt.cvai.astype(np.float32),
        n_total=np.float32(n),
        m_local=np.asarray([ln for _, ln in blocks_glob], np.int32))
    return dict(n=n, m=m, a=a, b=b, napad=napad, mave=mave, msig=msig,
                gidx=gidx, cva=opt.cva, cvai=opt.cvai, ph=ph,
                blocks_glob=blocks_glob, mps=mps, leaves=leaves,
                eps0=planes(ph.epsilon_padded()))


def _gather(x, g):
    x = np.asarray(x)[0]
    return np.concatenate([x[i * g["mps"]:i * g["mps"] + ln]
                           for i, (s, ln) in enumerate(g["blocks_glob"])])


def _port_sharded_sweep(g, D, leaves, blocks, u, z, sigmag0, wave,
                        megakernel=None):
    """The port's sharded sweep from the JAX package's global arrays:
    ``blocks``/``u``/``z`` (D, nblocks, ...) per shard."""
    statics = static_from_numpy(leaves, CPU, n_shards=D)
    mps = g["mps"]
    G, K = g["cva"].shape
    state = dict(eps=g["eps0"], betas=np.zeros((1, D * mps), np.float32),
                 comp=np.zeros((1, D * mps), np.int32),
                 acum=np.zeros((1, D * mps), np.float32),
                 cass=np.zeros((1, G, K), np.int32),
                 sigmag=sigmag0[None].astype(np.float32),
                 sigmae=np.asarray([0.6], np.float32),
                 pi_est=pi_prior_from_cva(g["cva"])[None], mu=np.zeros(1),
                 epssum=np.zeros(1))
    states = state_from_numpy(state, CPU, n_shards=D)
    assert len(states) == D and all(s.eps is states[0].eps for s in states)
    assert [s.m_local for s in statics] == [ln for _, ln in g["blocks_glob"]]
    first = states[0]
    eps, marker_states, cass = marker_sweep_sharded(
        first.eps, [(s.betas, s.comp, s.acum) for s in states], first.sigmag,
        first.sigmae, first.pi_est, statics,
        [torch.from_numpy(blocks[d].astype(np.int64)) for d in range(D)],
        [torch.from_numpy(u[d]) for d in range(D)],
        [torch.from_numpy(z[d]) for d in range(D)], wave=wave,
        comm=Communicator(CPU), megakernel=megakernel)

    def glob(k):
        return torch.cat([ms[k] for ms in marker_states], dim=1).numpy()
    return eps.numpy(), glob(0), glob(1), glob(2), cass.numpy()


@pytest.mark.parametrize("D", [4, 8])
def test_sharded_sweep_matches_jax_fused_shard_map(shard_sim, D,
                                                   monkeypatch):
    """The W > 1 sharded sweep (kernel 9 per shard and block step, one sum
    of the deltas per step) against ``marker_sweep(fused=True)`` under
    ``shard_map`` (tests/test_sharding.py:432-471), from the same global
    arrays, per-shard Gram caches, block and row orders and draws."""
    _interpret(monkeypatch)
    if len(jax.devices()) < D:
        pytest.skip(f"needs {D} virtual devices")
    B, W = 8, 4
    g = _global_inputs(shard_sim, D, B, mb_pad=512)
    mps = g["mps"]
    nblocks = mps // B
    mesh = jmesh.make_marker_mesh(D)
    axis = jmesh.MARKER_AXIS
    f32 = jnp.float32
    lv = g["leaves"]
    cache_fn = jax.jit(jax.shard_map(
        lambda bb, nn: swk.build_gram_cache(bb, nn, block_size=B,
                                            shared_na=True),
        mesh=mesh, in_specs=(P(axis), P()), out_specs=P(axis),
        check_vma=False))
    gram_cache = cache_fn(jnp.asarray(lv["bed"]), jnp.asarray(lv["na"]))
    static = JaxStatic(gram_cache=gram_cache,
                       **{k: jnp.asarray(v) for k, v in lv.items()})

    rng = np.random.default_rng(99 + D)
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
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    np.testing.assert_array_equal(got[4], np.asarray(want[4]))
    assert (got[2] != 0).any()
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[3], np.asarray(want[3]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-4,
                               atol=1e-5)
    # The composed kernels at the sharded cadence give the same sweep.
    comp = _port_sharded_sweep(g, D, leaves, perm, u, z, sigmag0, W,
                               megakernel=False)
    np.testing.assert_array_equal(comp[2], got[2])
    np.testing.assert_array_equal(comp[4], got[4])
    np.testing.assert_allclose(comp[0], got[0], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("D,block_size", [(8, 1), (8, 4), (4, 4)])
def test_sharded_serial_sweep_matches_replay_oracle(shard_sim, D,
                                                    block_size):
    """The W = 1 sharded sweep against the NumPy D-rank replay oracle at
    exact cadence with injected randomness
    (tests/test_sharding.py:73): B = 1 is the reference's per-marker
    Allgatherv protocol (bayes.cpp:500-553), B = 4 the blocked mode.
    Discrete choices must match exactly."""
    B = block_size
    g = _global_inputs(shard_sim, D, B)
    mps = g["mps"]
    nblocks = mps // B
    G, K = g["cva"].shape
    rng = np.random.default_rng(4711 + D + B)
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

    blocks = np.stack([p.reshape(nblocks, B) for p in perms])
    u = np.stack([x.reshape(nblocks, 1, B) for x in us]).astype(np.float32)
    z = np.stack([x.reshape(nblocks, 1, B) for x in zs]).astype(np.float32)
    leaves = dict(g["leaves"], gram_cache=None)
    eps, betas, comp, acum, cass = _port_sharded_sweep(
        g, D, leaves, blocks, u, z, sigmag0, 1)
    np.testing.assert_array_equal(_gather(comp, g), ost.comp,
                                  err_msg="component choices diverged")
    np.testing.assert_array_equal(cass[0], ost.cass)
    np.testing.assert_allclose(_gather(betas, g), ost.betas, rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(_gather(acum, g), ost.acum, rtol=5e-3,
                               atol=5e-4)
    np.testing.assert_allclose(from_phase_planes(eps)[0], ost.eps,
                               rtol=5e-3, atol=2e-3)


@pytest.mark.parametrize("run", [1, 3, 7])
def test_sharded_gram_regrouping_cannot_move_a_chain(shard_sim, monkeypatch,
                                                     run):
    """One 2-shard W = 1 sweep (7 blocks of 8 per shard, the last with pad
    slots) with the Grams built ahead in runs of 1, 3 and all blocks:
    eps, betas, comp, acum and cass bit-equal to the same sweep with every
    block's Gram built on its own inside the loop."""
    from gmrm_tpu_torch.ops.block_gram import block_gram_scaled_plain
    from gmrm_tpu_torch.sampler import gibbs as tgibbs

    D, B = 2, 8
    g = _global_inputs(shard_sim, D, B)
    nblocks = g["mps"] // B
    assert nblocks == 7
    rng = np.random.default_rng(31)
    blocks = np.stack([
        np.concatenate([rng.permutation(ln), np.arange(ln, g["mps"])])
        .reshape(nblocks, B) for _, ln in g["blocks_glob"]])
    u = rng.uniform(size=(D, nblocks, 1, B)).astype(np.float32)
    z = rng.normal(size=(D, nblocks, 1, B)).astype(np.float32)
    sigmag0 = rng.uniform(0.05, 0.5, size=g["cva"].shape[0])
    leaves = dict(g["leaves"], gram_cache=None)

    def per_block_in_loop(bed, rows_all, na_in, mave_p, msig_p):
        eps0 = torch.zeros((mave_p.shape[1], 4, bed.shape[1]))
        return torch.stack([
            block_gram_scaled_plain(bed, rows_all[n], eps0, na_in, mave_p[n],
                                    msig_p[n])[1]
            for n in range(rows_all.shape[0])])

    monkeypatch.setattr(tgibbs, "gram_run_blocks", lambda *a: run)
    got = _port_sharded_sweep(g, D, leaves, blocks, u, z, sigmag0, 1)
    monkeypatch.setattr(tgibbs, "gram_run_blocks", lambda *a: 1)
    monkeypatch.setattr(tgibbs, "blocks_gram_scaled", per_block_in_loop)
    want = _port_sharded_sweep(g, D, leaves, blocks, u, z, sigmag0, 1)
    assert (got[2] != 0).any()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# The partition, the shard-keyed draws and the shard -> process map
# --------------------------------------------------------------------------

def test_partition_matches_the_jax_package():
    arr = np.arange(3 * 23).reshape(23, 3)
    for m, d in ((23, 4), (96, 8), (5, 8), (250, 4)):
        assert tmesh.marker_blocks(m, d) == jmesh.marker_blocks(m, d)
    np.testing.assert_array_equal(tmesh.shard_markers(arr, 4, 8, -1),
                                  jmesh.shard_markers(arr, 4, 8, -1))
    assert local_shard_ids(5) == [0, 1, 2, 3, 4]     # one process: all local
    comm = Communicator(CPU)                         # no group: identity
    x = torch.ones(3)
    assert comm.all_reduce_sum(x) is x and x.sum() == 3
    assert comm.all_gather_flags(True) == [True]
    comm.barrier("nothing to wait for")


def test_rng_plan_keys_only_the_sweep_draws_by_shard():
    """The shuffle and the sweep's draws differ from shard to shard; the
    hyperparameter draws do not, and nothing depends on which process or
    local position a shard has."""
    def draw(plan, purpose):
        return torch.rand(4, generator=plan.gen(3, purpose))
    a, b, again = RngPlan(5, "cpu", 0), RngPlan(5, "cpu", 1), RngPlan(
        5, "cpu", 1)
    for purpose in ("block_order", "row_order", "marker_order", "u", "z"):
        assert not torch.equal(draw(a, purpose), draw(b, purpose))
        assert torch.equal(draw(b, purpose), draw(again, purpose))
    for purpose in ("init", "mu", "sigmag", "pi", "sigmae"):
        assert torch.equal(draw(a, purpose), draw(b, purpose))
        assert torch.equal(draw(a, purpose),
                           draw(RngPlan(5, "cpu"), purpose))


# --------------------------------------------------------------------------
# End to end
# --------------------------------------------------------------------------

def _opt(sim, out_dir, **kw):
    base = dict(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                group_index_file=sim.gri, group_mixture_file=sim.grm,
                iterations=30, seed=42, out_dir=out_dir, block_size=16,
                output_thin_rate=3)
    base.update(kw)
    return Options(**base)


@pytest.mark.parametrize("wave,resolved", [(8, 8), (None, 1)],
                         ids=["wave8", "auto"])
def test_run_training_sharded_cpu(sim_medium, tmp_path, wave, resolved):
    """S = 4 on the CPU, an explicit wave and the auto plan (which falls to
    W = 1: 4 blocks per shard): a finite chain, artifacts of the right
    shape in original marker order, h2 in the single-device test's range
    and posterior means that track the true effects."""
    out = str(tmp_path / "out")
    opt = _opt(sim_medium, out, wave_size=wave)
    res = run_training_sharded(opt, n_devices=4, device="cpu", verbose=False)
    assert opt.wave_size == resolved
    assert len(res.state) == 4 and res.iters_run == 30
    assert "block_sweep" in res.kernel_launches
    assert set(res.kernel_launches.values()) == {0}      # CPU: plain only
    assert all(s.eps is res.state[0].eps for s in res.state)
    m = sim_medium.m
    for t, ph in enumerate(sim_medium.phens):
        base = os.path.join(out, os.path.splitext(os.path.basename(ph))[0])
        its, bet = read_history(base + ".bet", "f8")
        _, cpn = read_history(base + ".cpn", "i4")
        assert list(its) == list(range(3, 31, 3))
        assert bet.shape == (10, m) and cpn.shape == (10, m)
        assert np.isfinite(bet).all() and cpn.min() >= 0 and cpn.max() <= 3
        rows = open(base + ".csv").read().splitlines()
        assert len(rows) == 10 and len({len(r) for r in rows}) == 1
        np.testing.assert_allclose(bet.mean(0), res.beta_mean[t], rtol=1e-12)
        r = np.corrcoef(res.beta_mean[t], sim_medium.beta_true[:, t])[0, 1]
        assert r > 0.85, r
    sg = res.state[0].sigmag.sum(dim=1).numpy()
    se = res.state[0].sigmae.numpy()
    np.testing.assert_allclose(sg / (sg + se), sim_medium.h2_realized,
                               atol=0.1)


def test_sync_cost_observables(sim_tiny, tmp_path, capsys):
    """--verbosity 1 prints the standalone collective chain's cost with
    every iteration, --verbosity 2 the in-step differential; neither moves
    the chain (tests/test_sharding.py:279-330)."""
    chains = []
    for v in (0, 1, 2):
        opt = _opt(sim_tiny, str(tmp_path / f"v{v}"), iterations=3,
                   block_size=8, wave_size=1, verbosity=v,
                   output_thin_rate=1)
        res = run_training_sharded(opt, n_devices=2, device="cpu",
                                   verbose=True)
        chains.append(res.state[0].sigmag.numpy())
        text = capsys.readouterr().out
        assert ("with sync time =" in text) == (v >= 1)
        assert ("measured collective sync cost" in text) == (v == 1)
        assert ("measured in-step sync cost" in text) == (v == 2)
    np.testing.assert_array_equal(chains[0], chains[1])
    np.testing.assert_array_equal(chains[0], chains[2])


@pytest.fixture(scope="module")
def mp_sim(tmp_path_factory):
    return simulate(str(tmp_path_factory.mktemp("torchmp")), n=400, m=300,
                    n_traits=2, n_causal=64, h2=0.5, n_groups=2,
                    na_rate=0.02, seed=7)


def _two_processes(sim, out_dir, n_shards, tmp_path):
    """Two gloo processes over a file rendezvous, each with half of the
    shards; the worker also checks that both ranks end on the same
    residual, bit for bit."""
    worker = os.path.join(HERE, "torch_sharded_worker.py")
    init = f"file://{tmp_path}/rendezvous_{n_shards}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(rank), "2", init,
         os.path.dirname(sim.bed), out_dir, str(n_shards)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-3000:]
        assert "EPS_EQUAL" in text


def _mp_options(sim, out_dir):
    return _opt(sim, out_dir, iterations=10, wave_size=4,
                output_thin_rate=2)


def test_two_processes_byte_identical_at_two_shards(mp_sim, tmp_path):
    """S = 2 as 2 processes x 1 shard against 1 process x 2 shards: a + b
    is the same sum either way, so the artifacts are byte-identical, which
    shows that no draw depends on the process layout and that each process
    wrote its own marker ranges and nothing else."""
    out_mp, out_sp = str(tmp_path / "mp"), str(tmp_path / "sp")
    _two_processes(mp_sim, out_mp, 2, tmp_path)
    run_training_sharded(_mp_options(mp_sim, out_sp), n_devices=2,
                         device="cpu", verbose=False)
    for t in (1, 2):
        for suffix in (".bet", ".cpn", ".csv"):
            a = open(f"{out_mp}/test{t}{suffix}", "rb").read()
            b = open(f"{out_sp}/test{t}{suffix}", "rb").read()
            assert a == b, f"test{t}{suffix} differs"
        _, cpn = read_history(f"{out_mp}/test{t}.cpn", "i4")
        assert (cpn != 0).any()


def test_two_processes_four_shards_match_one_process(mp_sim, tmp_path):
    """S = 4 as 2 x 2 against 1 x 4: the deltas are summed in another
    order, so the chains agree within float noise
    (tests/test_multiprocess.py:160-175)."""
    out_mp, out_sp = str(tmp_path / "mp"), str(tmp_path / "sp")
    _two_processes(mp_sim, out_mp, 4, tmp_path)
    run_training_sharded(_mp_options(mp_sim, out_sp), n_devices=4,
                         device="cpu", verbose=False)
    for t in (1, 2):
        its_mp, bet_mp = read_history(f"{out_mp}/test{t}.bet", "f8")
        its_sp, bet_sp = read_history(f"{out_sp}/test{t}.bet", "f8")
        assert np.array_equal(its_mp, its_sp)
        np.testing.assert_allclose(bet_mp, bet_sp, rtol=1e-3, atol=1e-5)
        _, cpn_mp = read_history(f"{out_mp}/test{t}.cpn", "i4")
        _, cpn_sp = read_history(f"{out_sp}/test{t}.cpn", "i4")
        assert (cpn_mp != cpn_sp).mean() < 0.01
        rows_mp = open(f"{out_mp}/test{t}.csv").read().splitlines()
        rows_sp = open(f"{out_sp}/test{t}.csv").read().splitlines()
        assert len(rows_mp) == len(rows_sp) == 5
        for rm, rs in zip(rows_mp, rows_sp):
            np.testing.assert_allclose(
                np.array([float(v) for v in rm.split(",")]),
                np.array([float(v) for v in rs.split(",")]), rtol=1e-3,
                atol=1e-5)


# --------------------------------------------------------------------------
# What the sharded path refuses, and the options it takes since they
# were ported
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--resume"], ["--checkpoint-every", "5"], ["--cache-dir", "cache"],
    # Predict and float64 are ported: predict at float64 on the .bet files
    # of a sharded float64 run.
    ["--predict", "--bim-file", "x.bim", "--ref-bim-file", "y.bim",
     "--dtype", "float64"],
    ["--dtype", "float64"],
], ids=lambda f: f[0])
def test_cli_sharded_refusals_name_the_roadmap_item(sim_tiny, tmp_path,
                                                    flags):
    """Every option this test once saw refused on a sharded run is ported:
    with --devices 4, --dtype float64 trains the sharded W=1 float64
    chain (other bytes than the float32 one of the same seed) and predicts
    from it; --resume, --checkpoint-every and --cache-dir write the v2
    checkpoint or one startup entry per shard, or resume a chain from its
    checkpoint.  (--dtype float64 with an explicit --wave-size > 1 trains
    the sharded float64 wave path: tests/test_torch_float64_wave.py.)"""
    out = str(tmp_path / "out")
    argv = ["--bed-file", sim_tiny.bed, "--dim-file", sim_tiny.dim,
            "--phen-files", ",".join(sim_tiny.phens),
            "--group-index-file", sim_tiny.gri,
            "--group-mixture-file", sim_tiny.grm, "--devices", "4",
            "--iterations", "5", "--block-size", "8", "--out-dir", out,
            "--verbosity", "-1"]
    flags = [str(tmp_path / f) if f == "cache"
             else sim_tiny.bim if f.endswith(".bim") else f for f in flags]
    if flags[0] == "--predict":
        assert cli.main(argv + ["--dtype", "float64"], device="cpu") == 0
        assert cli.main(argv + flags, device="cpu") == 0
        with open(os.path.join(out, "test1.mlma")) as fh:
            lines = fh.read().splitlines()
        assert len(lines) == sim_tiny.m
        assert [int(ln.split()[1]) for ln in lines] == list(range(sim_tiny.m))
        return
    if flags == ["--resume"]:
        assert cli.main(argv + ["--iterations", "3", "--checkpoint-every",
                                "3"], device="cpu") == 0
    assert cli.main(argv + flags, device="cpu") == 0
    its, _ = read_history(os.path.join(out, "test1.bet"), "f8")
    assert list(its) == [1, 2, 3, 4, 5]
    if flags[0] == "--cache-dir":
        assert len(os.listdir(flags[1])) == 4
    elif flags[0] == "--dtype":
        f32 = str(tmp_path / "f32")
        argv[argv.index(out)] = f32
        assert cli.main(argv, device="cpu") == 0
        _, b64 = read_history(os.path.join(out, "test1.bet"), "f8")
        _, b32 = read_history(os.path.join(f32, "test1.bet"), "f8")
        assert np.isfinite(b64).all() and not np.array_equal(b64, b32)
    else:
        with np.load(os.path.join(out, "checkpoint.npz")) as z:
            assert z["starts"].shape == (4, 2)


def test_megakernel_with_shards_raises(sim_tiny, tmp_path):
    from gmrm_tpu_torch.parallel import runner as prunner
    opt = _opt(sim_tiny, "", block_size=8, wave_size=8)
    opt.validate()
    opt.load_group_mixtures()
    data = prunner.load_data_process(opt, 2, interleave=True)
    statics = prunner.build_static_sharded(data, opt, CPU)
    states = prunner.init_states_sharded(data, opt, CPU)
    rngs = [RngPlan(1, CPU, shard=i) for i in range(2)]
    with pytest.raises(ValueError, match="megakernel=True requires a single"):
        gibbs_iteration_sharded(states, statics, 1, rngs, block_size=8,
                                wave=8, comm=Communicator(CPU),
                                megakernel=True)
