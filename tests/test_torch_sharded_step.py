"""One block step of the marker-sharded sweep for all of a process's local
shards (kernel 9 as ``ShardedBlockSweep``; on CPU tensors its plain
version ``block_sweep_shards_plain``).

- the plain step of 1, 2 and 3 shards against ``block_sweep_pallas`` in
  interpret mode per shard, the deltas summed in shard order (B = 8,
  W = 4, mb 300 in 512-byte lanes, NT = 1 and NT = T, shards of different
  ``m_local``, one whose block holds only pad slots);
- the out mode plus ``eps += sum`` bit-equal to the in-place mode, through
  ``ShardedBlockSweep`` and through ``marker_sweep_sharded`` with a
  communicator that sums;
- ``marker_sweep_sharded`` bit-equal to the cadence it had before one launch
  took all local shards: a ``block_sweep`` call per shard, the deltas added
  in shard order, then ``eps += sum``;
- a step split into launches of fewer shards bit-equal to one launch;
- ``block_sweep`` on one block's own slices bit-equal to the same block
  taken from the shard's whole arrays.

Tolerances, as tests/test_torch_sharded.py: ``comp`` exact, beta and acum
rtol 1e-5 / atol 1e-6, the delta relative to the largest delta (the TPU
kernel's products carry its bf16 hi/lo split error).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmrm_tpu.ops.pallas_kernels as pk
import gmrm_tpu.ops.scan_kernel_wave as skw
import gmrm_tpu.ops.sweep_kernel as swk
import gmrm_tpu_torch.ops.sweep_kernel as tsk
from gmrm_tpu_torch.ops.blockops import marker_stats
from gmrm_tpu_torch.ops.sweep_kernel import (
    ShardOperands, ShardedBlockSweep, block_sweep, block_sweep_shards_plain,
    build_sweep_tables, gram_cache_plain,
)
from gmrm_tpu_torch.parallel.distributed import Communicator
from gmrm_tpu_torch.sampler.gibbs import marker_sweep_sharded
from gmrm_tpu_torch.sampler.state import StaticInputs

torch.set_num_threads(2)

# 300 bytes of individuals in the 512-byte lanes the TPU kernel tiles by.
T, B, W, K, G, MB, NB, N_BYTES = 2, 8, 4, 4, 3, 512, 3, 300
CPU = torch.device("cpu")
# Real markers per shard: whole, ragged, and a shard whose block 2 is all
# pad slots (and block 1 partly).
M_LOCAL = (24, 19, 13)


def _interpret(monkeypatch):
    for mod in (pk, skw, swk):
        monkeypatch.setattr(mod, "FORCE_INTERPRET", True)


def _common(rng, shared):
    """The residual, its NA mask and the hyperparameters every shard
    shares: sigmag with an adaV group for trait 1, a standardized eps."""
    na = np.ones((T, 4, MB), np.float32)
    na[:, :, N_BYTES - 2:] = 0
    if not shared:
        na *= rng.uniform(size=na.shape) > 0.05
    nonas = na.sum(axis=(1, 2))
    eps = (rng.normal(size=na.shape) * na).astype(np.float32)
    eps *= np.sqrt((nonas - 1) / (eps ** 2).sum(axis=(1, 2)))[:, None, None]
    sigmag = rng.uniform(0.1, 0.5, size=(T, G)).astype(np.float32)
    sigmag[1, 0] = 0.0
    pi = rng.uniform(0.1, 1.0, size=(T, G, K))
    cva = np.tile(np.array([0.0, 1e-3, 1e-2, 1e-1], np.float32), (G, 1))
    cvai = np.zeros_like(cva)
    cvai[:, 1:] = 1.0 / cva[:, 1:]
    return dict(
        na=na, nonas=nonas.astype(np.float32), eps=eps.astype(np.float32),
        sigmag=sigmag, pi=(pi / pi.sum(-1, keepdims=True)).astype(np.float32),
        sigmae=(0.5 * (eps.astype(np.float64) ** 2).sum(axis=(1, 2))
                / nonas).astype(np.float32),
        cva=cva, cvai=cvai, n_total=np.float32(4 * N_BYTES - 8))


def _shard(rng, c, m_local, shared):
    """One shard's natural-order operands over NB blocks of B: a random
    bed (pad rows and columns 0x55), its statistics and Gram cache, a start
    state, a block and row order and the draws of a sweep."""
    m_pad = NB * B
    bed = rng.integers(0, 256, size=(m_pad, MB), dtype=np.uint8)
    bed[m_local:] = 0x55
    bed[:, N_BYTES - 2:] = 0x55
    bed_t, na_t = torch.from_numpy(bed), torch.from_numpy(c["na"])
    mave, msig = marker_stats(bed_t, na_t, torch.from_numpy(c["nonas"]))
    valid = torch.arange(m_pad) < m_local
    comp = rng.integers(0, K, size=(T, m_pad)).astype(np.int32)
    blk = rng.permutation(NB).astype(np.int32)
    if m_local <= (NB - 1) * B:
        blk = np.roll(np.arange(NB, dtype=np.int32), 1)   # pad block first
    return dict(
        bed=bed, m_local=m_local,
        mave=torch.where(valid, mave, 0.0).numpy(),
        msig=torch.where(valid, msig, 0.0).numpy(),
        gram=gram_cache_plain(bed_t, na_t[:1] if shared else na_t,
                              B).numpy(),
        grp=rng.integers(0, G, size=m_pad).astype(np.int32),
        beta=(rng.normal(size=(T, m_pad)) * 0.05 * (comp > 0)
              * valid.numpy()).astype(np.float32),
        comp=comp,
        acum=rng.uniform(size=(T, m_pad)).astype(np.float32),
        blk=blk,
        win=np.argsort(rng.uniform(size=(NB, B)), axis=1).astype(np.int32),
        u=rng.uniform(size=(NB, T, B)).astype(np.float32),
        z=rng.normal(size=(NB, T, B)).astype(np.float32))


def _operands(x):
    """A shard's ShardOperands on the CPU, its marker state copied."""
    t = torch.from_numpy
    return ShardOperands(
        t(x["blk"]), t(x["win"]), x["m_local"], t(x["bed"]), t(x["gram"]),
        t(x["mave"]), t(x["msig"]), t(x["beta"].copy()), t(x["comp"].copy()),
        t(x["acum"].copy()), t(x["grp"]), t(x["u"]), t(x["z"]))


def _setup(seed, n_shards, shared):
    rng = np.random.default_rng(seed)
    c = _common(rng, shared)
    xs = [_shard(rng, c, M_LOCAL[i % len(M_LOCAL)], shared)
          for i in range(n_shards)]
    tables = build_sweep_tables(
        torch.from_numpy(c["sigmag"]), torch.from_numpy(c["sigmae"]),
        torch.from_numpy(c["pi"]), torch.from_numpy(c["cva"]),
        torch.from_numpy(c["cvai"]), torch.from_numpy(c["nonas"]),
        float(c["n_total"]))
    nt = 1 if shared else T
    common = (torch.from_numpy(c["na"][:nt].copy()),
              torch.from_numpy(c["sigmag"]), *tables,
              torch.from_numpy(1.0 / (2.0 * c["sigmae"])),
              torch.from_numpy(c["nonas"]))
    return c, xs, common


@pytest.mark.parametrize("shared", [True, False], ids=["NT1", "NTT"])
@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_shards_plain_matches_pallas_block_kernel(n_shards, shared,
                                                  monkeypatch):
    """Every block step of 1, 2 and 3 shards from one residual: the marker
    state of every shard and the shard-order sum of their deltas against
    ``block_sweep_pallas`` per shard.  Step 0 of the third shard sweeps a
    block of pad slots only: its state and its delta stay zero."""
    _interpret(monkeypatch)
    c, xs, common = _setup(100 + n_shards, n_shards, shared)
    ops = [_operands(x) for x in xs]
    jt = swk.build_sweep_tables(
        jnp.asarray(c["sigmag"]), jnp.asarray(c["sigmae"]),
        jnp.asarray(c["pi"]), jnp.asarray(c["cva"]), jnp.asarray(c["cvai"]),
        jnp.asarray(c["nonas"]), c["n_total"])
    state = [{k: x[k].copy() for k in ("beta", "comp", "acum")} for x in xs]
    drawn = set()
    for b in range(NB):
        eps = torch.from_numpy(c["eps"].copy())
        out = torch.full_like(eps, float("nan"))
        got = block_sweep_shards_plain(b, ops, eps, *common, wave=W, out=out)
        assert got is out
        np.testing.assert_array_equal(eps.numpy(), c["eps"])   # read-only
        want = None
        for x, st, op in zip(xs, state, ops):
            blk = int(x["blk"][b])
            rows = slice(blk * B, (blk + 1) * B)
            d, bn, cn, an = (np.asarray(v) for v in swk.block_sweep_pallas(
                blk, x["m_local"], jnp.asarray(x["bed"][rows]),
                jnp.asarray(x["win"][b]), jnp.asarray(x["gram"][blk:blk + 1]),
                jnp.asarray(c["eps"]), jnp.asarray(c["na"]),
                jnp.asarray(x["mave"][:, rows]),
                jnp.asarray(x["msig"][:, rows]),
                jnp.asarray(st["beta"][:, rows]),
                jnp.asarray(st["comp"][:, rows]),
                jnp.asarray(st["acum"][:, rows]), jnp.asarray(x["grp"][rows]),
                jnp.asarray(x["u"][b]), jnp.asarray(x["z"][b]),
                jnp.asarray(c["sigmag"]), *jt,
                jnp.asarray(1.0 / (2.0 * c["sigmae"]))[:, None],
                jnp.asarray(c["nonas"])[:, None], wave=W, shared_na=shared,
                interpret=True))
            want = d if want is None else want + d
            st["beta"][:, rows], st["comp"][:, rows] = bn, cn
            st["acum"][:, rows] = an
            np.testing.assert_array_equal(op.comp.numpy(), st["comp"])
            np.testing.assert_allclose(op.beta.numpy(), st["beta"],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(op.acum.numpy(), st["acum"],
                                       rtol=1e-5, atol=1e-6)
            if blk * B >= x["m_local"]:
                assert not d.any() and (bn == x["beta"][:, rows]).all()
            drawn |= set(cn.reshape(-1).tolist())
        scale = max(float(np.abs(want).max()), 1e-3)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale)
    assert len(drawn) > 1
    if n_shards == 3:
        assert int(xs[2]["blk"][0]) * B >= xs[2]["m_local"]


def _run(xs, c, common, out_mode):
    """A whole sweep of the shards through ShardedBlockSweep on the CPU,
    in place or in out mode plus ``eps += sum``; the residual and every
    shard's state."""
    ops = [_operands(x) for x in xs]
    eps = torch.from_numpy(c["eps"].copy())
    sweep = ShardedBlockSweep().sweep(ops, eps, *common, wave=W)
    total = torch.empty_like(eps)
    for b in range(NB):
        if out_mode:
            eps += sweep.step(b, out=total)
        else:
            assert sweep.step(b) is eps
    return eps, sweep.finish()


def _equal(a, b):
    eps_a, st_a = a
    eps_b, st_b = b
    assert torch.equal(eps_a, eps_b)
    for x, y in zip(st_a, st_b):
        for u, v in zip(x, y):
            assert torch.equal(u, v)


@pytest.mark.parametrize("shared", [True, False], ids=["NT1", "NTT"])
def test_out_mode_plus_add_is_in_place_mode(shared):
    c, xs, common = _setup(7, 3, shared)
    _equal(_run(xs, c, common, True), _run(xs, c, common, False))


@pytest.mark.parametrize("max_shards", [1, 2])
def test_split_launches_match_one_launch(max_shards, monkeypatch):
    """A step of 3 shards as launches of ``max_shards``, each adding onto
    the sum of the shards before: the bits of one launch, in place and in
    out mode."""
    c, xs, common = _setup(8, 3, False)
    for out_mode in (False, True):
        one = _run(xs, c, common, out_mode)
        with monkeypatch.context() as m:
            m.setattr(tsk, "MAX_SHARDS", max_shards)
            _equal(_run(xs, c, common, out_mode), one)


def _statics(c, xs, shared):
    return [StaticInputs(
        bed=torch.from_numpy(x["bed"]), na=torch.from_numpy(c["na"]),
        mave=torch.from_numpy(x["mave"]), msig=torch.from_numpy(x["msig"]),
        group_of=torch.from_numpy(x["grp"]).long(),
        mtotgrp=torch.bincount(torch.from_numpy(x["grp"][:x["m_local"]])
                               .long(), minlength=G),
        nonas=torch.from_numpy(c["nonas"]), cva=torch.from_numpy(c["cva"]),
        cvai=torch.from_numpy(c["cvai"]), n_total=float(c["n_total"]),
        m_local=x["m_local"], gram_cache=torch.from_numpy(x["gram"]),
        shared_na=shared) for x in xs]


class _SummingComm(Communicator):
    """One process that takes the out route: its sum over processes is
    the identity, as a one-rank group's is."""

    def sums(self):
        return True

    def all_reduce_sum(self, x):
        return x


def _sharded(c, xs, shared, comm):
    statics = _statics(c, xs, shared)
    t = torch.from_numpy
    return marker_sweep_sharded(
        t(c["eps"].copy()),
        [(t(x["beta"].copy()), t(x["comp"].copy()), t(x["acum"].copy()))
         for x in xs], t(c["sigmag"]), t(c["sigmae"]), t(c["pi"]), statics,
        [t(x["blk"].astype(np.int64))[:, None] * B + t(x["win"]).long()
         for x in xs], [t(x["u"]) for x in xs], [t(x["z"]) for x in xs],
        wave=W, comm=comm)


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_sweep_matches_per_shard_cadence(D):
    """``marker_sweep_sharded`` (one launch per block step for all local
    shards, in place) bit-equal to the cadence of a ``block_sweep`` call per
    shard and block step, the deltas added in shard order, then
    ``eps += sum``; and the out route (a communicator that sums) bit-equal
    to both."""
    c, xs, common = _setup(20 + D, D, True)
    eps, states, cass = _sharded(c, xs, True, Communicator(CPU))
    eps_out, states_out, cass_out = _sharded(c, xs, True, _SummingComm(CPU))
    want = torch.from_numpy(c["eps"].copy())
    ops = [_operands(x) for x in xs]
    for b in range(NB):
        total = None
        for op in ops:
            d = block_sweep(op.blk[b:b + 1], op.m_local, op.bed, op.win[b],
                            op.gram, want, *common[:1], op.mave, op.msig,
                            op.beta, op.comp, op.acum, op.grp, op.u[b],
                            op.z[b], *common[1:], wave=W)[0]
            total = d if total is None else total.add_(d)
        want += total
    for got in ((eps, states), (eps_out, states_out)):
        _equal(got, (want, [(o.beta, o.comp, o.acum) for o in ops]))
    assert torch.equal(cass, cass_out)
    assert (states[0][1] != torch.from_numpy(xs[0]["comp"])).any()


@pytest.mark.parametrize("shared", [True, False], ids=["NT1", "NTT"])
def test_block_slices_match_whole_arrays(shared):
    """``block_sweep`` (one shard, out mode) on copies of one block's own
    slices (nb = 1) and on the shard's whole arrays with the block's index
    (nb > 1): the same delta and the same new state of the block, bit for
    bit, at every step."""
    c, xs, common = _setup(40, 1, shared)
    x = xs[0]
    whole = _operands(x)
    eps = torch.from_numpy(c["eps"])
    for b in range(NB):
        blk = int(x["blk"][b])
        rows = slice(blk * B, (blk + 1) * B)
        d_whole = block_sweep(
            whole.blk[b:b + 1], x["m_local"], whole.bed, whole.win[b],
            whole.gram, eps, common[0], whole.mave, whole.msig, whole.beta,
            whole.comp, whole.acum, whole.grp, whole.u[b], whole.z[b],
            *common[1:], wave=W)[0]
        part = [whole.beta[:, rows].clone(), whole.comp[:, rows].clone(),
                whole.acum[:, rows].clone()]
        sl = _operands(x)
        d_sl, *new = block_sweep(
            blk, x["m_local"], sl.bed[rows].clone(), sl.win[b],
            sl.gram[blk:blk + 1].clone(), eps, common[0],
            sl.mave[:, rows].clone(), sl.msig[:, rows].clone(),
            sl.beta[:, rows].clone(), sl.comp[:, rows].clone(),
            sl.acum[:, rows].clone(), sl.grp[rows].clone(), sl.u[b],
            sl.z[b], *common[1:], wave=W)
        assert torch.equal(d_sl, d_whole)
        for got, want in zip(new, part):
            assert torch.equal(got, want)
