"""The per-block passes of the port's W=1 sweep (kernels 2 and 4, alone and
fused into one launch) on the CPU: the fused pass's plain version against
the JAX package's Pallas kernels, ``BlockPasses.update_cdot_`` against the
two passes it fuses, the launch plan of the column-slice kernels, and one
W=1 sweep through the fused cadence against the three-call cadence.

The JAX Pallas kernels run in interpret mode on the CPU, as the JAX
package's own tests run them.  The CUDA kernels are checked against these
plain versions on the card by chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import gmrm_tpu.ops.pallas_kernels as pk
from gmrm_tpu_torch.ops import block_kernels as bk
from gmrm_tpu_torch.sampler import gibbs as tgibbs
from gmrm_tpu_torch.sampler.gibbs import marker_sweep
from test_torch_serial import _serial_sweep_args

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _passes_case(rng, T, B, nb, mb, shared_na):
    """A bed of nb blocks plus B unrelated rows, every block's rows in a
    random processing order, and the operands of kernels 2 and 4."""
    bed = rng.integers(0, 256, size=((nb + 1) * B, mb), dtype=np.uint8)
    rows = (B + np.stack([b * B + rng.permutation(B) for b in range(nb)])
            ).astype(np.int32)
    na = np.ones((T, 4, mb), np.float32)
    if shared_na:
        na *= rng.uniform(size=(1, 4, mb)) > 0.03
    else:
        na *= rng.uniform(size=(T, 4, mb)) > 0.03
    eps = rng.normal(size=(T, 4, mb)).astype(np.float32) * na
    mave = rng.uniform(0.2, 1.8, size=(nb, T, B)).astype(np.float32)
    msig = rng.uniform(0.5, 2.0, size=(nb, T, B)).astype(np.float32)
    d = (rng.normal(size=(nb, T, B)) * 0.05
         * (rng.uniform(size=(nb, T, B)) > 0.5)).astype(np.float32)
    return bed, rows, na, eps, mave, msig, d


# Tolerance as tests/test_torch_ops.py: the JAX kernels carry eps and d as
# bf16 hi/lo pairs, about 2^-17 relative; the port's sums are plain float32.
@pytest.mark.parametrize("shared_na", [True, False], ids=["NT1", "NTT"])
@pytest.mark.parametrize("mb", [300, 700])
def test_update_cdot_plain_matches_pallas(mb, shared_na, monkeypatch):
    """Block b's update then block b+1's c-dot, rows in processing order
    into a larger bed, against block_eps_update_pallas followed by
    block_cdot_pallas on the updated residual."""
    monkeypatch.setattr(pk, "FORCE_INTERPRET", True)
    rng = np.random.default_rng(mb + 7 * shared_na)
    T, B = 3, 32
    bed, rows, na, eps, mave, msig, d = _passes_case(rng, T, B, 2, mb,
                                                     shared_na)
    got_eps = _t(eps.copy())
    got_c = bk.block_update_cdot_plain_(
        _t(bed), _t(rows[0]), _t(d[0]), _t(mave[0]), _t(na), got_eps,
        _t(rows[1]), _t(mave[1]), _t(msig[1]))
    deps = pk.block_eps_update_pallas(jnp.asarray(bed[rows[0]]),
                                      jnp.asarray(d[0]), jnp.asarray(na),
                                      jnp.asarray(mave[0]), interpret=True)
    want_eps = jnp.asarray(eps) + deps
    want_c = pk.block_cdot_pallas(jnp.asarray(bed[rows[1]]), want_eps,
                                  jnp.asarray(mave[1]), jnp.asarray(msig[1]),
                                  interpret=True)
    np.testing.assert_allclose(got_eps.numpy(), np.asarray(want_eps),
                               rtol=2e-5, atol=2e-4)
    # c from the two updated residuals: the hi/lo rounding of d moves eps
    # coherently along the block's rows (the error at column n is
    # sum_i err(d_i) a_i[n]), and the c-dot sums it over 4 mb columns
    # through the rows' products, so c's error scales with |c| (8.6e-6 of
    # max|c| at most over these four cases) rather than with one element.
    want_c = np.asarray(want_c)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=2e-5,
                               atol=2e-5 * np.abs(want_c).max())
    # The one-block wrapper on CPU tensors is the plain version.
    again = _t(eps.copy())
    c2 = bk.block_update_cdot_(
        _t(bed), _t(rows[0]), _t(d[0]), _t(mave[0]), _t(na), again,
        _t(rows[1]), _t(mave[1]), _t(msig[1]))
    assert torch.equal(again, got_eps) and torch.equal(c2, got_c)


@pytest.mark.parametrize("b", [0, 3, 6])
def test_block_passes_update_cdot_is_update_then_cdot(b):
    """BlockPasses.update_cdot_ on the CPU, for the first, a middle and the
    second-to-last of 8 blocks: bit-equal to update_ then cdot(b + 1), and
    c written in slot b + 1 only."""
    rng = np.random.default_rng(40 + b)
    T, B, nb, mb = 2, 16, 8, 96
    bed, rows, na, eps, mave, msig, d = _passes_case(rng, T, B, nb, mb,
                                                     False)
    ops = (_t(bed), _t(rows), _t(mave), _t(msig), _t(na))
    fused, apart = bk.BlockPasses(*ops), bk.BlockPasses(*ops)
    for p in (fused, apart):
        p.c.fill_(float("nan"))
    e_fused, e_apart = _t(eps.copy()), _t(eps.copy())
    fused.update_cdot_(b, _t(d), e_fused)
    apart.update_(b, _t(d), e_apart)
    apart.cdot(b + 1, e_apart)
    assert torch.equal(e_fused, e_apart)
    assert not torch.equal(e_fused, _t(eps))
    assert torch.equal(fused.c[b + 1], apart.c[b + 1])
    assert torch.isfinite(fused.c[b + 1]).all()
    others = [k for k in range(nb) if k != b + 1]
    assert torch.isnan(fused.c[others]).all()


def test_block_passes_fused_cadence():
    """c-dot of block 0, then per block the fused step, the last block's
    update alone: every c and the final residual bit-equal to the
    three-call cadence (c-dot, update per block).  The last block has no
    next block to dot."""
    rng = np.random.default_rng(77)
    T, B, nb, mb = 3, 8, 5, 64
    bed, rows, na, eps, mave, msig, d = _passes_case(rng, T, B, nb, mb,
                                                     True)
    ops = (_t(bed), _t(rows), _t(mave), _t(msig), _t(na))
    fused, apart = bk.BlockPasses(*ops), bk.BlockPasses(*ops)
    e_fused, e_apart = _t(eps.copy()), _t(eps.copy())
    fused.cdot(0, e_fused)
    for b in range(nb):
        if b + 1 < nb:
            fused.update_cdot_(b, _t(d), e_fused)
        else:
            fused.update_(b, _t(d), e_fused)
        apart.cdot(b, e_apart)
        apart.update_(b, _t(d), e_apart)
    assert torch.equal(fused.c, apart.c)
    assert torch.equal(e_fused, e_apart)
    with pytest.raises(ValueError, match="no next block"):
        fused.update_cdot_(nb - 1, _t(d), e_fused)


# (mb, S, grid): 16-byte slices until mb reaches 2 x SLICE_TARGET x 16
# bytes; the anchor (mb 2560) and the large-N panel (25,088).
PLANS = [(64, 16, 4), (300, 16, 19), (2560, 16, 160), (25088, 64, 392)]


@pytest.mark.parametrize("T", [1, 4, 8])
@pytest.mark.parametrize("mb,S,grid", PLANS)
def test_pass_plan(mb, S, grid, T):
    """The slice width, grid and scratch of the column-slice kernels at
    B=128: enough slices to fill the card (at least SLICE_TARGET once mb
    allows), 16-byte multiples, the fused pass within shared memory, and
    the scratch of counters and partials that the kernel carves."""
    B = 128
    plan = bk.pass_plan(T, B, mb)
    assert (plan.S, plan.grid) == (S, grid)
    assert plan.S % 16 == 0 and plan.grid * plan.S >= mb
    assert (plan.grid - 1) * plan.S < mb
    groups = -(-grid // bk.GROUP)
    assert plan.groups == groups
    assert plan.scratch_words == 32 * (1 + groups) + (grid + groups) * T * B
    assert plan.smem == bk.pass_smem(T, B, S, bk.UPDATE | bk.CDOT)
    assert plan.smem <= bk.SMEM_BYTES
    for mode in (bk.UPDATE, bk.CDOT):
        assert bk.pass_smem(T, B, S, mode) < plan.smem


def test_pass_plan_refusals():
    """Above MAX_T traits, and a block whose 16-byte slices do not fit in
    shared memory; a wide block narrows the slice before it is refused."""
    with pytest.raises(ValueError, match="MAX_T"):
        bk.pass_plan(9, 128, 2560)
    assert bk.pass_plan(8, 4096, 2560) is None
    wide = bk.pass_plan(8, 1024, 200_000)
    assert wide is not None and wide.S < bk.SLICE_MAX
    assert bk.pass_plan(8, 128, 200_000).S == bk.SLICE_MAX
    bed = torch.zeros((4096, 2560), dtype=torch.uint8)
    mave = torch.zeros((8, 4096))
    with pytest.raises(ValueError, match="shared memory"):
        bk._check_blocks(bed, torch.zeros(4096, dtype=torch.int32), mave,
                         None, None)


def test_w1_sweep_fused_cadence_bit_equal(sim_medium, monkeypatch):
    """One W=1 marker_sweep on sim_medium (8 blocks of 32) through the
    fused cadence (c-dot of block 0, then update_cdot_ per block, the last
    block's update alone) against the three-call cadence (c-dot, scan,
    update per block; forced by a target that is a new view of eps): eps,
    betas, comp, acum and cass bit-equal."""
    args = _serial_sweep_args(sim_medium, 32, 5)
    nb = args[8].shape[0]
    assert nb == 8
    calls, depth = [], [0]
    for name in ("cdot", "update_", "update_cdot_"):
        real = getattr(bk.BlockPasses, name)

        def spy(self, b, *rest, _real=real, _name=name):
            # Calls from the sweep only: on the CPU update_cdot_ is
            # update_ then cdot.
            if not depth[0]:
                calls.append((_name, b))
            depth[0] += 1
            try:
                return _real(self, b, *rest)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(bk.BlockPasses, name, spy)
    got = marker_sweep(args[0].clone(), *args[1:], wave=1)
    assert calls == ([("cdot", 0)]
                     + [("update_cdot_", b) for b in range(nb - 1)]
                     + [("update_", nb - 1)])

    calls.clear()
    step = tgibbs._ComposedSweep.step
    monkeypatch.setattr(tgibbs._ComposedSweep, "step",
                        lambda self, b, eps, target:
                        step(self, b, eps, target.view_as(target)))
    want = marker_sweep(args[0].clone(), *args[1:], wave=1)
    assert calls == [(name, b) for b in range(nb)
                     for name in ("cdot", "update_")]
    assert (got[2] != 0).any()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
