"""The per-block passes of the port's W=1 sweep (kernels 2 and 4, alone and
fused into one launch; kernel B at float64) on the CPU: the fused pass's
plain version against the JAX package's Pallas kernels,
``BlockPasses.update_cdot_`` against the two passes it fuses (float32 and
float64), the launch plan of the column-slice kernels at 4- and 8-byte
values, the launches that each entry would make on the card, and one W=1
sweep through the fused cadence against the three-call cadence.

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
from gmrm_tpu_torch.ops.scan_kernel import F64_MAX_B
from gmrm_tpu_torch.sampler import gibbs as tgibbs
from gmrm_tpu_torch.sampler.gibbs import marker_sweep
from test_torch_serial import _serial_sweep_args

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _passes_case(rng, T, B, nb, mb, shared_na, dtype=np.float32):
    """A bed of nb blocks plus B unrelated rows, every block's rows in a
    random processing order, and the operands of kernels 2 and 4 (float
    operands in ``dtype``)."""
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
    return (bed, rows, *(x.astype(dtype) for x in (na, eps, mave, msig, d)))


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


@pytest.mark.parametrize("b,dtype", [
    pytest.param(b, dtype, id=f"{b}{sfx}") for dtype, sfx in
    ((np.float32, ""), (np.float64, "-float64")) for b in (0, 3, 6)])
def test_block_passes_update_cdot_is_update_then_cdot(b, dtype):
    """BlockPasses.update_cdot_ on the CPU, for the first, a middle and the
    second-to-last of 8 blocks: bit-equal to update_ then cdot(b + 1), and
    c written in slot b + 1 only; in float32 and in float64 (kernel B's
    operands, c in float64)."""
    rng = np.random.default_rng(40 + b)
    T, B, nb, mb = 2, 16, 8, 96
    bed, rows, na, eps, mave, msig, d = _passes_case(rng, T, B, nb, mb,
                                                     False, dtype)
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
    assert fused.c.dtype == torch.from_numpy(eps).dtype


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
def test_block_passes_fused_cadence(dtype):
    """c-dot of block 0, then per block the fused step, the last block's
    update alone: every c and the final residual bit-equal to the
    three-call cadence (c-dot, update per block), in float32 and in
    float64.  The last block has no next block to dot."""
    rng = np.random.default_rng(77)
    T, B, nb, mb = 3, 8, 5, 64
    bed, rows, na, eps, mave, msig, d = _passes_case(rng, T, B, nb, mb,
                                                     True, dtype)
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
# bytes; the anchor (mb 2560) and the large-N panel (25,088).  Kernel B
# (8-byte values) takes the same slices at B=128; at the float64 path's
# limits (T=8, B=F64_MAX_B) 64-byte slices do not fit at 25,088 and the
# plan halves them.
PLANS = [(64, 16, 4), (300, 16, 19), (2560, 16, 160), (25088, 64, 392)]
PLAN_CASES = (
    [pytest.param(T, 128, mb, S, grid, es, id=f"{mb}-{S}-{grid}-{T}{sfx}")
     for es, sfx in ((4, ""), (8, "-float64"))
     for mb, S, grid in PLANS for T in (1, 4, 8)]
    + [pytest.param(8, F64_MAX_B, mb, S, grid, 8,
                    id=f"{mb}-{S}-{grid}-8-B{F64_MAX_B}-float64")
       for mb, S, grid in ((2560, 16, 160), (25088, 32, 784))])

# The fused pass's layout at float64 at the anchor (T=4, B=128, S=16),
# hand-summed (pass_layout's 16-byte pieces): row indices 2*128*4, two bed
# slices of 128 rows x 20 bytes, the eps and na slices 4*4*16*8 each, the
# (d, mave*d) pairs 2*4*128*8 and the update's 16 row parts of the eps
# slice (larger than the c-dot's 2*2*4*128*8), and the flag.
ANCHOR_F64_SMEM = 1024 + 2 * 2560 + 2 * 2048 + 8192 + 16 * 2048 + 16


@pytest.mark.parametrize("T,B,mb,S,grid,es", PLAN_CASES)
def test_pass_plan(T, B, mb, S, grid, es):
    """The slice width, grid and scratch of the column-slice kernels at
    ``es``-byte values (4: kernels 2 and 4, 8: kernel B): enough slices to
    fill the card (at least SLICE_TARGET once mb allows), 16-byte
    multiples, the fused pass within shared memory, and the scratch of
    counters and partials (of the value size) that the kernel carves."""
    plan = bk.pass_plan(T, B, mb, es)
    assert (plan.S, plan.grid) == (S, grid)
    assert plan.S % 16 == 0 and plan.grid * plan.S >= mb
    assert (plan.grid - 1) * plan.S < mb
    groups = -(-grid // bk.GROUP)
    assert plan.groups == groups
    assert plan.scratch_words == (32 * (1 + groups)
                                  + es // 4 * (grid + groups) * T * B)
    assert plan.smem == bk.pass_smem(T, B, S, bk.UPDATE | bk.CDOT, es)
    assert plan.smem <= bk.SMEM_BYTES
    for mode in (bk.UPDATE, bk.CDOT):
        assert bk.pass_smem(T, B, S, mode, es) < plan.smem
    if es == 8:
        assert plan.smem > bk.pass_smem(T, B, S, bk.UPDATE | bk.CDOT)
    if (T, B, mb, es) == (4, 128, 2560, 8):
        assert plan.smem == ANCHOR_F64_SMEM
    if mb == 25088 and S < 64:     # halved from the 64 the width asks
        assert bk.pass_smem(T, B, 64, bk.UPDATE | bk.CDOT, es) > \
            bk.SMEM_BYTES


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
def test_entries_launch_their_dtypes_kernels(dtype, monkeypatch):
    """What each entry would launch on the card, with the launch recorded
    instead of made (``_on_cpu`` patched to False): the float64 entries
    launch kernel B's ``*_f64`` kernels, the float32 ones kernels 2, 4 and
    the fused pass; every entry takes a stamp buffer (none raises for want
    of stamps); BlockPasses passes each block's operands at the dtype's
    strides (8 bytes a value at float64) and the plan's slice width, and
    the one-block wrappers their own tensors and a scratch of the plan's
    size."""
    rng = np.random.default_rng(5)
    T, B, nb, mb = 3, 16, 4, 96
    bed, rows, na, eps, mave, msig, d = (
        _t(x) for x in _passes_case(rng, T, B, nb, mb, False, dtype))
    calls = []
    monkeypatch.setattr(bk, "_on_cpu", lambda x: False)
    monkeypatch.setattr(bk._build, "launch",
                        lambda kernel, *args: calls.append((kernel, args)))
    sfx = "_f64" if dtype == np.float64 else ""
    es = np.dtype(dtype).itemsize
    plan = bk.pass_plan(T, B, mb, es)
    passes = bk.BlockPasses(bed, rows, mave, msig, na)
    assert passes.plan == plan
    stamps = torch.zeros((plan.grid, bk.NST), dtype=torch.int64)
    target = torch.zeros_like(eps)
    passes.cdot(1, eps, stamps)
    passes.update_(1, d, target, stamps)
    passes.update_cdot_(1, d, eps, stamps)
    assert [k for k, _ in calls] == [f"block_cdot{sfx}", f"eps_update{sfx}",
                                     f"update_cdot{sfx}"]
    (_, cd), (_, up), (_, fu) = calls
    assert all(args[-1] is stamps and args[-2] == plan.S
               for _, args in calls)
    ptr = torch.Tensor.data_ptr
    assert cd[:6] == (bed.data_ptr(), ptr(rows[1]), eps.data_ptr(),
                      ptr(mave[1]), ptr(msig[1]), ptr(passes.c[1]))
    assert up[:6] == (bed.data_ptr(), ptr(rows[1]), ptr(d[1]), ptr(mave[1]),
                      na.data_ptr(), target.data_ptr())
    assert fu[:10] == (bed.data_ptr(), ptr(rows[1]), ptr(rows[2]), ptr(d[1]),
                       ptr(mave[1]), ptr(mave[2]), ptr(msig[2]),
                       na.data_ptr(), eps.data_ptr(), ptr(passes.c[2]))
    assert cd[6] == fu[10] == passes.scratch.data_ptr()
    assert passes.scratch.numel() == plan.scratch_words
    assert cd[7:10] == up[6:9] == fu[11:14] == (T, B, mb)

    calls.clear()
    c = bk.block_cdot(bed, rows[0], eps, mave[0], msig[0])
    bk.block_eps_update_(bed, rows[0], d[0], mave[0], na, target)
    c2 = bk.block_update_cdot_(bed, rows[0], d[0], mave[0], na, eps,
                               rows[1], mave[1], msig[1])
    assert [k for k, _ in calls] == [f"block_cdot{sfx}", f"eps_update{sfx}",
                                     f"update_cdot{sfx}"]
    assert c.dtype == c2.dtype == eps.dtype
    (_, cd), (_, up), (_, fu) = calls
    assert cd[5] is c and fu[9] is c2 and up[5] is target
    assert cd[6].numel() == fu[10].numel() == plan.scratch_words
    assert all(args[-2:] == (plan.S, None) for _, args in calls)


@pytest.mark.parametrize("es,big_B,wide_B,S_128", [
    pytest.param(4, 4096, 1024, bk.SLICE_MAX, id="float32"),
    pytest.param(8, 1024, F64_MAX_B, 128, id="float64")])
def test_pass_plan_refusals(es, big_B, wide_B, S_128):
    """Past MAX_T traits a launch still has a plan (a thread carries them
    MAX_T, or 4 at float64, at a time); a block whose 16-byte slices do
    not fit in shared memory (B=4096 at T=8; at 8-byte values already
    B=1024, which float32 still takes) has none, and _check_blocks refuses
    it with the dtype named; a wide block narrows the slice before it is
    refused, and every width has a plan up to wide_B (the float64 path's
    limit at 8 bytes)."""
    dtype = torch.float32 if es == 4 else torch.float64
    assert bk.pass_plan(9, 128, 2560, es) is not None
    assert bk.pass_plan(8, big_B, 2560, es) is None
    assert bk.pass_plan(8, 1024, 2560) is not None
    assert bk.pass_plan(8, wide_B, 200_000, es).S < bk.SLICE_MAX
    assert bk.pass_plan(8, 128, 200_000, es).S == S_128
    for mb in (64, 2560, 25088, 200_000):
        assert bk.pass_plan(8, wide_B, mb, es) is not None
    bed = torch.zeros((big_B, 2560), dtype=torch.uint8)
    mave = torch.zeros((8, big_B), dtype=dtype)
    with pytest.raises(ValueError,
                       match=f"shared memory at {dtype} even at 16-byte"):
        bk._check_blocks(bed, torch.zeros(big_B, dtype=torch.int32), mave,
                         None, None)
    with pytest.raises(ValueError, match="float32 or float64"):
        bk._check_blocks(bed, torch.zeros(128, dtype=torch.int32),
                         torch.zeros((4, 128), dtype=torch.float16), None,
                         None)


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
