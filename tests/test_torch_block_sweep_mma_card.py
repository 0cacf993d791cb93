"""Kernel 9's column passes on the tensor cores, on the card (marker
``card``; each test skips where there is no CUDA device).  The file imports
no JAX; tests/conftest.py does, so on a machine without JAX run it with
``python3 -m pytest --noconftest tests/test_torch_block_sweep_mma_card.py``.

One block step of kernel 9 (``ShardedBlockSweep``) on seeded operands of
four natural blocks, at the shapes of ``CASES``: the UK Biobank shard of the
four-card cell (400,000 individuals, mb_pad 100,352, 768 byte columns a
column CTA, T = 4 with per-trait NA masks, one shard a process); two shards
a launch, and the same step split over two launches; beside it the shapes
that take the other branches of the tensor-core passes (T = 8 with NT = 8,
whose fragments hold every part of two traits a lane; T = 1, fewer traits
than the instance's; W = 64, two k steps a wave); and the anchor's 20
columns a column CTA, which keep the CUDA-core passes:

- ``block_sweep_plan`` reports the design that csrc/block_sweep.cu's
  ``mma_passes`` gives there, and the launch counts show which ran;
- two launches on the same inputs are byte-equal, in the sum and in every
  shard's marker state; a step split over launches of one shard each gives
  the bits of one launch; a CUDA graph's replay gives the bits of the
  eager launch;
- where the tensor cores run, against the step in float64 on the same
  operands and draws (the plain versions, every float operand widened, the
  delta rounded to float32 after each wave as both float32 paths store
  it), the root-mean-square errors in beta and in the summed delta are no
  larger than those of the composed kernels 2, 3 and 4 (a wave at a time,
  into a zero delta), whose passes sum on the CUDA cores in float32: the
  plan gives kernel 9 no CUDA-core instance at these widths.
"""

import pytest
import torch

from gmrm_tpu_torch.ops import _build
from gmrm_tpu_torch.ops import sweep_kernel as sk
from gmrm_tpu_torch.ops.blockops import marker_stats

B, K, G = 128, 4, 3
NBLOCKS = 4
# name: (T, per-trait NA masks, mb, W, shards of the step, the design the
# plan picks there (csrc/block_sweep.cu mma_passes)).
CASES = {
    "x4": (4, True, 100_352, 32, 1, "tensor cores"),
    "x4_two_shards": (4, True, 100_352, 32, 2, "tensor cores"),
    "t8": (8, True, 100_352, 32, 1, "tensor cores"),
    "t1": (1, True, 100_352, 32, 1, "tensor cores"),
    "w64": (4, True, 100_352, 64, 1, "tensor cores"),
    "anchor": (4, False, 2_560, 32, 1, "CUDA cores"),
}


@pytest.fixture
def card():
    """The CUDA device, or a skip where this machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


def _operands(card, T, per_trait, mb, n_shards, seed):
    """A block step's operands, made on the card from ``seed``: one random
    bed whose last 60 byte columns and last 40 marker slots are pad, NA
    masks (one shared, or T at 3%), statistics, a standardized residual,
    the Gram cache and the group tables (one adaV group for trait 0); per
    shard its own block order, row order, draws, marker state and real
    marker count (shard 1's stops 100 slots short)."""
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    m_pad = NBLOCKS * B
    mt = m_pad - 40
    bed = torch.randint(0, 256, (m_pad, mb), generator=gen, device=card,
                        dtype=torch.uint8)
    bed[mt:] = 0x55
    bed[:, mb - 60:] = 0x55
    na = torch.ones((T, 4, mb), device=card)
    na[:, :, mb - 60:] = 0
    if per_trait:
        na = na * (torch.rand((T, 4, mb), generator=gen, device=card) > 0.03)
    na = na.contiguous()
    nonas = na.sum(dim=(1, 2))
    mave, msig = marker_stats(bed, na, nonas)
    valid = (torch.arange(m_pad, device=card) < mt)[None]
    mave = torch.where(valid, mave, 0.0).contiguous()
    msig = torch.where(valid, msig, 0.0).contiguous()
    eps = torch.randn((T, 4, mb), generator=gen, device=card) * na
    eps = (eps * torch.sqrt((nonas - 1) / (eps * eps).sum(dim=(1, 2)))
           [:, None, None]).contiguous()
    gram = sk.build_gram_cache(bed, na, block_size=B,
                               shared_na=not per_trait)
    nt = gram.shape[1]
    cva = torch.tensor([[0.0, 1e-4, 1e-3, 1e-2]] * G, device=card)
    cvai = torch.zeros_like(cva)
    cvai[:, 1:] = 1.0 / cva[:, 1:]
    sigmag = torch.rand((T, G), generator=gen, device=card) * 0.4 + 0.1
    sigmag[0, 1] = 0.0
    pi = torch.rand((T, G, K), generator=gen, device=card) + 0.1
    pi = pi / pi.sum(-1, keepdim=True)
    sigmae = 0.5 * (eps * eps).sum(dim=(1, 2)) / nonas
    tables = sk.build_sweep_tables(sigmag, sigmae, pi, cva, cvai, nonas,
                                   float(4 * mb - 240))
    grp = torch.randint(0, G, (m_pad,), generator=gen, device=card,
                        dtype=torch.int32)
    shards = []
    for q in range(n_shards):
        comp = torch.randint(0, K, (T, m_pad), generator=gen, device=card,
                             dtype=torch.int32)
        m_loc = mt - 100 * q
        ok = (torch.arange(m_pad, device=card) < m_loc)[None]
        shards.append(sk.ShardOperands(
            torch.randperm(NBLOCKS, generator=gen, device=card).to(
                torch.int32),
            torch.argsort(torch.rand((NBLOCKS, B), generator=gen,
                                     device=card), dim=1).to(torch.int32),
            m_loc, bed, gram, mave, msig,
            (torch.randn((T, m_pad), generator=gen, device=card) * 0.01
             * (comp > 0) * ok).contiguous(), comp,
            torch.rand((T, m_pad), generator=gen, device=card), grp,
            torch.rand((NBLOCKS, T, B), generator=gen, device=card),
            torch.randn((NBLOCKS, T, B), generator=gen, device=card)))
    common = (na[:nt].contiguous(), sigmag, *tables,
              (1.0 / (2.0 * sigmae)).contiguous(), nonas)
    return shards, eps, common


def _composed(s, b, eps, common, W, kernels):
    """Shard ``s``'s block step ``b`` a wave at a time: (delta, beta_new,
    comp_new) at the block's slots.  ``kernels``: in float32 on kernels 2,
    3 and 4, whose passes sum on the CUDA cores; else in float64 on the
    plain versions (every float operand widened, the values unchanged),
    the delta rounded to float32 after every wave, as both float32 paths
    store it."""
    from gmrm_tpu_torch.ops.block_gram import scale_gram
    from gmrm_tpu_torch.ops.block_kernels import (
        block_cdot, block_cdot_plain, block_eps_update_,
        block_eps_update_plain_)
    from gmrm_tpu_torch.ops.scan_kernel_wave import (
        scan_masks, wave_scan, wave_scan_plain)

    def wide(x):
        return (x.double() if not kernels and isinstance(x, torch.Tensor)
                and x.is_floating_point() else x)

    na, sigmag, lc, rd, sqb, i2se, nonas = map(wide, common)
    T = eps.shape[0]
    na = na.expand(T, *na.shape[1:]).contiguous()
    blk = s.blk[b:b + 1].long()
    win = s.win[b].long()
    rows = blk * B + win
    g = s.grp.long()[rows]
    mave_b, msig_b = wide(s.mave)[:, rows], wide(s.msig)[:, rows]
    beta_b = wide(s.beta)[:, rows]
    live, zerob = scan_masks(g, rows < s.m_local, sigmag)
    e = wide(eps)
    rows32 = rows.to(torch.int32)
    c = (block_cdot if kernels else block_cdot_plain)(
        s.bed, rows32, e, mave_b.contiguous(), msig_b.contiguous())
    win2 = torch.cat([win, win + B])
    gs = scale_gram(wide(s.gram).index_select(0, blk)[0].index_select(
        1, win2).index_select(2, win2), mave_b, msig_b)
    args = (c + beta_b * (nonas[:, None] - 1.0), lc[:, :, g], rd[:, :, g],
            sqb[:, :, g], gs, beta_b, s.comp[:, rows], wide(s.acum)[:, rows],
            wide(s.u)[b], wide(s.z)[b], live, zerob, i2se)
    if kernels:
        dbeta, bn, cn, _ = wave_scan(*(x.contiguous() for x in args),
                                     wave=W)
    else:
        dbeta, bn, cn, _ = wave_scan_plain(*args, W)
    d = msig_b * dbeta
    delta = torch.zeros_like(e)
    for w0 in range(0, B, W):
        sl = slice(w0, w0 + W)
        (block_eps_update_ if kernels else block_eps_update_plain_)(
            s.bed, rows32[sl].contiguous(), d[:, sl].contiguous(),
            mave_b[:, sl].contiguous(), na, delta)
        if not kernels:
            delta = delta.float().double()
    return delta, bn, cn


@pytest.mark.card
@pytest.mark.parametrize("case", list(CASES))
def test_block_step_on_the_tensor_cores(card, case):
    T, per_trait, mb, W, n_sh, design = CASES[case]
    shards, eps, common = _operands(card, T, per_trait, mb, n_sh, 2026_1019)
    nt = common[0].shape[0]
    plan = sk.block_sweep_plan(T, B, mb, nt, K, W, n_sh)
    assert plan["passes"] == design, plan
    if case == "x4":
        assert plan["tiles"] == 1 and plan["cols"] == 768, plan
    b = 1
    state0 = [(s.beta.clone(), s.comp.clone(), s.acum.clone())
              for s in shards]

    def restore():
        for s, (beta, comp, acum) in zip(shards, state0):
            s.beta.copy_(beta)
            s.comp.copy_(comp)
            s.acum.copy_(acum)

    def state():
        return [x.clone() for s in shards for x in (s.beta, s.comp, s.acum)]

    sweep = sk.ShardedBlockSweep().sweep(shards, eps, *common, wave=W)
    out = torch.empty_like(eps)
    _build.reset_launch_counts()
    sweep.step(b, out=out)
    counts = _build.launch_counts()
    launches = -(-n_sh // plan["cap"])
    assert counts["block_sweep"] == launches, counts
    assert counts["block_sweep_mma"] == (
        launches if design == "tensor cores" else 0), counts
    got, got_state = out.clone(), state()

    restore()
    sweep.step(b, out=out)
    assert torch.equal(out, got)
    assert all(torch.equal(x, y) for x, y in zip(state(), got_state))

    if n_sh > 1:
        cap = sk.MAX_SHARDS
        sk.MAX_SHARDS = 1
        try:
            restore()
            split = sk.ShardedBlockSweep().sweep(shards, eps, *common,
                                                 wave=W)
            _build.reset_launch_counts()
            split.step(b, out=out)
            assert _build.launch_counts()["block_sweep"] == n_sh
        finally:
            sk.MAX_SHARDS = cap
        assert torch.equal(out, got)
        assert all(torch.equal(x, y) for x, y in zip(state(), got_state))

    # The step captured in a CUDA graph and replayed.
    restore()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sweep.step(b, out=out)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sweep.step(b, out=out)
    restore()
    out.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)
    assert all(torch.equal(x, y) for x, y in zip(state(), got_state))
    sweep.finish()

    if design != "tensor cores":
        return
    restore()
    ref = [_composed(s, b, eps, common, W, False) for s in shards]
    cores = [_composed(s, b, eps, common, W, True) for s in shards]

    # A draw within float32's reach of its CDF boundary may differ from
    # the float64 one: such a trait's chain differs from there on, so it
    # is left out of both sides' errors.
    comp_got = got_state[1::3]
    rows = [s.blk[b].long() * B + s.win[b].long() for s in shards]
    keep = [t for t in range(T)
            if all(torch.equal(cg[t, r], rf[2][t])
                   and torch.equal(cc[2][t], rf[2][t])
                   for cg, cc, rf, r in zip(comp_got, cores, ref, rows))]
    assert keep and len(keep) >= T - 1, keep

    def errs(x, want):
        d = x[keep].double() - want[keep]
        return float(d.abs().max()), float(d.square().mean().sqrt())

    beta_got = torch.cat([x[:, r] for x, r in zip(got_state[0::3], rows)],
                         dim=1)
    beta_ref = torch.cat([x[1] for x in ref], dim=1)
    beta_cores = torch.cat([x[1] for x in cores], dim=1)
    delta_ref = sum(x[0] for x in ref)
    delta_cores = sum(x[0] for x in cores)
    mma = dict(zip(("beta_max", "beta"), errs(beta_got, beta_ref)))
    mma.update(zip(("delta_max", "delta"), errs(got, delta_ref)))
    fma = dict(zip(("beta_max", "beta"), errs(beta_cores, beta_ref)))
    fma.update(zip(("delta_max", "delta"), errs(delta_cores, delta_ref)))
    print(f"{case}: errors against float64, tensor-core passes {mma}, "
          f"CUDA-core passes {fma}")
    assert mma["beta"] <= fma["beta"] and mma["delta"] <= fma["delta"], (
        mma, fma)
