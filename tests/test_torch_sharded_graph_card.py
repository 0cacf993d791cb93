"""The sharded sweep's kernel-9 block steps as one CUDA graph a sweep, on
the card (marker ``card``; each test skips where there is no CUDA device).
The file imports no JAX; tests/conftest.py does, so on a machine without
JAX run it with ``python3 -m pytest --noconftest
tests/test_torch_sharded_graph_card.py``.

In an NCCL process group of this one process (a communicator that sums:
kernel 9 writes the local sum, NCCL sums it, ``eps += total``), at the
biobank share's width (400,000 individuals, mb_pad 100,352, per-trait NA
masks) over 32 blocks and at the anchor's (10,000 individuals, mb_pad
2,560, one mask) over 157 blocks, one shard and two a process:

- 6 iterations of ``gibbs_iteration_sharded``, whose third sweep captures
  the steps, their sums and adds in one graph and whose later sweeps replay
  it, bit-equal in eps, beta, comp, acum, cass, sigmaG, sigmaE, pi and mu to
  the same iterations with a new ``ShardedSweepGraph`` every sweep (whose
  steps therefore always run eagerly); the launches the replays hold are
  counted, and the capture's span ``gmrm.sweep.capture`` is in the trace;
- then 3 iterations with ``Communicator(enabled=False)``: another graph
  (kernel 9 adding into eps itself), captured in the third, bit-equal to
  the eager sweeps of the unsummed path.
"""

import pytest
import torch
import torch.distributed as dist

from gmrm_tpu_torch import trace
from gmrm_tpu_torch.ops import _build
from gmrm_tpu_torch.ops import sweep_kernel as sk
from gmrm_tpu_torch.ops.blockops import marker_stats
from gmrm_tpu_torch.parallel.distributed import Communicator, init_distributed
from gmrm_tpu_torch.sampler import gibbs
from gmrm_tpu_torch.sampler.dists import RngPlan
from gmrm_tpu_torch.sampler.state import StaticInputs, init_state

T, B, W, K, G = 4, 128, 32, 4, 3
# name: (per-trait NA masks, mb_pad, blocks a shard, shards a process)
CASES = {
    "ukb": (True, 100_352, 32, 1),
    "anchor": (False, 2_560, 157, 1),
    "anchor_s2": (False, 2_560, 79, 2),
}
SUMMED, UNSUMMED = 6, 3


@pytest.fixture
def card():
    """The CUDA device, or a skip where this machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


@pytest.fixture
def nccl_group(card, tmp_path):
    init_distributed(f"file://{tmp_path}/rendezvous", 1, 0, backend="nccl",
                     timeout_seconds=120)
    try:
        yield
    finally:
        gibbs._SWEEP_GRAPHS.clear()      # its graph before its group
        torch.cuda.synchronize()
        dist.destroy_process_group()


def _statics(card, per_trait, mb, nblocks, shards, seed):
    """Each shard's static inputs, made on the card from ``seed``: a random
    bed whose last 60 byte columns and the last shard's last 40 marker
    slots are pad, NA masks (one shared, or T at 1-5%), statistics, G
    groups and the Gram cache."""
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    na = torch.ones((T, 4, mb), device=card)
    na[:, :, mb - 60:] = 0
    if per_trait:
        rates = torch.tensor([0.01, 0.02, 0.035, 0.05], device=card)
        na = na * (torch.rand((T, 4, mb), generator=gen, device=card)
                   > rates[:, None, None])
    nonas = na.sum(dim=(1, 2))
    cva = torch.tensor([[0.0, 1e-4, 1e-3, 1e-2]] * G, device=card)
    cvai = torch.zeros_like(cva)
    cvai[:, 1:] = 1.0 / cva[:, 1:]
    m_pad = nblocks * B
    out = []
    for q in range(shards):
        mt = m_pad - (40 if q == shards - 1 else 0)
        bed = torch.randint(0, 256, (m_pad, mb), generator=gen, device=card,
                            dtype=torch.uint8)
        bed[mt:] = 0x55
        bed[:, mb - 60:] = 0x55
        mave, msig = marker_stats(bed, na, nonas)
        valid = (torch.arange(m_pad, device=card) < mt)[None]
        group_of = torch.randint(0, G, (m_pad,), generator=gen, device=card)
        out.append(StaticInputs(
            bed=bed, na=na.contiguous(),
            mave=torch.where(valid, mave, 0.0).contiguous(),
            msig=torch.where(valid, msig, 0.0).contiguous(),
            group_of=group_of, mtotgrp=torch.bincount(group_of[:mt],
                                                      minlength=G),
            nonas=nonas, cva=cva, cvai=cvai, n_total=float(4 * mb - 240),
            m_local=mt,
            gram_cache=sk.build_gram_cache(bed, na, block_size=B,
                                           shared_na=not per_trait),
            shared_na=not per_trait))
    return out


def _start(card, statics, seed):
    """The chain's start, as init_states_sharded makes it: a standardized
    residual, one buffer the shards share, zero marker state."""
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    na, nonas = statics[0].na, statics[0].nonas
    eps = torch.randn(na.shape, generator=gen, device=card) * na
    eps = eps * torch.sqrt((nonas - 1) / (eps * eps).sum(dim=(1, 2))
                           )[:, None, None]
    pi = torch.tensor([0.5, 0.3, 0.15, 0.05], device=card).expand(G, K)
    first = init_state(T, statics[0].bed.shape[0], G, K, eps.cpu().numpy(),
                       pi.cpu().numpy(), torch.full((T, G), 0.2).numpy(),
                       card)
    return [first] + [first.replace(betas=torch.zeros_like(first.betas),
                                    comp=torch.zeros_like(first.comp),
                                    acum=torch.zeros_like(first.acum))
                      for _ in statics[1:]]


def _iterate(states, statics, rngs, its, comm):
    for it in its:
        states, _ = gibbs.gibbs_iteration_sharded(
            states, statics, it, rngs, block_size=B, wave=W, comm=comm)
    torch.cuda.synchronize()
    return states


LEAVES = ("eps", "betas", "comp", "acum", "cass", "sigmag", "sigmae",
          "pi_est", "mu")


def _snapshot(states):
    """Copies of the states' leaves (the residual is updated in place)."""
    return [{leaf: getattr(st, leaf).clone() for leaf in LEAVES}
            for st in states]


def _assert_equal(got, want, when):
    for g, w in zip(got, _snapshot(want)):
        for leaf in LEAVES:
            a, b = g[leaf], w[leaf]
            assert torch.equal(a, b), (
                f"{when}: {leaf} differs at "
                f"{(a != b).nonzero()[:4].tolist()}")


@pytest.mark.card
@pytest.mark.parametrize("case", list(CASES))
def test_graphed_sweeps_equal_the_eager_steps(card, nccl_group, case,
                                              monkeypatch):
    per_trait, mb, nblocks, shards = CASES[case]
    statics = _statics(card, per_trait, mb, nblocks, shards, 2700)
    rngs = [RngPlan(27027, card, shard=q) for q in range(shards)]
    summing, quiet = Communicator(card), Communicator(card, enabled=False)
    assert summing.sums() and not quiet.sums()
    summed = range(1, SUMMED + 1)
    unsummed = range(SUMMED + 1, SUMMED + UNSUMMED + 1)

    # The graph: captured in the third sweep, replayed from there.
    _build.reset_launch_counts()
    states = _start(card, statics, 7)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        states = _iterate(states, statics, rngs, summed[:4], summing)
    spans = trace.span_summaries()
    assert spans.get("sweep.capture", {}).get("calls") == 1, spans
    states = _iterate(states, statics, rngs, summed[4:], summing)
    (graph,) = gibbs._SWEEP_GRAPHS.values()
    assert graph.graph is not None and graph.sweeps == SUMMED
    # Kernel 9's design at this width (csrc/block_sweep.cu mma_passes):
    # the tensor cores' launches are counted beside the kernel's.
    nt = T if per_trait else 1
    mma = sk.block_sweep_plan(T, B, mb, nt, K, W, shards)["passes"] == (
        "tensor cores")
    assert mma == (mb == 100_352)
    assert graph.captured == ({"block_sweep": nblocks,
                               "block_sweep_mma": nblocks} if mma
                              else {"block_sweep": nblocks})
    got = _snapshot(states)
    states = _iterate(states, statics, rngs, unsummed, quiet)
    (graph_q,) = gibbs._SWEEP_GRAPHS.values()
    assert graph_q is not graph and graph_q.graph is not None
    assert graph_q.total is None
    got_q = _snapshot(states)
    assert _build.launch_counts()["block_sweep"] == nblocks * (
        SUMMED + UNSUMMED)
    assert _build.launch_counts()["block_sweep_mma"] == (
        nblocks * (SUMMED + UNSUMMED) if mma else 0)

    # The eager steps: a new object every sweep never captures.
    with monkeypatch.context() as m:
        m.setattr(gibbs, "sharded_sweep_graph",
                  lambda *a, **k: gibbs.ShardedSweepGraph())
        states = _iterate(_start(card, statics, 7), statics, rngs, summed,
                          summing)
        _assert_equal(got, states, f"{case}, summed")
        states = _iterate(states, statics, rngs, unsummed, quiet)
        _assert_equal(got_q, states, f"{case}, unsummed")
    assert (states[0].comp != 0).any()
