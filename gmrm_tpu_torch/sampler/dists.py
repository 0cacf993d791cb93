"""Distribution samplers on explicit ``torch.Generator`` streams (port of
gmrm_tpu/sampler/dists.py) and the RNG plan of an iteration.

The JAX package splits one key per iteration into per-purpose keys
(gibbs.py:446-452).  ``RngPlan`` seeds a generator anew for each (seed,
iteration, purpose) instead, so a draw does not depend on what ran before
it.  torch and ``jax.random`` give different numbers for one seed: the
equivalence target is the law, tested against scipy.

On a marker-sharded run every shard has its own plan, keyed by its global
shard id.  The shuffle and the sweep's draws (``SHARD_KEYED``) depend on
it, as the JAX package folds the device index into ``k_perm``, ``k_u`` and
``k_z`` and nothing else (gibbs.py:448-452); the other draws do not, so the
hyperparameters come out the same on every shard and process (the
reference's rank-0 broadcast).  A draw depends on seed, iteration, purpose
and global shard id, never on how shards are spread over processes.
"""

from __future__ import annotations

import numpy as np
import torch

PURPOSES = ("init", "mu", "block_order", "row_order", "u", "z", "sigmag",
            "pi", "sigmae", "marker_order")

# Marsaglia-Tsang accepts a candidate with probability >= 0.95 for every
# shape >= 1; the chance that an element rejects all ROUNDS candidates is
# below 0.05**ROUNDS = 1e-41, so the sampler draws them in one batch and
# never waits on the device to test for acceptance.
ROUNDS = 32

# The draws that differ from shard to shard.
SHARD_KEYED = ("block_order", "row_order", "marker_order", "u", "z")


class RngPlan:
    """Generators keyed by (seed, iteration, purpose) on one device and,
    for the ``SHARD_KEYED`` purposes of a sharded run, by the global shard
    id ``shard``."""

    def __init__(self, seed: int, device, shard=None):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.shard = None if shard is None else int(shard)
        self.gens = {}

    def gen(self, it: int, purpose: str) -> torch.Generator:
        """The generator of draw ``purpose`` at iteration ``it``.  There is
        one generator object per purpose, seeded anew by every call (a new
        CUDA generator per draw cost the host more than the draw): use it
        before the next call for the same purpose."""
        key = [self.seed, int(it), PURPOSES.index(purpose)]
        if self.shard is not None and purpose in SHARD_KEYED:
            key.append(self.shard + 1)
        ss = np.random.SeedSequence(key)
        g = self.gens.get(purpose)
        if g is None:
            g = self.gens[purpose] = torch.Generator(device=self.device)
        g.manual_seed(int(ss.generate_state(1, np.uint64)[0]))
        return g


def gamma_buffers(shape, device):
    """Empty float64 buffers for :func:`gamma_draws` of ``shape``
    elements: (ROUNDS, *shape) twice and ``shape``."""
    shape = tuple(shape)
    f64 = torch.float64
    return (torch.empty((ROUNDS,) + shape, dtype=f64, device=device),
            torch.empty((ROUNDS,) + shape, dtype=f64, device=device),
            torch.empty(shape, dtype=f64, device=device))


def gamma_draws(gen: torch.Generator, shape, device, out=None):
    """The random half of :func:`gamma`: Marsaglia-Tsang's ROUNDS normals
    and uniforms and the boost uniform for ``shape`` elements, float64,
    in the order :func:`gamma` draws them.  ``out``, buffers from
    :func:`gamma_buffers`, receives them in place."""
    if out is None:
        out = gamma_buffers(shape, device)
    x, uu, boost = out
    torch.randn(x.shape, generator=gen, out=x)
    torch.rand(uu.shape, generator=gen, out=uu)
    torch.rand(boost.shape, generator=gen, out=boost)
    return out


def gamma_from_draws(shape: torch.Tensor, draws) -> torch.Tensor:
    """The arithmetic half of :func:`gamma`: Gamma(shape, scale=1) from the
    draws of :func:`gamma_draws`, float64 for a float64 ``shape`` and
    float32 otherwise.  Issues no draw and never waits on the device, so it
    can be captured into a CUDA graph."""
    x, uu, boost = draws
    a = shape.to(torch.float64)
    small = a < 1.0
    ab = torch.where(small, a + 1.0, a)
    d = ab - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(uu) < 0.5 * x * x + d - d * v
                    + d * torch.log(torch.where(v > 0, v, 1.0)))
    first = ok.to(torch.int32).argmax(0, keepdim=True)
    g = (d * v).gather(0, first)[0]
    return torch.where(small, g * boost ** (1.0 / a), g).to(_out_dtype(shape))


def gamma(gen: torch.Generator, shape: torch.Tensor) -> torch.Tensor:
    """Gamma(shape, scale=1) draws, one per element of ``shape``.

    Marsaglia-Tsang on gen's normals and uniforms, with the u^(1/a) boost
    for shape < 1 (0.5*(V0G + m0) can be below 1).  The arithmetic runs in
    float64: at shape 0.5*(V0E + N) ~ 5e3 the acceptance test cancels
    terms of size ~d, which float32 would leave with 1e-4 absolute error.
    The draws are few (T*G*K at most), so this costs nothing.
    """
    return gamma_from_draws(shape,
                            gamma_draws(gen, shape.shape, shape.device))


def _out_dtype(*xs) -> torch.dtype:
    """float64 when any of ``xs`` is a float64 tensor (a float64 run),
    else float32."""
    return (torch.float64 if any(torch.is_tensor(x) and x.dtype
                                 == torch.float64 for x in xs)
            else torch.float32)


def _scaled_chisq_args(a, b):
    dtype = _out_dtype(a, b)
    return torch.broadcast_tensors(torch.as_tensor(a, dtype=dtype),
                                   torch.as_tensor(b, dtype=dtype))


def inv_scaled_chisq_from_draws(a, b, draws):
    """:func:`inv_scaled_chisq` from the draws of :func:`gamma_draws`."""
    a, b = _scaled_chisq_args(a, b)
    return (0.5 * a * b) / gamma_from_draws(0.5 * a, draws)


def inv_scaled_chisq(gen, a, b):
    """Scaled inverse chi-squared (reference distributions.hpp:24-30):
    (a*b/2) / Gamma(a/2, scale=1).  Broadcasts over a and b."""
    a, b = _scaled_chisq_args(a, b)
    return (0.5 * a * b) / gamma(gen, 0.5 * a)


def dirichlet_from_draws(alpha, draws):
    """:func:`dirichlet_from_counts` from the draws of :func:`gamma_draws`."""
    g = gamma_from_draws(alpha, draws)
    return g / g.sum(dim=-1, keepdim=True)


def dirichlet_from_counts(gen, alpha):
    """Dirichlet(alpha) over the last axis via normalized gammas, as the
    reference does with rgamma(cass+1, 1) (phenotype.cpp:227-237)."""
    g = gamma(gen, alpha)
    return g / g.sum(dim=-1, keepdim=True)


def beta_11(gen, shape):
    """Beta(1,1) == Uniform(0,1) on gen's device: the reference's sigmaG
    initialization draw (bayes.cpp:327)."""
    return torch.rand(shape, generator=gen, device=gen.device)
