"""Distribution samplers on explicit ``torch.Generator`` streams (port of
gmrm_tpu/sampler/dists.py) and the RNG plan of an iteration.

The JAX package splits one key per iteration into per-purpose keys
(gibbs.py:446-452).  ``RngPlan`` seeds a fresh generator per (seed,
iteration, purpose) instead, so a draw does not depend on what ran before
it.  torch and ``jax.random`` give different numbers for one seed: the
equivalence target is the law, tested against scipy.
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


class RngPlan:
    """Generators keyed by (seed, iteration, purpose) on one device."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def gen(self, it: int, purpose: str) -> torch.Generator:
        ss = np.random.SeedSequence(
            [self.seed, int(it), PURPOSES.index(purpose)])
        g = torch.Generator(device=self.device)
        g.manual_seed(int(ss.generate_state(1, np.uint64)[0]))
        return g


def gamma(gen: torch.Generator, shape: torch.Tensor) -> torch.Tensor:
    """Gamma(shape, scale=1) draws, one per element of ``shape``.

    Marsaglia-Tsang on gen's normals and uniforms, with the u^(1/a) boost
    for shape < 1 (0.5*(V0G + m0) can be below 1).  The arithmetic runs in
    float64: at shape 0.5*(V0E + N) ~ 5e3 the acceptance test cancels
    terms of size ~d, which float32 would leave with 1e-4 absolute error.
    The draws are few (T*G*K at most), so this costs nothing.
    """
    f64 = torch.float64
    a = shape.to(f64)
    small = a < 1.0
    ab = torch.where(small, a + 1.0, a)
    d = ab - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    dev = a.device
    x = torch.randn((ROUNDS,) + a.shape, generator=gen, device=dev,
                    dtype=f64)
    uu = torch.rand((ROUNDS,) + a.shape, generator=gen, device=dev,
                    dtype=f64)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(uu) < 0.5 * x * x + d - d * v
                    + d * torch.log(torch.where(v > 0, v, 1.0)))
    first = ok.to(torch.int32).argmax(0, keepdim=True)
    g = (d * v).gather(0, first)[0]
    boost = torch.rand(a.shape, generator=gen, device=dev, dtype=f64)
    return torch.where(small, g * boost ** (1.0 / a), g).to(torch.float32)


def inv_scaled_chisq(gen, a, b):
    """Scaled inverse chi-squared (reference distributions.hpp:24-30):
    (a*b/2) / Gamma(a/2, scale=1).  Broadcasts over a and b."""
    a, b = torch.broadcast_tensors(torch.as_tensor(a, dtype=torch.float32),
                                   torch.as_tensor(b, dtype=torch.float32))
    return (0.5 * a * b) / gamma(gen, 0.5 * a)


def dirichlet_from_counts(gen, alpha):
    """Dirichlet(alpha) over the last axis via normalized gammas, as the
    reference does with rgamma(cass+1, 1) (phenotype.cpp:227-237)."""
    g = gamma(gen, alpha)
    return g / g.sum(dim=-1, keepdim=True)


def beta_11(gen, shape):
    """Beta(1,1) == Uniform(0,1) on gen's device: the reference's sigmaG
    initialization draw (bayes.cpp:327)."""
    return torch.rand(shape, generator=gen, device=gen.device)
