"""Sampler state and static inputs as dataclasses of tensors (port of
gmrm_tpu/sampler/state.py, which uses ``flax.struct``).

``state_from_numpy`` / ``static_from_numpy`` take the JAX package's
``SamplerState`` / ``StaticInputs`` leaves as NumPy arrays (the PRNG key
dropped), so that the two packages can be run from the same state.  The
float leaves take the run's dtype: float64 when the residual leaf (``eps``
of a state, ``na`` of the static inputs) is float64, as in a float64 run
of the JAX package, else float32.

A marker-sharded run holds one ``StaticInputs`` and one ``SamplerState``
per local shard.  The per-shard leaves are the marker-indexed ones
(``SHARDED_STATIC``, ``SHARDED_STATE`` and ``m_local``); the replicated
leaves are the same tensor objects in every shard's copy, so the process
has one residual buffer.  With ``n_shards`` the two functions split the
JAX package's global sharded arrays (marker axis = n_shards * m_pad_shard,
gmrm_tpu/parallel/runner.py:59-75) into such lists.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gmrm_tpu_torch.io.bed import MISSING_BYTE


@dataclass
class SamplerState:
    """Evolving sampler state; the marker axis is in storage order."""
    eps: torch.Tensor        # (T, 4, mb) residual phase planes
    betas: torch.Tensor      # (T, M_pad) marker effects
    comp: torch.Tensor       # (T, M_pad) int32 component assignment
    acum: torch.Tensor       # (T, M_pad) CDF value at selection
    cass: torch.Tensor       # (T, G, K) int32 component counts
    sigmag: torch.Tensor     # (T, G)
    sigmae: torch.Tensor     # (T,)
    pi_est: torch.Tensor     # (T, G, K)
    mu: torch.Tensor         # (T,)
    epssum: torch.Tensor     # (T,) reference quirk: stays 0 (phenotype.hpp:52)

    def replace(self, **kw) -> "SamplerState":
        return dataclasses.replace(self, **kw)


@dataclass
class StaticInputs:
    """Inputs that do not change along the chain."""
    bed: torch.Tensor        # (M_pad, mb) uint8, pad rows 0x55 (all missing)
    na: torch.Tensor         # (T, 4, mb) 0/1 observed masks, the run's dtype
    mave: torch.Tensor       # (T, M_pad)
    msig: torch.Tensor       # (T, M_pad)  (0 on pad rows)
    group_of: torch.Tensor   # (M_pad,) int64 group per marker (0 on pads)
    mtotgrp: torch.Tensor    # (G,) int64 markers per group
    nonas: torch.Tensor      # (T,) the run's dtype
    cva: torch.Tensor        # (G, K)
    cvai: torch.Tensor       # (G, K)
    n_total: float           # the dims N
    m_local: int             # real (unpadded) marker count
    # Raw Gram quadrants per natural block, (nblocks, NT, 2B, 2B) float32
    # (ops/sweep_kernel.build_gram_cache); None at W = 1, whose uniform
    # shuffle recomputes each block's Gram (gmrm_tpu/runner.py:223-225).
    gram_cache: Optional[torch.Tensor] = None
    # One NA mask serves every trait (no phenotype has NAs): the W = 1
    # block Gram is then computed once for all traits (NT = 1).
    shared_na: bool = False


def pad_bed(bed: np.ndarray, m_pad: int,
            mb_pad: Optional[int] = None) -> np.ndarray:
    """Pad a bed with all-missing bytes on both axes.

    0x55 decodes to a=b=0, so padded markers and columns contribute
    exactly 0 to every reduction without extra masking.
    """
    m, mb = bed.shape
    if mb_pad is None:
        mb_pad = mb
    out = np.full((m_pad, mb_pad), MISSING_BYTE, dtype=np.uint8)
    out[:m, :mb] = bed
    return out


def pi_prior_from_cva(cva: np.ndarray) -> np.ndarray:
    """Mixture-probability prior (reference bayes.hpp:34-47):
    pi0 = 0.5, pi_k = 0.5*cva_k/sum_{j>=1} cva_j."""
    g, k = cva.shape
    pi = np.full((g, k), 0.5)
    ssum = cva[:, 1:].sum(axis=1)
    pi[:, 1:] = 0.5 * cva[:, 1:] / ssum[:, None]
    return pi


def init_state(n_traits, m_pad, n_groups, n_mixtures, eps0, pi_prior,
               sigmag0, device, dtype=torch.float32) -> SamplerState:
    """The start of a chain with its float leaves in ``dtype``."""
    t = n_traits
    dty = dtype

    def zeros(*shape, dtype=dty):
        return torch.zeros(shape, dtype=dtype, device=device)

    pi = torch.as_tensor(np.asarray(pi_prior), dtype=dty, device=device)
    return SamplerState(
        eps=torch.as_tensor(np.asarray(eps0), dtype=dty,
                            device=device).contiguous(),
        betas=zeros(t, m_pad),
        comp=zeros(t, m_pad, dtype=torch.int32),
        acum=zeros(t, m_pad),
        cass=zeros(t, n_groups, n_mixtures, dtype=torch.int32),
        sigmag=torch.as_tensor(np.asarray(sigmag0), dtype=dty,
                               device=device),
        sigmae=zeros(t),
        pi_est=pi.expand(t, n_groups, n_mixtures).contiguous(),
        mu=zeros(t),
        epssum=zeros(t),
    )


_INT_FIELDS = {"comp": torch.int32, "cass": torch.int32,
               "group_of": torch.int64, "mtotgrp": torch.int64}


def _tensor(name, x, device, fdtype=torch.float32):
    """A leaf as a tensor: the int fields as their dtype, uint8 as it is,
    every float leaf in ``fdtype``."""
    dtype = _INT_FIELDS.get(name)
    if dtype is None:
        x = np.asarray(x)
        dtype = torch.uint8 if x.dtype == np.uint8 else fdtype
    return torch.tensor(np.asarray(x), device=device).to(dtype).contiguous()


def _run_dtype(x) -> torch.dtype:
    """float64 when the residual-shaped leaf ``x`` is, else float32."""
    return (torch.float64 if np.asarray(x).dtype == np.float64
            else torch.float32)


# Marker-indexed leaves and their marker axis: one slice per shard.
SHARDED_STATE = {"betas": 1, "comp": 1, "acum": 1}
SHARDED_STATIC = {"bed": 0, "mave": 1, "msig": 1, "group_of": 0,
                  "gram_cache": 0}


def _split_shards(full, axes, n_shards, extra=None):
    """Per-shard copies of ``full``: the leaves in ``axes`` cut into
    n_shards equal parts along their marker axis, the others shared."""
    out = []
    for i in range(n_shards):
        kw = {name: getattr(full, name).chunk(n_shards, dim=axis)[i]
              .contiguous()
              for name, axis in axes.items()
              if getattr(full, name) is not None}
        if extra is not None:
            kw.update(extra(i))
        out.append(dataclasses.replace(full, **kw))
    return out


def state_from_numpy(d: dict, device, n_shards=None):
    """The JAX package's SamplerState leaves (NumPy, ``key`` ignored), the
    float leaves in the dtype of ``eps`` (float64 or float32).  With
    ``n_shards``, a list of per-shard states from the global sharded
    arrays, sharing the replicated leaves."""
    fdtype = _run_dtype(d.get("eps"))
    full = SamplerState(**{f.name: _tensor(f.name, d[f.name], device, fdtype)
                           for f in dataclasses.fields(SamplerState)})
    if n_shards is None:
        return full
    return _split_shards(full, SHARDED_STATE, n_shards)


def static_from_numpy(d: dict, device, n_shards=None):
    """The JAX package's StaticInputs leaves as NumPy arrays, the float
    leaves in the dtype of ``na`` (float64 or float32; a Gram cache stays
    float32).  Its ``gram_cache`` is None on a W = 1 run; ``shared_na``,
    which the JAX
    package passes to its sweep as an argument, keeps its default unless
    ``d`` has it.  With ``n_shards``, a list of per-shard inputs from the
    global sharded arrays (``m_local`` then holds one count per shard)."""
    if n_shards is not None:
        m_local = np.asarray(d["m_local"]).reshape(n_shards)
        full = static_from_numpy({**d, "m_local": 0}, device)
        return _split_shards(full, SHARDED_STATIC, n_shards,
                             lambda i: {"m_local": int(m_local[i])})
    kw = {}
    fdtype = _run_dtype(d.get("na"))
    for f in dataclasses.fields(StaticInputs):
        if f.name not in d:
            continue
        x = d[f.name]
        if x is None or f.name == "shared_na":
            kw[f.name] = x
        elif f.name == "n_total":
            kw[f.name] = float(x)
        elif f.name == "m_local":
            kw[f.name] = int(x)
        else:
            kw[f.name] = _tensor(f.name, x, device,
                                 torch.float32 if f.name == "gram_cache"
                                 else fdtype)
    return StaticInputs(**kw)
