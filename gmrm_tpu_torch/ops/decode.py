"""2-bit PLINK genotype decode and the phase-plane layout (port of
gmrm_tpu/ops/decode.py).

A packed byte j holds individuals ``4j+k`` in bits ``2k..2k+1``.  Every
individual-axis vector on the device (residuals, NA masks) is stored as
``(4, mbytes)`` phase planes: plane k holds individuals ``k, 4+k, ...``.
All consumers reduce over individuals, so the permutation is invisible;
host I/O converts at the boundary with to/from_phase_planes.  The CUDA
kernels decode the same way in ``csrc/decode.cuh``.
"""

from __future__ import annotations

import numpy as np
import torch


def to_phase_planes(v: np.ndarray, mbytes: int | None = None) -> np.ndarray:
    """(..., Np) standard order -> (..., 4, mbytes) phase planes (host)."""
    npad = v.shape[-1]
    if npad % 4:
        raise ValueError("pad individuals to a multiple of 4 first")
    mb = npad // 4
    if mbytes is not None and mb != mbytes:
        raise ValueError(f"expected {mbytes} bytes per plane, got {mb}")
    out = v.reshape(*v.shape[:-1], mb, 4)
    return np.moveaxis(out, -1, -2)


def from_phase_planes(p: np.ndarray) -> np.ndarray:
    """(..., 4, mbytes) phase planes -> (..., 4*mbytes) standard order."""
    x = np.moveaxis(np.asarray(p), -2, -1)
    return x.reshape(*x.shape[:-2], -1)


def decode_planes(bed: torch.Tensor, dtype=torch.float32):
    """Packed bytes (..., mbytes) uint8 -> (a, b) planes (..., 4, mbytes).

    Code map (reference mk_lut.cpp:25-36): 00 -> a=2,b=1; 01 (missing) ->
    a=0,b=0; 10 -> a=1,b=1; 11 -> a=0,b=1.  With c the 2-bit code,
    b = (c != 1) and a = b * ((4 - c) >> 1).
    """
    c = bed.to(torch.int32)
    codes = torch.stack([(c >> (2 * k)) & 3 for k in range(4)], dim=-2)
    b = codes != 1
    a = ((4 - codes) >> 1) * b
    return a.to(dtype), b.to(dtype)
