"""Per-marker statistics (port of gmrm_tpu.ops.blockops.marker_stats_jax).

The JAX package leaves this one-time decode-and-reduce pass to XLA, so the
port keeps it in plain PyTorch.  The three sums are exact integers below
2^24, so float32 products with float32 accumulation give them exactly on
either device (TF32 is off, see runner.py).
"""

from __future__ import annotations

import torch

from gmrm_tpu_torch.ops.decode import decode_planes


def marker_stats(bed: torch.Tensor, na: torch.Tensor, nonas: torch.Tensor,
                 chunk: int = 512):
    """Per-marker mean and inverse standard deviation for every trait.

    bed (M, mb) uint8; na (T, 4, mb) 0/1 float32; nonas (T,).
    Returns (mave, msig), each (T, M) float32:
      mave = sum(a*na) / sum(b*na)
      msig = 1/sqrt((sum(a^2 na) - 2 mave sum(a na) + mave^2 sum(b na))
                    / (nonas - 1))
    which is the reference's two-pass formula (phenotype.cpp:466-556),
    because a*b == a and b*b == b for this decode.  Pad rows (all 0x55)
    give 0/0; the caller zeroes them.
    """
    m = bed.shape[0]
    t = na.shape[0]
    naf = na.to(torch.float32).reshape(t, -1)               # (T, 4mb)
    sa = torch.empty((t, m), dtype=torch.float32, device=bed.device)
    sb = torch.empty_like(sa)
    saa = torch.empty_like(sa)
    # Chunks bound the decoded planes to (chunk, 4, mb) floats at a time.
    for s in range(0, m, chunk):
        a, b = decode_planes(bed[s:s + chunk])               # (c, 4, mb)
        a = a.reshape(a.shape[0], -1)
        b = b.reshape(b.shape[0], -1)
        sa[:, s:s + chunk] = naf @ a.T
        sb[:, s:s + chunk] = naf @ b.T
        saa[:, s:s + chunk] = naf @ (a * a).T
    mave = sa / sb
    ssq = saa - 2.0 * mave * sa + mave * mave * sb
    msig = 1.0 / torch.sqrt(ssq / (nonas.to(torch.float32)[:, None] - 1.0))
    return mave, msig
