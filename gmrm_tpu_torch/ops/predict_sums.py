"""Per-marker OLS sums of predict (port of ``_predict_sums_scan`` and
``_chunked_predict_sums``, gmrm_tpu/predict.py:43, :74).

For every marker row r of a chunk of the bed, on the *uncentered* dosage
``val = a * na`` (the reference's quirk, bayes.cpp:191-205):
``xtx[r] = sum val^2`` and ``xty[r] = sum val * y``, in float32, over the
phase-plane individuals.  CPU tensors take ``predict_sums_plain``; CUDA
tensors launch the decode-and-reduce kernel of csrc/predict_sums.cu.

The kernel reads 16-byte vectors, so on CUDA the rows are ``L`` bytes apart
with ``L`` a multiple of 16: ``pad_columns`` pads a host chunk's rows with
0x55 (a = 0, so pad bytes add nothing), and the (4, L) planes with zeros.
The plain version takes any width.  xtx is a sum of integers below 2^24, so
both versions give it exactly; xty is a float32 sum that they take in
different orders.
"""

from __future__ import annotations

import numpy as np
import torch

from gmrm_tpu_torch.io.bed import MISSING_BYTE
from gmrm_tpu_torch.ops import _build
from gmrm_tpu_torch.ops.decode import decode_planes

PITCH = 16          # the kernel's row pitch is a multiple of this many bytes


def pitch_of(mb: int) -> int:
    """The row pitch of an ``mb``-byte bed row on the device."""
    return -(-mb // PITCH) * PITCH


def pad_columns(x: np.ndarray, width: int, fill) -> np.ndarray:
    """(..., mb) -> (..., width), the new columns set to ``fill``."""
    out = np.full(x.shape[:-1] + (width,), fill, dtype=x.dtype)
    out[..., :x.shape[-1]] = x
    return out


def predict_sums_plain(bed, na, y, chunk: int = 512):
    """bed (M, L) uint8, na and y (4, L) float32 -> (xtx, xty), each (M,)
    float32.  Chunks of markers bound the decoded planes to (chunk, 4, L)
    floats at a time, as the JAX scan does."""
    m = bed.shape[0]
    xtx = torch.empty(m, dtype=torch.float32, device=bed.device)
    xty = torch.empty_like(xtx)
    for s in range(0, m, chunk):
        a, _ = decode_planes(bed[s:s + chunk])                # (c, 4, L)
        val = a * na                   # a * b == a for this decode
        xtx[s:s + chunk] = (val * val).sum(dim=(1, 2))
        xty[s:s + chunk] = (val * y).sum(dim=(1, 2))
    return xtx, xty


def predict_sums(bed, na, y):
    """(xtx, xty) of every row of ``bed`` against one trait's ``na`` and
    ``y`` planes: the plain version on CPU tensors, one launch of the
    kernel on CUDA tensors (rows at a pitch that is a multiple of 16 bytes,
    16-byte aligned; anything else raises ``ValueError``; the C entry packs
    na into a scratch of mask words first).  The two results are the rows
    of one (2, M) tensor, so the caller fetches them in one copy."""
    if bed.device.type == "cpu":
        return predict_sums_plain(bed, na, y)
    m, width = bed.shape
    dev = bed.device
    if width % PITCH:
        raise ValueError(f"bed rows of {width} bytes: the kernel takes a "
                         f"pitch that is a multiple of {PITCH} (pad_columns)")
    _build.check(bed, "bed", torch.uint8, (m, width), dev)
    _build.check(na, "na", torch.float32, (4, width), dev)
    _build.check(y, "y", torch.float32, (4, width), dev)
    for name, x in (("bed", bed), ("na", na), ("y", y)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((2, m), dtype=torch.float32, device=dev)
    if m:
        keep = torch.empty(width // 4, dtype=torch.int32, device=dev)
        _build.launch("predict_sums", bed, na, y, keep, out, m, width)
    return out[0], out[1]


def padded_chunk(bed: np.ndarray, start: int, stop: int, device):
    """Rows ``start:stop`` of a host bed on ``device``, padded to
    ``pitch_of(mb)`` with 0x55 there."""
    mb = bed.shape[1]
    out = torch.full((stop - start, pitch_of(mb)), MISSING_BYTE,
                     dtype=torch.uint8, device=device)
    out[:, :mb] = torch.from_numpy(bed[start:stop]).to(device)
    return out
