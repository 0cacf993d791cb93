"""The within-block scans with their per-marker prep (port of
gmrm_tpu/sampler/scan.py, ops/scan_kernel.py:159 and
ops/scan_kernel_wave.py:196).

``block_scan`` is the exact serial recursion (W=1, kernel 6; C at
float64) and ``block_scan_wave`` the wave relaxation (W>1, kernel 3; E at
float64).  Both take the
arguments of the JAX package's ``block_scan`` and return the same
``BlockScanResult``.  The sweep (sampler/gibbs.py) runs the same prep once
per sweep for every block and calls the kernels directly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gmrm_tpu_torch.ops.scan_kernel import serial_scan
from gmrm_tpu_torch.ops.scan_kernel_wave import scan_masks, wave_scan
from gmrm_tpu_torch.ops.sweep_kernel import build_sweep_tables


class BlockScanResult(NamedTuple):
    dbeta_eff: torch.Tensor  # (T, B) beta_old - beta_new, zeroed where the
                             # reference shares no update (adaV / padding)
    beta_new: torch.Tensor   # (T, B)
    comp_new: torch.Tensor   # (T, B) int32
    acum_new: torch.Tensor   # (T, B)
    cass_inc: torch.Tensor   # (T, G, K) int32


def _scan(kernel, c, gs, beta_old, comp_old, acum_old, grp, valid, u, z,
          sigmag, sigmae, pi_est, cva, cvai, nonas, n_total):
    """The per-marker prep of scan_kernel.py:168-201, ``kernel`` on the
    block, and the block's cass counts; in float64 when ``c`` is float64
    (the XLA ``block_scan`` of a float64 run), else float32."""
    T = c.shape[0]
    G, K = cva.shape
    dty = c.dtype if c.dtype == torch.float64 else torch.float32
    lc_t, rd_t, sqb_t = build_sweep_tables(sigmag, sigmae, pi_est, cva,
                                           cvai, nonas, n_total, dtype=dty)
    grp = grp.long()

    def per_marker(tab):                      # (K, T, G) -> (K, T, B)
        return tab[:, :, grp].contiguous()

    base = (c.to(dty) + beta_old.to(dty)
            * (nonas.to(dty)[:, None] - 1.0)).contiguous()
    live, zerob = scan_masks(grp, valid, sigmag)
    i2se = (1.0 / (2.0 * sigmae.to(dty))).contiguous()
    dbeta, beta_new, comp_new, acum_new = kernel(
        base, per_marker(lc_t), per_marker(rd_t), per_marker(sqb_t),
        gs.to(dty).contiguous(), beta_old.to(dty).contiguous(),
        comp_old.to(torch.int32).contiguous(),
        acum_old.to(dty).contiguous(), u.to(dty).contiguous(),
        z.to(dty).contiguous(), live, zerob, i2se)
    idx = grp[None, :] * K + comp_new.long()
    cass_inc = torch.zeros((T, G * K), dtype=torch.int32, device=c.device)
    cass_inc.scatter_add_(1, idx, live)
    return BlockScanResult(dbeta, beta_new, comp_new, acum_new,
                           cass_inc.reshape(T, G, K))


def block_scan(c, gs, beta_old, comp_old, acum_old, grp, valid, u, z,
               sigmag, sigmae, pi_est, cva, cvai, nonas, n_total
               ) -> BlockScanResult:
    """Counterpart of ``block_scan`` and ``block_scan_pallas`` of the JAX
    package: the exact serial recursion over the block (kernel 6).

    c (T, B) msig-scaled x^T eps; gs (T, B, B) scaled Gram; beta_old,
    comp_old, acum_old, u, z (T, B); grp (B,) group ids; valid (B,) bool
    real markers; sigmag (T, G); sigmae, nonas (T,); pi_est (T, G, K);
    cva, cvai (G, K); n_total the dims N.
    """
    return _scan(serial_scan, c, gs, beta_old, comp_old, acum_old, grp,
                 valid, u, z, sigmag, sigmae, pi_est, cva, cvai, nonas,
                 n_total)


def block_scan_wave(c, gs, beta_old, comp_old, acum_old, grp, valid, u, z,
                    sigmag, sigmae, pi_est, cva, cvai, nonas, n_total, *,
                    wave) -> BlockScanResult:
    """Counterpart of ``make_block_scan_wave(wave)`` of the JAX package:
    the wave relaxation over the block (kernel 3; kernel E at float64,
    where the JAX kernel narrows to float32 and this scan stays float64,
    by ``_scan``'s dtype rule)."""
    def kernel(*args):
        return wave_scan(*args, wave=wave)
    return _scan(kernel, c, gs, beta_old, comp_old, acum_old, grp, valid, u,
                 z, sigmag, sigmae, pi_est, cva, cvai, nonas, n_total)
