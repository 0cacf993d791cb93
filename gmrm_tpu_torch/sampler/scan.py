"""The block scan's result (port of gmrm_tpu/sampler/scan.py:23)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class BlockScanResult(NamedTuple):
    dbeta_eff: torch.Tensor  # (T, B) beta_old - beta_new, zeroed where the
                             # reference shares no update (adaV / padding)
    beta_new: torch.Tensor   # (T, B)
    comp_new: torch.Tensor   # (T, B) int32
    acum_new: torch.Tensor   # (T, B)
    cass_inc: torch.Tensor   # (T, G, K) int32
