"""The work one Gibbs iteration needs, from the shapes alone.

Whatever kernels do it, an iteration of the sweep has to read every
marker's genotypes once (the packed bed, 2 bits an individual), read and
write the residual of every trait once, read the observed masks once,
and read and write each marker's state (effect, component, CDF value)
once; and per marker, trait and individual it has to form the product of
the genotype with the residual (the c-dot) and the residual's update,
each two multiply-adds on the decoded dosage planes a and b (the
convention of the per-kernel bounds: 4 operations an individual a pass).
The least time is the larger of the bytes over the memory rate and the
operations over the peak of the run's float type.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "h100_peaks.json"


def peaks() -> dict:
    with open(PEAKS) as fh:
        return json.load(fh)


def iteration_work(n: int, m: int, traits: int, float_bytes: int) -> dict:
    """Operations and bytes of one iteration at N individuals, Mt markers
    and T traits, with floats of ``float_bytes`` bytes."""
    flops = 2 * 4 * traits * m * n
    bed = m * (-(-n // 4))
    residual = 2 * traits * n * float_bytes
    masks = traits * n * float_bytes
    marker_state = 2 * traits * m * (2 * float_bytes + 4)
    return {"flops": flops, "bytes": bed + residual + masks + marker_state,
            "bed_bytes": bed}


def least_seconds(work: dict, dtype: str, pk: dict = None) -> tuple:
    """(seconds, "bytes" or "operations"): the least time of ``work`` on
    the card at its published peaks."""
    pk = pk or peaks()
    t_bytes = work["bytes"] / pk["hbm_bytes_per_s"]
    t_ops = work["flops"] / pk[f"{dtype}_flops_per_s"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
