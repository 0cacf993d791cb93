"""The marker partition over shards (port of gmrm_tpu/parallel/mesh.py).

The reference's only distributed axis is markers over MPI ranks with a
static block partition, remainder to low ranks (``src/bayes.cpp:903-925``).
Each shard is padded to a common length (the reference's Mm idle-step
scheme), so every shard runs the same number of block steps.  The JAX
package maps shards to the devices of a mesh; here a shard belongs to a
process (``distributed.local_shard_ids``), which runs all of its shards on
its one device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def marker_blocks(m_total: int, n_shards: int) -> List[Tuple[int, int]]:
    """(start, length) per shard: block partition, remainder to low shards
    (reference set_block_of_markers, bayes.cpp:903-925)."""
    size = m_total // n_shards
    modu = m_total % n_shards
    out = []
    cum = 0
    for i in range(n_shards):
        ln = size + 1 if i < modu else size
        out.append((cum, ln))
        cum += ln
    assert cum == m_total
    return out


def shard_markers(arr: np.ndarray, n_shards: int, m_pad_shard: int, fill):
    """Split a (M_total, ...) host array into (n_shards, m_pad_shard, ...)
    with per-shard padding."""
    blocks = marker_blocks(arr.shape[0], n_shards)
    out = np.full((n_shards, m_pad_shard) + arr.shape[1:], fill,
                  dtype=arr.dtype)
    for i, (s, ln) in enumerate(blocks):
        out[i, :ln] = arr[s:s + ln]
    return out
