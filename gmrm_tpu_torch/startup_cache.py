"""The startup cache (``--cache-dir``): the marker statistics and, in wave
mode, the Gram cache of a run's markers, kept on disk between runs of one
dataset and geometry (counterpart of the cache half of
gmrm_tpu/runner.build_static, gmrm_tpu/runner.py:192-269, and of
gmrm_tpu/parallel/runner.py:632-668).

The key is a blake2b digest of the bed rows the run loaded (the bytes it
read, in storage order and padded), of the whole phen files (they set the
NA masks) and of the geometry, which names the statistics' dtype (an entry
of a float32 run is never served to a float64 one).  The JAX package
fingerprints the ``.bed`` by its size, mtime and first and last MiB, so
an edit in the middle with the mtime restored serves a stale cache; here
any changed byte of the rows read changes the key.  The digest costs one pass over the loaded rows.

A marker-sharded run keeps one entry per shard, keyed by its global id and
the shard layout.  The cold build of a shard involves no other shard and no
other process, and a warm entry is bit-equal to what the cold build gives
(the Gram entries are exact integers below 2^24), so every process decides
warm or cold for its own shards alone.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

FORMAT = "gmrm_tpu_torch startup cache 1"


class StartupCache:
    """One entry: the cache file of ``bed`` (the loaded, padded rows of one
    device or shard) under ``geometry``.  ``warm`` says whether
    :meth:`load` found it; ``digest_seconds`` is the key's cost."""

    def __init__(self, cache_dir: str, bed: np.ndarray,
                 phen_files: Sequence[str], geometry: dict):
        t0 = time.perf_counter()
        h = hashlib.blake2b(digest_size=16)
        h.update(memoryview(np.ascontiguousarray(bed)).cast("B"))
        for fp in phen_files:
            with open(fp, "rb") as fh:
                h.update(fh.read())
        h.update(repr((FORMAT, sorted(geometry.items()))).encode())
        self.digest_seconds = time.perf_counter() - t0
        os.makedirs(cache_dir, exist_ok=True)
        self.path = os.path.join(cache_dir, f"startup_{h.hexdigest()}.npz")
        self.warm = False

    def load(self, device, dtype=torch.float32
             ) -> Optional[Tuple[torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor]]]:
        """(mave, msig, gram_cache or None) on ``device``, the statistics in
        the run's ``dtype`` (the key holds it, so an entry is read in the
        dtype it was written in) and the Gram cache in float32, or None
        when the entry is not there."""
        if not os.path.exists(self.path):
            return None
        with np.load(self.path) as z:
            out = [torch.tensor(z[k], dtype=torch.float32 if k == "gram"
                                else dtype, device=device).contiguous()
                   if k in z.files else None
                   for k in ("mave", "msig", "gram")]
        self.warm = True
        return tuple(out)

    def save(self, mave: torch.Tensor, msig: torch.Tensor,
             gram_cache: Optional[torch.Tensor]) -> None:
        arrays = {"mave": mave.cpu().numpy(), "msig": msig.cpu().numpy()}
        if gram_cache is not None:
            arrays["gram"] = gram_cache.cpu().numpy()
        tmp = f"{self.path[:-len('.npz')]}.tmp.{os.getpid()}.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, self.path)
