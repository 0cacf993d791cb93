"""Trait chunks: the launches in which a CUDA kernel takes a run's traits.

Within a sweep the traits are independent: each has its own residual,
betas, tables, draws and scaled Gram, and shares only the bed, the block
order, the row order and, under a shared NA mask, the Gram cache.  A kernel
that holds fewer traits than the run has is therefore launched on the
traits in chunks, one launch a chunk, and each chunk computes exactly what
it would compute alone.

``trait_chunks`` is the one place that decides the chunks, for every kernel
whose launch has a trait limit, on the host and without the card:

- ``"passes"`` (kernels 2/4, the fused pass, B): one launch carries any T
  (a thread takes its traits 8 at a time, 4 at float64, in passes over its
  rows), so the launch is split only where even 16-byte column slices of
  all T traits do not fit in shared memory (``pass_plan`` None);
- ``"sweep_blocks"`` (kernels 7/8) and ``"block_sweep"`` (kernel 9): at most
  ``LAUNCH_MAX_T`` = 8 traits a launch (register arrays), launched back to
  back.

Chunks are ``(t0, t1)`` pairs of equal width but the last, which may be
narrower; where the width is free it is the most even split.  Wherever the
kernel takes all T traits at once the plan is the one chunk ``(0, T)``.

The scans (kernels 6, 3 and C) take any T in one launch, a grid of trait
groups where one CTA cannot hold the traits; their planners give the
traits a CTA (``scan_kernel.launch_plan``, ``scan_kernel_wave
.launch_plan``), with ``even_width`` and ``most_that_fit`` below.
"""

from __future__ import annotations

import functools

KERNELS = ("passes", "sweep_blocks", "block_sweep")
LAUNCH_MAX_T = 8   # traits of one launch of kernels 7/8 and 9 (csrc MAX_T)


def even_width(T: int, cap: int) -> int:
    """The width of the most even split of T traits into chunks of at most
    ``cap``."""
    return -(-T // -(-T // cap))


def most_that_fit(T: int, fits) -> int:
    """The most traits t <= T with ``fits(t)``, or 0."""
    lo, hi = 0, T                      # fits is monotone in t
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


@functools.lru_cache(maxsize=None)
def trait_chunks(kernel: str, T: int, B: int, mb: int = 1,
                 es: int = 4) -> tuple:
    """The chunks ``((t0, t1), ...)`` in which ``kernel`` takes T traits
    at block size B, ``mb`` bed bytes a row and ``es``-byte values (4
    float32, 8 float64).  Raises ``ValueError`` where not even one trait
    fits."""
    if T < 1:
        raise ValueError(f"T={T}: a run has at least one trait")
    if kernel == "passes":
        from gmrm_tpu_torch.ops.block_kernels import pass_plan
        if pass_plan(T, B, mb, es) is not None:
            return ((0, T),)
        cap = most_that_fit(T, lambda t: pass_plan(t, B, mb, es) is not None)
        if cap == 0:
            raise ValueError(f"B={B}: the passes' 16-byte slices of one "
                             f"trait exceed shared memory at {es}-byte "
                             f"values")
        width = even_width(T, cap)
    elif kernel in ("sweep_blocks", "block_sweep"):
        width = even_width(T, LAUNCH_MAX_T)
    else:
        raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")
    return tuple((t0, min(T, t0 + width)) for t0 in range(0, T, width))
