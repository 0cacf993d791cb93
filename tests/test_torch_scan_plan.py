"""The serial scan's shared memory plans (gmrm_tpu_torch/ops/scan_kernel):
kernel 6's float32 plan, unchanged, and kernel C's float64 plan, which
splits the traits over CTAs so that every block the float64 kernel takes
runs.  Plans are host arithmetic; the kernels that use them run on the
card (chip_smoke.py phases 2 and 7a)."""

import pytest

from gmrm_tpu_torch.ops import scan_kernel as sk

TS = (1, 4, 8, 33, 200)
BS = (1, 37, 128, 203, 512)
KS = (2, 4, 8, 16)

# The float32 plan (mode, GR, NG) on the grid, per (T, B) for K = 2, 4, 8,
# 16, as the float32 kernel had it before it became a template of the
# value type.
F32_PLANS = {
    (1, 1): [(2, 8, 1), (2, 8, 1), (2, 8, 1), (2, 8, 1)],
    (1, 37): [(2, 8, 8), (2, 8, 8), (2, 8, 8), (2, 8, 8)],
    (1, 128): [(2, 8, 16), (2, 8, 16), (2, 8, 16), (2, 8, 16)],
    (1, 203): [(2, 8, 16), (2, 8, 16), (2, 8, 16), (2, 8, 16)],
    (1, 512): [(2, 8, 8), (2, 8, 8), (2, 8, 8), (2, 8, 4)],
    (4, 1): [(2, 8, 1), (2, 8, 1), (2, 8, 1), (2, 8, 1)],
    (4, 37): [(2, 8, 8), (2, 8, 8), (2, 8, 8), (2, 8, 8)],
    (4, 128): [(2, 8, 8), (2, 8, 8), (2, 8, 8), (2, 8, 4)],
    (4, 203): [(2, 8, 4), (2, 8, 4), (2, 8, 2), (1, 8, 4)],
    (4, 512): [(0, 8, 2), (0, 8, 2), (0, 8, 2), (0, 8, 2)],
    (8, 1): [(2, 8, 1), (2, 8, 1), (2, 8, 1), (2, 8, 1)],
    (8, 37): [(2, 8, 8), (2, 8, 8), (2, 8, 8), (2, 8, 8)],
    (8, 128): [(2, 8, 4), (2, 8, 2), (2, 8, 2), (1, 8, 4)],
    (8, 203): [(1, 8, 2), (1, 8, 2), (1, 8, 2), (1, 8, 2)],
    (8, 512): [(0, 4, 2), (0, 4, 2), (0, 4, 2), (0, 4, 2)],
    (33, 1): [(2, 8, 1), (2, 8, 1), (2, 8, 1), (2, 8, 1)],
    (33, 37): [(2, 8, 2), (2, 8, 2), (1, 8, 2), (1, 8, 2)],
    (33, 128): [(0, 4, 2), (0, 4, 2), (0, 4, 2), (0, 4, 2)],
    (33, 203): [None, None, None, None],
    (33, 512): [None, None, None, None],
    (200, 1): [(2, 8, 1), (2, 8, 1), (2, 8, 1), (2, 8, 1)],
    (200, 37): [None, None, None, None],
    (200, 128): [None, None, None, None],
    (200, 203): [None, None, None, None],
    (200, 512): [None, None, None, None],
}

# Kernel C's shared memory at the anchor (T=4, B=128, K=4), hand-summed in
# doubles: the barriers (528 bytes), the counters (256 bytes), nm1 and
# i2se, eight steps of packed inputs (8 steps x 32 lanes x 8 values), corr
# (4 x 128), the raw results (4 x 4 x 128), the state (9 x 512), the
# tables (3 x 4 x 512) and a ring of 2 groups of 8 rows (4 x 128 each).
ANCHOR_F64_SMEM = 8 * (66 + 32 + 64 + 2048 + 512 + 2048 + 4608 + 6144
                       + 2 * 8 * 512)


def _ring_ok(plan, B):
    mode, GR, NG = plan[:3]
    assert mode in (0, 1, 2) and GR in (1, 2, 4, 8)
    assert 1 <= NG <= sk.MAX_NG and NG & (NG - 1) == 0
    assert NG * GR >= B - 1 or NG >= (2 if GR > 1 else 4)


@pytest.mark.parametrize("T", TS)
def test_f32_scan_plan_is_unchanged(T):
    """The float32 plan (4-byte values, the default) on the grid is the
    one the float32 kernel had before the template: its shared memory
    layout and the launches of every float32 run stay as they were."""
    for B in BS:
        got = [sk.scan_plan(T, B, K) for K in KS]
        assert got == F32_PLANS[(T, B)], (T, B)
        assert got == [sk.scan_plan(T, B, K, 4) for K in KS]
        for K, plan in zip(KS, got):
            if plan is not None:
                _ring_ok(plan, B)
                assert (4 * sk._layout_words(T, B, K, *plan)
                        <= sk.SMEM_BYTES)


@pytest.mark.parametrize("B", BS)
def test_f64_plan_fits_every_block(B):
    """Every (T, B, K) of the grid gets a float64 plan (the float64 kernel
    took them all before its redesign): TG traits a CTA, no more than one
    pass over the lanes and than T, a layout within one CTA's shared
    memory at 8-byte values, and no other TG with a more staged layout or,
    at the same one, more traits a CTA.  The wrapper's check returns it."""
    for T in TS:
        for K in KS:
            plan = sk.f64_plan(T, B, K)
            assert plan is not None, (T, B, K)
            mode, GR, NG, TG = plan
            _ring_ok(plan, B)
            assert 1 <= TG <= min(T, 32 // sk.lanes_of(K))
            assert (8 * sk._layout_words(TG, B, K, mode, GR, NG, 8)
                    <= sk.SMEM_BYTES)
            assert sk.scan_plan(TG, B, K, 8) == (mode, GR, NG)
            for tg in range(1, min(T, 32 // sk.lanes_of(K)) + 1):
                other = sk.scan_plan(tg, B, K, 8)
                if other is not None:
                    assert (other[0], tg) <= (mode, TG)
            assert sk._plan_f64_or_raise(T, B, K) == plan


def test_f64_plan_at_the_anchor():
    """T=4, B=128, K=4: one CTA of all four traits, state and tables
    staged, a ring of two groups of 8 rows; the layout hand-summed."""
    plan = sk.f64_plan(4, 128, 4)
    assert plan == (2, 8, 2, 4)
    assert 8 * sk._layout_words(4, 128, 4, *plan[:3], 8) == ANCHOR_F64_SMEM
    # At 4-byte values the same formula is the float32 kernel's layout.
    assert (4 * sk._layout_words(4, 128, 4, 2, 8, 8)
            == 4 * (132 + 128 + 2048 + 512 + 2048 + 4608 + 6144
                    + 8 * 8 * 512))


@pytest.mark.parametrize("K,lanes,per_cta", [(2, 4, 8), (4, 4, 8),
                                             (8, 8, 4), (16, 16, 2)])
def test_f64_plan_splits_traits_over_ctas(K, lanes, per_cta):
    """Many traits: one pass of traits a CTA at most (32 lanes over 4, 8
    or 16 lanes a trait), the grid takes the rest; the float64 limits
    (T = 65,535, B = 512) still have a plan."""
    assert sk.lanes_of(K) == lanes
    assert sk.f64_plan(200, 37, K)[3] == per_cta
    for B in (1, 512):
        mode, GR, NG, TG = sk._plan_f64_or_raise(sk.F64_MAX_T, B, K)
        assert TG <= per_cta
        assert -(-sk.F64_MAX_T // TG) >= sk.F64_MAX_T // per_cta


def test_f64_plan_refusals():
    """Beyond the float64 kernel's limits the wrapper's check raises; any
    K has a plan: past 16 components one trait a CTA (a trait takes all
    32 lanes), its tables staged at K=17 and left in global memory at K=65,
    where they would not fit beside a ring of 16 rows."""
    assert sk.lanes_of(17) == sk.lanes_of(65) == 32
    assert sk._plan_f64_or_raise(4, 128, 17) == (2, 8, 16, 1)
    mode, GR, NG, TG = sk._plan_f64_or_raise(4, 128, 65)
    assert (mode, TG) == (1, 1)
    assert 8 * sk._layout_words(1, 128, 65, 2, 8, 2, 8) > sk.SMEM_BYTES
    assert 8 * sk._layout_words(1, 128, 65, mode, GR, NG, 8) <= sk.SMEM_BYTES
    with pytest.raises(ValueError, match="markers a block"):
        sk._plan_f64_or_raise(4, sk.F64_MAX_B + 1, 4)
    with pytest.raises(ValueError, match="traits exceed"):
        sk._plan_f64_or_raise(sk.F64_MAX_T + 1, 128, 4)
