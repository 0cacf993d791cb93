"""The per-iteration work and the least time, against hand counts at the
anchor's shapes (N = 10,000, Mt = 20,000, T = 4)."""

import pytest

from work import gibbs_iteration as gw


def test_work_at_the_anchor_by_hand():
    w = gw.iteration_work(10_000, 20_000, 4, 4)
    # c-dot and update: 2 passes x 2 multiply-adds x 4 traits x 20,000
    # markers x 10,000 individuals.
    assert w["flops"] == 6_400_000_000
    # bed 20,000 x 2,500 B; residual in and out 2 x 4 x 10,000 x 4 B;
    # masks 4 x 10,000 x 4 B; state 2 x 4 x 20,000 x (4 + 4 + 4) B.
    assert w["bed_bytes"] == 50_000_000
    assert w["bytes"] == 50_000_000 + 320_000 + 160_000 + 1_920_000


def test_least_time_is_the_operations_bound_near_kernel_7s():
    w = gw.iteration_work(10_000, 20_000, 4, 4)
    t, bound = gw.least_seconds(w, "float32")
    assert bound == "operations"
    assert t == pytest.approx(6.4e9 / 67e12)
    # PERF.md's bound of kernel 7 (one sweep at the anchor, padded, with
    # the Gram scaling) is 0.0991 ms by operations.
    assert abs(t * 1e3 - 0.0991) / 0.0991 < 0.05


def test_the_ukb_share_at_float64():
    w = gw.iteration_work(400_000, 250_000, 1, 8)
    t, bound = gw.least_seconds(w, "float64")
    assert bound == "operations"
    assert w["bed_bytes"] == 250_000 * 100_000
    pk = gw.peaks()
    assert pk["hbm_bytes_per_s"] == 3.35e12
    assert pk["float32_flops_per_s"] == pk["float64_flops_per_s"] == 67e12
