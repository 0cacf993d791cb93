"""The block Gram's launch plan (gmrm_tpu_torch/ops/block_gram.gram_plan,
which blocks_gram_scaled passes to csrc/block_gram.cu) and its run
budget.  Plans are host arithmetic; the kernel that uses them runs on the
card (chip_smoke.py phases 2 and 7a)."""

import pytest

from gmrm_tpu_torch.ops import block_gram as bg

T = 4
SMS = 132          # an H100 SXM's SMs


@pytest.mark.parametrize("B0", range(0, 512, 64))
@pytest.mark.parametrize("nt", [1, T], ids=["NT1", "NT4"])
def test_gram_plan_covers_every_output_once(nt, B0):
    """For B = B0 + 1 .. B0 + 64: the items (a 64-row band and a
    128-column tile of a block and mask) cover every (j, i) of the B x B
    Gram exactly once, each consumer half of a tile has its 64 columns;
    a band lies inside its tile whenever B <= 128 (a stage then decodes
    each bed byte once per plane: 4 panels), else the stage has room for
    its own 2; the stages fit shared memory; the grid is one CTA an SM
    and its rounds cover the items."""
    for B in range(B0 + 1, B0 + 65):
        for nb in (1, 157):
            p = bg.gram_plan(B, nt, nb, SMS)
            assert p["bands"] * bg.BAND >= B > (p["bands"] - 1) * bg.BAND
            assert p["tiles"] * bg.ITILE >= B > (p["tiles"] - 1) * bg.ITILE
            assert p["items"] == nb * nt * p["bands"] * p["tiles"]
            assert p["grid"] == min(p["items"], SMS)
            assert (p["rounds"] - 1) * p["grid"] < p["items"]
            assert p["rounds"] * p["grid"] >= p["items"]
            assert p["panels"] == (4 if B <= bg.ITILE else 6)
            assert 2 <= p["stages"] <= bg.MAX_STAGES
            assert p["smem"] <= bg.SMEM_CAP
            assert p["smem"] == (bg.SMEM_FIXED
                                 + p["stages"] * p["panels"] * bg.PANEL)
        p = bg.gram_plan(B, nt, 1, SMS)
        seen = [[0] * B for _ in range(B)]
        for jb in range(p["bands"]):
            for ip in range(p["tiles"]):
                j0, i0 = jb * bg.BAND, ip * bg.ITILE
                inside = i0 <= j0 < i0 + bg.ITILE
                assert inside or p["panels"] == 6
                for w in (0, 1):          # the two consumer warpgroups
                    for j in range(j0, min(B, j0 + bg.BAND)):
                        c0 = i0 + w * bg.BAND
                        for i in range(c0, min(B, c0 + bg.BAND)):
                            seen[j][i] += 1
        assert all(v == 1 for row in seen for v in row), B


def test_gram_plan_at_the_anchor():
    """The anchor (B=128, 157 blocks): 2 bands x 1 tile a block and mask,
    5 stages of 4 panels, 314 items at NT=1 (3 rounds of 132 CTAs) and
    1,256 at NT=4 (10 rounds)."""
    one = bg.gram_plan(128, 1, 157, SMS)
    four = bg.gram_plan(128, T, 157, SMS)
    assert (one["bands"], one["tiles"], one["panels"], one["stages"]) == (
        2, 1, 4, 5)
    assert (one["items"], one["grid"], one["rounds"]) == (314, 132, 3)
    assert (four["items"], four["grid"], four["rounds"]) == (1256, 132, 10)
    assert one["smem"] == (1024 + 16384 + 128 + 4096 + 4 * 256 * 32
                           + 5 * 4 * 8192)


def test_f64_nt4_sweep_at_the_anchor_is_one_run():
    """A float64 sweep at the anchor's geometry (T=4, B=128, 157 blocks)
    builds all its Grams in one run whatever its masks: the budget counts
    the scaled Grams only (82 MB of float64), so NT=4 plans one launch
    as NT=1 does, and so does float32."""
    for elem in (8, 4):
        run = bg.gram_run_blocks(T, 128, 157, elem)
        assert run == 157 and -(-157 // run) == 1
    assert 157 * T * 8 * 128 ** 2 <= bg.GRAM_RUN_BYTES
