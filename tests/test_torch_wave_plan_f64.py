"""Kernel E's launch plan (gmrm_tpu_torch/ops/scan_kernel_wave.py
``launch_plan`` at 8-byte values, ``f64_traits_a_cta``): the traits are
spread over CTAs so that each CTA stages the tables and every wave's
packed Gram rows, or, where one trait cannot hold every wave, as much as
one trait holds; kernel 3's float32 plans are as they were.  The shared
memory the plan counts (``_layout_words``) is held against the kernel's
own ``make_layout`` (csrc/wave_scan.cu), compiled here with the host
compiler from the lines of the source.  Plans are host arithmetic; the
kernel runs on the card (chip_smoke.py phase 7h)."""

import re
import subprocess

import pytest
import torch

from gmrm_tpu_torch.ops import _build
from gmrm_tpu_torch.ops import scan_kernel_wave as sw
from gmrm_tpu_torch.ops.trait_chunks import even_width

F64 = torch.float64
CAP = sw.SMEM_BYTES // 8

# Kernel 3's float32 plans (tab, gsw, TG) at the shapes the float32 tests
# and chip_smoke.py pin (tests/test_torch_composed.py, test_torch_trait_
# chunks.py; phase 2's and phase 8's kernel 3 cases), as they were before
# kernel E's plan changed.
F32_PLANS = {
    (4, 128, 4, 32): (1, 3, 4), (2, 64, 4, 8): (1, 7, 2),
    (8, 128, 16, 32): (0, 2, 8), (4, 256, 4, 32): (1, 1, 4),
    (8, 256, 16, 32): (0, 0, 8), (3, 30, 3, 5): (1, 5, 3),
    (1, 32, 2, 32): (1, 0, 1), (33, 128, 4, 32): (0, 0, 33),
    (48, 128, 4, 32): (0, 0, 24), (16, 128, 4, 32): (1, 0, 16),
    (12, 64, 4, 8): (1, 7, 12), (9, 512, 4, 32): (0, 0, 9),
    (40, 256, 8, 16): (0, 0, 20), (4, 128, 4, 16): (1, 7, 4),
    (6, 96, 4, 32): (1, 2, 6), (5, 128, 8, 32): (1, 3, 5),
}


@pytest.mark.parametrize("K", [4, 8, 16])
def test_f64_plans_at_b128_stage_everything(K):
    """At B=128, W=32 and K = 4, 8, 16, every T from 1 to 40 gets a plan
    that stages the tables and all three foldable waves' rows, F64_TG
    traits a CTA (fewer where T is smaller), the most even split of T;
    the CTA fits the shared memory."""
    B, W = 128, 32
    for T in range(1, 41):
        tab, gsw, TG = sw.launch_plan(T, B, K, W, 8)
        assert (tab, gsw) == (1, B // W - 1)
        assert TG == even_width(T, min(T, sw.F64_TG))
        assert sw._layout_words(TG, B, K, W, tab, gsw, 8) <= CAP
        groups = -(-T // TG)
        assert groups * TG >= T > (groups - 1) * TG


@pytest.mark.parametrize("K", [4, 8, 16])
def test_f64_plan_at_b256_stages_what_one_trait_holds(K):
    """At B=256 one trait cannot hold every wave (278,752 bytes at K=4):
    the plan stages what one trait holds (the tables first, then waves in
    wave order: four of seven at K=4) and takes the most traits a CTA that
    stage as much, so that fewer CTAs run on a tie."""
    B, W = 256, 32
    one = sw.wave_plan(1, B, K, W, 8)
    assert 8 * sw._layout_words(1, B, K, W, 1, B // W - 1, 8) > sw.SMEM_BYTES
    assert one[1] < B // W - 1
    if K == 4:
        assert one == (1, 4)
        assert 8 * sw._layout_words(1, B, K, W, 1, 7, 8) == 278752
    for T in range(1, 17):
        tab, gsw, TG = sw.launch_plan(T, B, K, W, 8)
        assert (tab, gsw) == one
        assert sw._layout_words(TG, B, K, W, tab, gsw, 8) <= CAP
        most = max(t for t in range(1, T + 1)
                   if sw.wave_plan(t, B, K, W, 8) == one)
        assert TG == even_width(T, most)


def test_f64_plan_refuses_what_one_trait_cannot_hold():
    """One trait's block state beyond a CTA raises, as before; any K has a
    plan: at K=17 one trait a CTA stages everything, at K=65 its tables
    (200 KB) leave no room for a wave's rows, which are read from global
    memory."""
    with pytest.raises(ValueError, match="shared memory"):
        sw.launch_plan(4, 4096, 4, 32, 8)
    assert sw.launch_plan(4, 128, 17, 32, 8) == (1, 3, 1)
    assert sw.launch_plan(4, 128, 65, 32, 8) == (1, 0, 1)
    assert 8 * sw._layout_words(1, 128, 65, 32, 1, 1, 8) > sw.SMEM_BYTES
    with pytest.raises(ValueError, match="divide"):
        sw.launch_plan(4, 128, 4, 24, 8)


@pytest.mark.parametrize("shape", sorted(F32_PLANS))
def test_f32_plans_unchanged(shape):
    """Kernel 3's float32 plans are those it had: one CTA of all traits
    where they fit, else the even split of trait groups."""
    assert sw.launch_plan(*shape) == F32_PLANS[shape]
    assert sw.launch_plan(*shape, 4) == F32_PLANS[shape]


def _make_layout_words(tmp_path, cases):
    """csrc/wave_scan.cu's make_layout<double>(...).words at each case
    (T, B, K, W, tab, gsw), compiled from the source's own lines with the
    host compiler (its __host__ __device__ marks defined away)."""
    src = (_build.CSRC / "wave_scan.cu").read_text()
    nstate = re.search(r"constexpr int NSTATE = \d+;", src).group(0)
    a = src.index("__host__ __device__ constexpr int al4")
    b = src.index("__device__ __forceinline__ unsigned long long global_ns")
    calls = "\n".join(
        f'  std::printf("%d\\n", make_layout<double>({", ".join(map(str, c))}'
        f').words);' for c in cases)
    prog = ("#include <cstdio>\n#define __host__\n#define __device__\n"
            f"{nstate}\n{src[a:b]}\nint main() {{\n{calls}\n  return 0;\n}}\n")
    (tmp_path / "layout.cpp").write_text(prog)
    exe = tmp_path / "layout"
    cxx = _build._host_cxx()
    subprocess.run([*cxx, "-std=c++17", "-o", str(exe),
                    str(tmp_path / "layout.cpp")], check=True,
                   capture_output=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True).stdout
    return [int(x) for x in out.split()]


def test_layout_words_match_the_kernels_make_layout(tmp_path):
    """``_layout_words(..., es=8)`` is the kernel's make_layout<double> at
    the new plans (the anchor, T=16 and 33, B=256, K=16, W=8, the
    unaligned B=36 W=6) and at the parent design's one-CTA plans."""
    shapes = [(4, 128, 4, 32), (16, 128, 4, 32), (33, 128, 4, 32),
              (4, 256, 4, 32), (2, 64, 16, 16), (4, 128, 4, 8),
              (3, 36, 8, 6), (8, 128, 16, 32)]
    cases = []
    for T, B, K, W in shapes:
        tab, gsw, TG = sw.launch_plan(T, B, K, W, 8)
        cases.append((TG, B, K, W, tab, gsw))
    cases += [(4, 128, 4, 32, 1, 1), (16, 128, 4, 32, 0, 0),
              (3, 128, 4, 32, 1, 3)]
    got = _make_layout_words(tmp_path, cases)
    assert got == [sw._layout_words(*c, 8) for c in cases]
    assert got[0] == 9240


@pytest.mark.parametrize("T,B,K,W,plan", [
    (16, 128, 4, 32, (1, 3, 1)),
    (33, 128, 16, 32, (1, 3, 1)),
    (4, 256, 4, 32, (1, 4, 1)),
    (3, 36, 8, 6, (1, 5, 1)),
])
def test_wave_scan_sweep_passes_the_f64_grid(monkeypatch, T, B, K, W, plan):
    """WaveScanSweep on float64 (meta) tensors passes kernel E's entry
    point the plan and TG of ``launch_plan(..., 8)`` (a grid of
    ceil(T / TG) CTAs); on float32 tensors of the same shape, kernel 3's
    float32 plan."""
    nb = 2
    meta = torch.device("meta")
    i32 = torch.int32

    def ops(dty):
        def e(*shape, dtype=dty):
            return torch.empty(shape, dtype=dtype, device=meta)
        return (e(T), e(nb, K, T, B), e(nb, K, T, B), e(nb, K, T, B),
                e(nb, T, B), e(nb, T, B, dtype=i32), e(nb, T, B),
                e(nb, T, B), e(nb, T, B), e(nb, T, B, dtype=i32),
                e(nb, T, B, dtype=i32), e(nb, T, B), e(T))
    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda kernel, *args: calls.append((kernel, args)))
    for dty in (F64, torch.float32):
        scan = sw.WaveScanSweep(*ops(dty), wave=W)
        c = torch.empty((nb, T, B), dtype=dty, device=meta)
        gs = torch.empty((nb, T, B, B), dtype=dty, device=meta)
        scan.step(1, c, gs, 1, bc=0)
    (k64, a64), (k32, a32) = calls
    assert k64 == "wave_scan_f64" and k32 == "wave_scan"
    assert a64[-10:] == (1, 0, 1, T, B, K, W, *plan)
    assert a32[-3:] == sw.launch_plan(T, B, K, W)
    assert a32[-3:] != plan
