"""The launch plans at any number of mixture components (K > 16), the
shared memory they count against each kernel's own layout, the up-front
refusal of shapes no kernel of a plan takes, and the command line at 17
and 65 components, on the CPU.

- Every scan planner has a plan at K = 17, 33 and 65 and counts the
  shared memory the kernel lays out: ``scan_kernel._layout_words`` against
  csrc/serial_scan.cu's ``scan_words`` (its ``make_layout`` and, past 16
  components, the draw's scratch) and ``scan_kernel_wave._layout_words``
  against csrc/wave_scan.cu's ``make_layout``, each compiled here with the
  host compiler from the source's own lines (as
  tests/test_torch_wave_plan_f64.py does), in float and double; where the
  tables do not fit beside the rest, the plan leaves them in global
  memory.  The scan CTAs of kernels 7/8 and 9 (csrc/sweep_blocks.cu,
  csrc/block_sweep.cu ``make_layout``, compiled likewise) cannot stage the
  tables of 65 components at the anchor's T and B, so their planners
  (which need the card) leave them in global memory.
- ``config.check_kernels`` raises ``SliceNotCovered`` for a shape that no
  kernel of the resolved plan takes before any data is read, and passes
  every plan at 17, 33 and 65 components.
- ``python -m gmrm_tpu_torch`` trains with a 17- and a 65-column .grm.
"""

import builtins
import re
import subprocess

import numpy as np
import pytest
import torch

from gmrm_tpu_torch import cli
from gmrm_tpu_torch import runner as trunner
from gmrm_tpu_torch.config import Options, SliceNotCovered, check_kernels
from gmrm_tpu_torch.io.sim import simulate
from gmrm_tpu_torch.io.writers import read_history
from gmrm_tpu_torch.ops import _build
from gmrm_tpu_torch.ops import scan_kernel as sk
from gmrm_tpu_torch.ops import scan_kernel_wave as sw

torch.set_num_threads(2)

KS = (17, 33, 65)
SMEM = 232448


def _compile_and_run(tmp_path, name, defs, region, calls):
    """A host program of the constants ``defs`` and the source ``region``
    (its __host__ __device__ marks defined away) that prints each of
    ``calls``, one integer a line."""
    body = "\n".join(f'  std::printf("%lld\\n", (long long)({c}));'
                     for c in calls)
    prog = ("#include <cstddef>\n#include <cstdio>\n#define __host__\n"
            "#define __device__\n" + "\n".join(defs) + "\n" + region
            + f"\nint main() {{\n{body}\n  return 0;\n}}\n")
    src = tmp_path / f"{name}.cpp"
    src.write_text(prog)
    exe = tmp_path / name
    subprocess.run([*_build._host_cxx(), "-std=c++17", "-o", str(exe),
                    str(src)], check=True, capture_output=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True).stdout
    return [int(x) for x in out.split()]


def _source(name, first, last, consts):
    src = (_build.CSRC / name).read_text()
    head = (_build.CSRC / "sweep_math.cuh").read_text()
    defs = [re.search(r"constexpr int GMRM_MAX_K = \d+;", head).group(0)]
    defs += [re.search(c, src).group(0) for c in consts]
    return defs, src[src.index(first):src.index(last)]


def _plans():
    """(T, B, K) cases: the anchor's T and B, one trait at B = 512, and
    the one-CTA float32 route at B = 640."""
    return [(4, 128, K) for K in KS] + [(1, 512, K) for K in KS] + [
        (2, 640, 17), (3, 640, 33)]


def test_serial_scan_words_match_the_kernel(tmp_path):
    """Every plan of kernels 6 and C at any K (TG traits a CTA), and the
    same shapes at every mode, against the kernel's scan_words in float
    and double; past 16 components one trait a pass (TG = 1 in a grid),
    and K = 65 leaves the tables of float64 in global memory at B = 128."""
    defs, region = _source(
        "serial_scan.cu", "__host__ __device__ inline int al4",
        "__device__ __forceinline__ uint32_t smem_u32",
        [r"constexpr int MAX_T = \d+;", r"constexpr int MAX_NG = \d+;",
         r"constexpr int NSTATE = \d+;", r"constexpr int REC_SLOTS = \d+;"])
    cases = []
    for T, B, K in _plans():
        for es, plan in ((4, sk.launch_plan(T, B, K)),
                         (8, sk.f64_plan(T, B, K) if B <= 512 else None)):
            if plan is None:
                continue
            mode, GR, NG, TG = plan
            assert sk.lanes_of(K) == 32
            assert TG == (T if es == 4 and B > sk.F64_MAX_B else 1)
            assert es * sk._layout_words(TG, B, K, mode, GR, NG, es) <= SMEM
            for m in (0, 1, 2):
                cases.append((TG, B, K, m, GR, NG, es))
    assert sk.f64_plan(4, 128, 65)[0] == 1
    assert 8 * sk._layout_words(1, 128, 65, 2, 8, 2, 8) > SMEM
    calls = [f"scan_words<{'double' if es == 8 else 'float'}>"
             f"({T}, {B}, {K}, {m}, {GR}, {NG})"
             for T, B, K, m, GR, NG, es in cases]
    got = _compile_and_run(tmp_path, "serial", defs, region, calls)
    assert got == [sk._layout_words(*c) for c in cases]


def test_wave_scan_words_match_the_kernel(tmp_path):
    """Every plan of kernels 3 and E at any K against the kernel's
    make_layout, float and double; at K = 65 and the anchor's T and B
    kernel 3 leaves the tables in global memory (400 KB) and stages the
    Gram rows of every wave in their place."""
    defs, region = _source(
        "wave_scan.cu", "__host__ __device__ constexpr int al4",
        "__device__ __forceinline__ unsigned long long global_ns",
        [r"constexpr int NSTATE = \d+;"])
    cases = []
    for T, B, K in _plans():
        for es in (4, 8):
            tab, gsw, TG = sw.launch_plan(T, B, K, 32, es)
            assert es * sw._layout_words(TG, B, K, 32, tab, gsw, es) <= SMEM
            cases += [(TG, B, K, 32, tab, gsw, es),
                      (TG, B, K, 32, 0, 0, es)]
    assert sw.launch_plan(4, 128, 65, 32) == (0, 3, 4)
    calls = [f"make_layout<{'double' if es == 8 else 'float'}>"
             f"({T}, {B}, {K}, {W}, {tab}, {gsw}).words"
             for T, B, K, W, tab, gsw, es in cases]
    got = _compile_and_run(tmp_path, "wave", defs, region, calls)
    assert got == [sw._layout_words(*c) for c in cases]


@pytest.mark.parametrize("name", ["sweep_blocks", "block_sweep"])
def test_sweep_kernels_leave_large_tables_in_global_memory(tmp_path, name):
    """The scan CTA of kernels 7/8 (and of kernel 9) at T=4, B=128, W=32:
    its tables staged fit at K = 17 and 33 and do not at K = 65, beside
    nothing else staged; the layout grows by the tables' 3 K T B floats."""
    if name == "sweep_blocks":
        defs, region = _source(
            "sweep_blocks.cu", "// Shared memory offsets in bytes.",
            "// Scratch offsets in 4-byte words",
            [r"constexpr int THREADS = \d+;",
             r"constexpr int MAX_ROW_PARTS = \d+;",
             r"enum \{ EPS_SMEM = 1[^}]*\};"])
        tab = 8

        def call(K, flags):
            return f"make_layout(4, 128, 32, {K}, 1, 20, {flags})"
    else:
        defs, region = _source(
            "block_sweep.cu", "__host__ __device__ inline int gs_wave_offset",
            "// A shard's slot of the scratch",
            [r"constexpr int BS_THREADS = \d+;",
             r"enum \{ GS_SMEM = 1, TAB_SMEM = 2 \};"])
        tab = 2

        def call(K, flags):
            return f"make_layout(4, 128, 32, {K}, 1, 20, 1, {flags}, 1)"
    keys = [(K, f) for K in KS for f in (0, tab)]
    got = _compile_and_run(tmp_path, name, defs, region,
                           [f"{call(K, f)}.{x}" for K, f in keys
                            for x in ("total", "s_gs")])
    total = dict(zip(keys, got[0::2]))
    s_gs = dict(zip(keys, got[1::2]))     # the scan CTA's layout past them
    for K in KS:
        assert s_gs[(K, tab)] - s_gs[(K, 0)] == 3 * K * 4 * 128 * 4
    assert total[(17, tab)] <= SMEM and total[(33, tab)] <= SMEM
    assert total[(65, tab)] > SMEM


def _opt(sim, **kw):
    base = dict(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                group_index_file=sim.gri, group_mixture_file=sim.grm,
                iterations=3, seed=5, out_dir="", block_size=32)
    base.update(kw)
    return Options(**base)


@pytest.fixture(scope="module")
def sim17(tmp_path_factory):
    return simulate(str(tmp_path_factory.mktemp("anyk")), n=200, m=96,
                    n_traits=2, n_causal=24, h2=0.5, n_groups=2,
                    na_rate=0.0, seed=17,
                    mixtures=np.concatenate([[0.0], np.logspace(-4, -1.3,
                                                                16)]))


@pytest.mark.parametrize("case", [
    dict(dtype="float64", block_size=1024, wave_size=1),
    dict(dtype="float32", block_size=1024, wave_size=1, n_traits=8),
    dict(dtype="float64", block_size=1024, wave_size=1, K=65),
], ids=["f64-B1024", "f32-T8-B1024", "f64-B1024-K65"])
def test_refused_before_any_data_is_read(sim17, tmp_path, monkeypatch,
                                         case):
    """A CUDA run that no kernel of its plan takes (kernel C at B > 512;
    kernel 6 where 8 traits need a grid of trait groups at B = 1024)
    raises SliceNotCovered with the planner's message from resolve_plan,
    before the .bed or a .phen is opened and before load_data: the
    training entry point on a CUDA device (faked here: no kernel runs)."""
    case = dict(case)
    n_traits, K = case.pop("n_traits", 2), case.pop("K", 17)
    phens = [sim17.phens[i % 2] for i in range(n_traits)]
    grm = tmp_path / "k.grm"
    grm.write_text(" ".join(f"{v:.10g}" for v in np.concatenate(
        [[0.0], np.logspace(-4, -1.3, K - 1)])) + "\n")
    opt = _opt(sim17, phen_files=phens, group_mixture_file=str(grm), **case)
    opened = []
    real_open = builtins.open

    def spy(path, *a, **kw):
        opened.append(str(path))
        return real_open(path, *a, **kw)

    def no_load(*a, **kw):
        raise AssertionError("load_data ran")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(trunner, "load_data", no_load)
    monkeypatch.setattr(builtins, "open", spy)
    with pytest.raises(SliceNotCovered, match="no CUDA kernel"):
        trunner.run_training(opt, device="cuda", verbose=False)
    monkeypatch.setattr(builtins, "open", real_open)
    data_files = {sim17.bed, *sim17.phens}
    assert not data_files & set(opened)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("plan", [
    ("float32", 1, 1), ("float32", 32, 1), ("float64", 1, 1),
    ("float64", 32, 1), ("float32", 1, 2), ("float64", 32, 2)],
    ids=["f32-W1", "f32-W32", "f64-W1", "f64-W32", "f32-W1-S2",
         "f64-W32-S2"])
def test_every_plan_at_any_k_passes_the_check(sim17, K, plan):
    """check_kernels passes the anchor's T=4 and B=128 at every dtype,
    wave and shard count (the sharded plan checks the same scans)."""
    dtype, wave, _ = plan
    opt = _opt(sim17, dtype=dtype, wave_size=wave, block_size=128,
               phen_files=sim17.phens * 2)
    opt.cva = np.zeros((2, K))
    check_kernels(opt, "cuda")
    opt.block_size = 1024
    if wave == 1 and dtype == "float64":
        with pytest.raises(SliceNotCovered):
            check_kernels(opt, "cuda")
    check_kernels(opt, "cpu")


@pytest.mark.parametrize("K", [17, 65])
def test_cli_trains_at_k(sim17, tmp_path, K):
    """python -m gmrm_tpu_torch on the CPU with a K-column .grm: exit 0,
    every component drawn in 0 .. K - 1, some past the sixteenth."""
    grm = tmp_path / "k.grm"
    mix = np.concatenate([[0.0], np.logspace(-4, -1.3, K - 1)])
    grm.write_text("\n".join(" ".join(f"{v:.10g}" for v in mix)
                             for _ in range(2)) + "\n")
    out = tmp_path / "out"
    rc = cli.main(["--bed-file", sim17.bed, "--dim-file", sim17.dim,
                   "--phen-files", ",".join(sim17.phens),
                   "--group-index-file", sim17.gri,
                   "--group-mixture-file", str(grm), "--iterations", "4",
                   "--seed", "5", "--out-dir", str(out),
                   "--block-size", "32", "--verbosity", "-1"],
                  device=torch.device("cpu"))
    assert rc == 0
    cpn = np.concatenate([read_history(str(out / p.split("/")[-1][:-5])
                                       + ".cpn", "i4")[1]
                          for p in sim17.phens])
    assert cpn.shape[0] == 8 and cpn.min() >= 0 and cpn.max() < K
    assert cpn.max() >= 16
