"""The port's host I/O library (gmrm_tpu_torch/io/native.py, csrc/
io_native.cpp) against its own NumPy routes and the JAX package, on the CPU.

- the build: with no ``nvcc``, the library builds at first use into
  ``gmrm_tpu_torch/_build/`` and a second call reuses the file; two
  processes building into one directory at once both load a whole library;
  a failed build raises from ``read_bed`` and ``read_phen`` (no fallback);
- the bed: on a seeded panel of N=10,001 the native ``read_bed`` is
  byte-equal to its NumPy route and to ``gmrm_tpu.io.bed.read_bed`` for the
  whole panel (over 8 MiB: several threads), slices, one and zero markers,
  and the pread at ``n_threads=4``; the IOErrors are the JAX package's;
- the phen: well-formed files give bit-equal values, mask and epsilon0 by
  the port's two routes and the JAX package's two routes, parsed natively
  (no file deferred); on the defect panel (inputs the JAX package's native
  parser reads otherwise than its NumPy route) the port's native route
  gives its NumPy route's values or IOError, which are the JAX package's
  NumPy route's;
- the slice: ``load_data``, ``load_data_process``, a short chain and
  predict give the same arrays and bytes by either route.
"""

import ast
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gmrm_tpu.io.bed as jbed
import gmrm_tpu.io.phen as jphen
from gmrm_tpu_torch import predict as tpredict
from gmrm_tpu_torch import runner as trunner
from gmrm_tpu_torch.config import Options, resolve_plan
from gmrm_tpu_torch.io import native
from gmrm_tpu_torch.io.bed import BED_MAGIC, read_bed
from gmrm_tpu_torch.io.phen import read_phen
from gmrm_tpu_torch.ops import _build
from gmrm_tpu_torch.parallel import runner as prunner

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BED, MT_BED = 10_001, 3_600          # mbytes 2,501: 9.0 MB of markers


def _no_nvcc_path():
    return os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc")))


# ---------------------------------------------------------------- build

def test_builds_at_first_use_without_nvcc(monkeypatch):
    """No nvcc on PATH and ``_nvcc`` refusing: the library builds into
    gmrm_tpu_torch/_build/ (or is there), loads, and a second call returns
    the same file untouched."""
    monkeypatch.setenv("PATH", _no_nvcc_path())

    def no_nvcc():
        raise AssertionError("the host library must not look for nvcc")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    lib = _build.host_build()
    assert lib.parent == Path(REPO) / "gmrm_tpu_torch" / "_build"
    assert lib.name.startswith("libgmrm_io_") and lib.suffix == ".so"
    stamp = lib.stat().st_mtime_ns
    assert _build.host_build() == lib
    assert lib.stat().st_mtime_ns == stamp
    assert native.have_native()
    # The kernels' source hash does not see the host source.
    assert _build.HOST_SOURCE not in _build._sources()


BUILD_AND_READ = """
import sys
from pathlib import Path
import numpy as np
from gmrm_tpu_torch.ops import _build
from gmrm_tpu_torch.io.native import native_read_block
_build.BUILD_DIR = Path(sys.argv[1])
got = native_read_block(sys.argv[2], 5, 1000)
want = np.fromfile(sys.argv[2], dtype=np.uint8)[5:1005]
assert (got == want).all()
print("OK", _build.host_build().name)
"""


def test_two_processes_build_at_once(tmp_path):
    """Two processes build into one empty directory at once: each loads a
    whole library and reads with it; one file is left, no work directory."""
    blob = tmp_path / "blob.bin"
    np.random.default_rng(5).integers(0, 256, 4096, np.uint8).tofile(blob)
    out = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=REPO, PATH=_no_nvcc_path(),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_READ,
                               str(out), str(blob)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se
        assert so.startswith("OK libgmrm_io_")
    assert len({so for so, _ in outs}) == 1
    assert [p.name for p in out.iterdir()] == [outs[0][0].split()[1]]


@pytest.fixture
def failing_build(tmp_path, monkeypatch):
    """The host compiler fails, into an empty build directory."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    _build.host_library.cache_clear()
    try:
        yield
    finally:
        _build.host_library.cache_clear()


def test_failed_build_raises_and_does_not_fall_back(failing_build,
                                                    sim_tiny):
    """A library that cannot be built stops the read: read_bed and
    read_phen raise, and do not take their NumPy routes."""
    assert not native.have_native()
    with pytest.raises(RuntimeError, match="host compiler failed"):
        read_bed(sim_tiny.bed, sim_tiny.n, sim_tiny.m)
    with pytest.raises(RuntimeError, match="host compiler failed"):
        read_phen(sim_tiny.phens[0], sim_tiny.n)
    # The plain versions need no library.
    read_bed(sim_tiny.bed, sim_tiny.n, sim_tiny.m, route="numpy")
    read_phen(sim_tiny.phens[0], sim_tiny.n, route="numpy")


# ------------------------------------------------------------------ bed

@pytest.fixture(scope="module")
def bed_panel(tmp_path_factory):
    """Magic + seeded bytes of N=10,001 individuals x 3,600 markers."""
    path = tmp_path_factory.mktemp("bed") / "panel.bed"
    mb = (N_BED + 3) // 4
    body = np.random.default_rng(171017).integers(0, 256, MT_BED * mb,
                                                  dtype=np.uint8)
    with open(path, "wb") as fh:
        fh.write(BED_MAGIC)
        body.tofile(fh)
    return str(path), body.reshape(MT_BED, mb)


@pytest.mark.parametrize("start,count", [
    (0, None),            # the whole panel, 9.0 MB: two threads
    (1234, None),         # a slice to the end
    (100, 3400),          # 8.5 MB inside the panel: two threads
    (77, 1),
    (5, 0),
    (MT_BED - 1, 1),
], ids=["whole", "to_end", "over_8MiB", "one", "zero", "last"])
def test_bed_native_equals_numpy_and_jax(bed_panel, start, count):
    path, body = bed_panel
    native.reset_call_counts()
    got = read_bed(path, N_BED, MT_BED, start, count)
    calls = native.call_counts()
    want_np = read_bed(path, N_BED, MT_BED, start, count, route="numpy")
    want_jax = jbed.read_bed(path, N_BED, MT_BED, start, count)
    stop = MT_BED if count is None else start + count
    assert got.dtype == np.uint8 and got.shape == want_jax.shape
    assert got.tobytes() == want_np.tobytes() == want_jax.tobytes()
    assert got.tobytes() == body[start:stop].tobytes()
    assert calls == {"reads": 1, "bytes_read": got.size, "parses": 0,
                     "parses_deferred": 0}
    assert native.call_counts() == calls      # the NumPy route counts none


def test_pread_threads_and_short_read(bed_panel):
    """n_threads=4 on 1 MiB, and a read past the end raises IOError."""
    path, body = bed_panel
    flat = body.reshape(-1)
    got = native.native_read_block(path, 3 + 4321, 1 << 20, n_threads=4)
    assert got.tobytes() == flat[4321:4321 + (1 << 20)].tobytes()
    got = native.native_read_block(path, 3, flat.size, n_threads=4)
    assert got.tobytes() == flat.tobytes()
    with pytest.raises(IOError, match="native read"):
        native.native_read_block(path, 3 + flat.size - 10, 20)
    with pytest.raises(IOError, match="native read"):
        native.native_read_block(path + ".missing", 0, 10)


@pytest.mark.parametrize("fault", ["magic", "small", "missing"])
def test_bed_errors_as_jax(bed_panel, tmp_path, fault):
    path, body = bed_panel
    bad = str(tmp_path / "bad.bed")
    if fault == "magic":
        with open(bad, "wb") as fh:
            fh.write(b"\x6c\x1b\x00")
            body[:10].tofile(fh)
        n, m = N_BED, 10
    elif fault == "small":
        with open(bad, "wb") as fh:
            fh.write(BED_MAGIC)
            body[:10].tofile(fh)
        n, m = N_BED, 11
    else:
        n, m = N_BED, 10
    errors = []
    for read in (functools.partial(read_bed, route="native"),
                 functools.partial(read_bed, route="numpy"), jbed.read_bed):
        with pytest.raises(IOError) as info:
            read(bad, n, m)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1] == errors[2]


# ----------------------------------------------------------------- phen

def _write(path, text):
    with open(path, "w", newline="") as fh:
        fh.write(text)
    return str(path)


def _seeded_reprs(n=1000):
    """17-digit reprs of seeded doubles over many magnitudes, NAs among
    them, as written lines."""
    rng = np.random.default_rng(171018)
    x = rng.standard_normal(n) * 10.0 ** rng.integers(-300, 150, n)
    x[rng.choice(n, 20, replace=False)] = np.nan
    return "".join(f"{i} {i} {'NA' if np.isnan(v) else repr(float(v))}\n"
                   for i, v in enumerate(x))


WELL_FORMED = {
    "mixed": "1 1 NA\n2 2 -1.25e2\n3 3 +3.5\n4 4 .5\n5 5 5.\n6 6 1E+3\n"
             "7 7 -0\n8 8 +0.0\n9 9 2.5e-3\n10 10 0.1\n",
    "extremes": "1 1 1e400\n2 2 1e-400\n3 3 -1e400\n4 4 4.9e-324\n"
                "5 5 2.2250738585072014e-308\n6 6 1.7976931348623157e308\n",
    "reprs": _seeded_reprs(),
    "crlf": "1 1 0.5\r\n2 2 NA\r\n3 3 -7.25\r\n",
    "tabs": "1\t1\t0.5\n2 \t 2\t\tNA\n\t3 3 \t-7.25\t\n",
    "extra_columns": "1 1 0.5 9 x\n2 2 NA NA\n3 3 -7.25 1e9 7 8\n",
    "blank_lines": "\n1 1 0.5\n   \n\t\n2 2 NA\n \t \n3 3 -7.25\n\n",
    "no_final_newline": "1 1 0.5\n2 2 NA\n3 3 -7.25",
}


def _fields(ph):
    return (ph.values.tobytes(), ph.mask.tobytes(), ph.epsilon0.tobytes(),
            ph.nas, ph.nonas)


@pytest.mark.filterwarnings("ignore:invalid value:RuntimeWarning")
@pytest.mark.parametrize("name", list(WELL_FORMED))
def test_phen_well_formed_bit_equal(tmp_path, name):
    path = _write(tmp_path / f"{name}.phen", WELL_FORMED[name])
    n = len(jphen.read_phen(path).values)
    native.reset_call_counts()
    got = read_phen(path, n)
    assert native.call_counts()["parses"] == 1
    assert native.call_counts()["parses_deferred"] == 0
    want = _fields(got)
    assert _fields(read_phen(path, n, route="numpy")) == want
    assert _fields(jphen.read_phen(path)) == want
    assert _fields(jphen.read_phen(path, n)) == want


def _outcome(read):
    """The fields a read gives, or the type and message of its IOError."""
    try:
        return _fields(read())
    except IOError as e:
        return type(e), str(e)


def _jax_numpy_route(path, n):
    """gmrm_tpu's NumPy route (read_phen without a count) with the count
    check read_phen makes given one."""
    ph = jphen.read_phen(path)
    if ph.n != n:
        raise IOError(f"N = {n} while phen file {path} has {ph.n} "
                      f"individuals!")
    return ph


# The JAX package's native parser reads the first five otherwise than its
# NumPy route (ROADMAP.md section 3); the rest are what float() takes or
# refuses beyond a plain decimal, a short line, and more lines than N.
DEFECTS = {
    "trailing_space": "1 1 \n2 2 0.5\n3 3 1.5\n",
    "trailing_tab": "1 1\t\n2 2 0.5\n3 3 1.5\n",
    "hex_float": "1 1 0x1p3\n2 2 0.5\n3 3 1.5\n",
    "no_break_space": "1\u00a01 0.5 7\n2 2 0.5\n3 3 1.5\n",
    "cr_line_ends": "1 1 0.5\r2 2 0.7\r3 3 1.0\r",
    "nul_after_value": "1 1 0.5\x00\n2 2 0.5\n3 3 1.5\n",
    "inf": "1 1 inf\n2 2 0.5\n3 3 1.5\n",
    "nan": "1 1 nan\n2 2 0.5\n3 3 1.5\n",
    "underscore": "1 1 1_0\n2 2 0.5\n3 3 1.5\n",
    "more_lines": "1 1 0.5\n2 2 0.6\n3 3 0.7\n4 4 0.8\n",
    "two_fields": "F1 I1\n2 2 0.5\n3 3 1.5\n",
    "suffix": "1 1 1.5x\n2 2 0.5\n3 3 1.5\n",
    "word": "1 1 abc\n2 2 0.5\n3 3 1.5\n",
}


@pytest.mark.filterwarnings("ignore:invalid value:RuntimeWarning")
@pytest.mark.parametrize("name", list(DEFECTS))
def test_phen_defect_panel_gives_the_numpy_answer(tmp_path, name):
    path = _write(tmp_path / f"{name}.phen", DEFECTS[name])
    native.reset_call_counts()
    got = _outcome(lambda: read_phen(path, 3))
    assert native.call_counts()["parses_deferred"] == 1
    assert got == _outcome(lambda: read_phen(path, 3, route="numpy"))
    assert got == _outcome(lambda: _jax_numpy_route(path, 3))


def test_phen_undecodable_bytes_as_numpy(tmp_path):
    """A byte >= 0x80 in an id: the native route defers, so the outcome is
    the NumPy route's under this environment's text encoding (a
    UnicodeDecodeError under UTF-8)."""
    path = str(tmp_path / "latin1.phen")
    Path(path).write_bytes(b"1\xe9 1 0.5\n2 2 0.5\n3 3 1.5\n")

    def outcome(route):
        try:
            return _fields(read_phen(path, 3, route=route))
        except ValueError as e:       # UnicodeDecodeError
            return type(e), str(e)

    native.reset_call_counts()
    assert outcome("native") == outcome("numpy")
    assert native.call_counts()["parses_deferred"] == 1


# ---------------------------------------------------------------- slice

def _take_route(monkeypatch, route):
    """Every load path of the port (training, sharded training, predict)
    on ``route``."""
    for mod in (trunner, prunner, tpredict):
        monkeypatch.setattr(mod, "read_bed",
                            functools.partial(read_bed, route=route))
        monkeypatch.setattr(mod, "read_phen",
                            functools.partial(read_phen, route=route))


def _opt(sim, out_dir, wave, **kw):
    opt = Options(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                  group_index_file=sim.gri, group_mixture_file=sim.grm,
                  iterations=3, seed=42, out_dir=out_dir, block_size=8,
                  wave_size=wave, output_thin_rate=1, **kw)
    opt.load_group_mixtures()
    return opt


def _arrays(data):
    out = {}
    for k, v in vars(data).items():
        if k == "phens":
            out[k] = [_fields(ph) for ph in v]
        elif isinstance(v, list):
            out[k] = [None if x is None else np.asarray(x).tobytes()
                      for x in v]
        elif isinstance(v, np.ndarray):
            out[k] = (v.dtype, v.shape, v.tobytes())
        elif hasattr(v, "__dict__"):
            out[k] = _arrays(v)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("wave", [8, 1])
def test_load_paths_equal_by_either_route(sim_small, wave, monkeypatch,
                                          tmp_path):
    """load_data and load_data_process (S=2, interleaved at W>1) give the
    same arrays by either route; only the native run counts calls."""
    opt = _opt(sim_small, str(tmp_path), wave)
    resolve_plan(opt, "cpu", sim_small.m)
    by_route = {}
    for route in ("native", "numpy"):
        _take_route(monkeypatch, route)
        native.reset_call_counts()
        by_route[route] = (
            _arrays(trunner.load_data(opt)),
            _arrays(prunner.load_data_process(opt, 2, interleave=wave > 1)))
        by_route[route + " calls"] = native.call_counts()
    t = len(sim_small.phens)
    assert by_route["native calls"] == {
        "reads": 3, "bytes_read": 2 * sim_small.m * ((sim_small.n + 3) // 4),
        "parses": 2 * t, "parses_deferred": 0}
    assert set(by_route["numpy calls"].values()) == {0}
    assert by_route["native"] == by_route["numpy"]


def test_chain_and_predict_bytes_equal_by_either_route(sim_tiny, tmp_path,
                                                       monkeypatch):
    """Three iterations on sim_tiny and predict on their .bet files write
    the same .csv/.bet/.cpn/.mlma bytes by either route."""
    files, calls = {}, {}
    for route in ("native", "numpy"):
        _take_route(monkeypatch, route)
        native.reset_call_counts()
        out = str(tmp_path / route)
        trunner.run_training(_opt(sim_tiny, out, 8), device="cpu",
                             verbose=False)
        popt = _opt(sim_tiny, out, None, predict=True, bim_file=sim_tiny.bim,
                    ref_bim_file=sim_tiny.bim)
        tpredict.run_predict(popt, device="cpu", verbose=False)
        calls[route] = native.call_counts()
        files[route] = {
            name: Path(out, name).read_bytes() for name in sorted(
                os.listdir(out)) if name.endswith((".csv", ".bet", ".cpn",
                                                   ".mlma"))}
    t = len(sim_tiny.phens)
    assert calls["native"]["reads"] == 2 and calls["native"]["parses"] == 2 * t
    assert set(calls["numpy"].values()) == {0}
    assert len(files["native"]) == 4 * t
    assert files["native"] == files["numpy"]


def test_native_module_imports_nothing_of_gmrm_tpu():
    """io/native.py imports nothing of gmrm_tpu and names no path under
    _native/ (the JAX package's library); it loads ops/_build's build."""
    src = Path(REPO, "gmrm_tpu_torch", "io", "native.py").read_text()
    imported = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module)
    assert {m.split(".")[0] for m in imported} <= {
        "__future__", "ctypes", "numpy", "gmrm_tpu_torch"}
    assert "_native/" not in src and "libgmrm_io.so" not in src
