"""Build, load and launch the CUDA kernels of ``gmrm_tpu_torch/csrc``.

The sources are compiled at first use with ``nvcc``, one process per
``.cu`` file, all started together, and linked into one shared library
with a plain C interface, keyed by a hash of the sources, in the
git-ignored directory ``gmrm_tpu_torch/_build``, and loaded with
``ctypes``.  Nothing is built or imported at module import: the CPU tests
import every module on a machine without ``nvcc``.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0, since a
refused launch never runs and a later synchronize does not report it.
No ``--use_fast_math``: ``expf``/``logf``/``sqrtf`` stay IEEE-accurate next
to the plain PyTorch versions.

The host I/O library (``csrc/io_native.cpp``: the ``.bed`` pread and the
``.phen`` parser of ``gmrm_tpu_torch.io.native``) is built apart from the
kernels, with the host compiler and no ``nvcc`` (:func:`host_build`,
:func:`host_library`), so it builds wherever the port runs, the CPU tests
included.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shlex
import shutil
import subprocess
import tempfile
import time
import weakref
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

HOST_SOURCE = CSRC / "io_native.cpp"
# No -march=native: a _build/ copied to another host must still load there.
HOST_CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argument types (pointers and the stream as c_void_p, so
# ctypes never cuts a 64-bit address to 32 bits).
SIGNATURES = {
    # bed, na, out, nblocks, B, mb, nt, stream
    "gmrm_gram_cache": [_P, _P, _P, _I, _I, _I, _I, _P],
    # bed, rows, eps, mave, msig, c, scratch, T, B, mb, S, stamps (or
    # null), stream
    "gmrm_block_cdot": [_P] * 7 + [_I] * 4 + [_P, _P],
    # c, nm1, lc, rd, sqb, gs, beta_old, comp_old, acum_old, u, z, live,
    # zerob, msig, i2se, dbeta, d, beta_new, comp_new, acum_new, stamps (or
    # null), b, bc, bg, T, B, K, W, tab, gsw, TG (traits a CTA), stream
    "gmrm_wave_scan": [_P] * 21 + [_I] * 10 + [_P],
    # bed, rows, d, mave, na, eps, T, B, mb, S, stamps (or null), stream
    "gmrm_eps_update": [_P] * 6 + [_I] * 4 + [_P, _P],
    # bed, rows, rows_next, d, mave, mave_next, msig_next, na, eps, c_next,
    # scratch, T, B, mb, S, stamps (or null), stream
    "gmrm_update_cdot": [_P] * 11 + [_I] * 4 + [_P, _P],
    # bed, rows, na, mave, msig, gs, stamps (or null), nb, T, B, mb, nt,
    # panels, stages, grid, stream
    "gmrm_block_gram": [_P] * 7 + [_I] * 8 + [_P],
    # c, nm1, lc, rd, sqb, gs, beta_old, comp_old, acum_old, u, z, live,
    # zerob, msig, i2se, dbeta, d, beta_new, comp_new, acum_new, stamps (or
    # null), b, bc, bg, T, B, K, mode, GR, NG, TG (traits a CTA), stream
    "gmrm_serial_scan": [_P] * 21 + [_I] * 10 + [_P],
    # bed, blkidx, win, gram, eps, na, mave, msig, beta_old, comp_old,
    # acum_old, grp, u, z, sigmag, lc, rd, sqb, i2se, nonas, beta_new,
    # comp_new, acum_new, scratch, stamps (or null), nblocks, T, B, mb, nt,
    # K, W, G, m_local, t0, TS (traits t0 .. t0 + T - 1 of a run of TS),
    # stream (a cooperative launch inside the entry point)
    "gmrm_sweep_blocks": [_P] * 25 + [_I] * 11 + [_P],
    # T, B, mb, nt, K, W, out (8 ints): no launch, the grid, the shared
    # memory residency, the scratch and the column passes' design the sweep
    # kernel will use
    "gmrm_sweep_blocks_plan": [_I] * 6 + [_P],
    # table (host array of per-shard operand records), s0, ns, step, mode,
    # eps, na, out, sigmag, lc, rd, sqb, i2se, nonas, scratch, stamps (or
    # null), T, B, mb, nt, K, W, G, want, t0, TS (traits t0 .. t0 + T - 1
    # of a run of TS), stream (a cooperative launch inside the entry point)
    "gmrm_block_sweep": [_P] + [_I] * 4 + [_P] * 11 + [_I] * 10 + [_P],
    # T, B, mb, nt, K, W, want, out (8 ints): no launch, the shards a launch
    # takes, the columns, grid, shared memory and scratch the sharded
    # block-step kernel will use at these shapes
    "gmrm_block_sweep_plan": [_I] * 7 + [_P],
    # bed, na, y, keep (scratch), out, M, L, stream
    "gmrm_predict_sums": [_P] * 5 + [_I] * 2 + [_P],
    # L: no launch, the warps the predict kernel gives a group of rows
    "gmrm_predict_sums_team": [_I],
    # gmrm_predict_sums' arguments, then stamps, stream: the stamped
    # launch, for measurement (not counted)
    "gmrm_predict_sums_probe": [_P] * 5 + [_I] * 2 + [_P, _P],
    # The float64 kernels of the exact serial path (A-D; E below).
    # bed, rows, na (float32), mave, msig, gs, stamps (or null), nb, T, B,
    # mb, nt, panels, stages, grid, stream
    "gmrm_block_gram_f64": [_P] * 7 + [_I] * 8 + [_P],
    # Kernel B: the float64 entry points of kernels 2, 4 and the fused
    # pass, with the float32 ones' arguments.
    "gmrm_block_cdot_f64": [_P] * 7 + [_I] * 4 + [_P, _P],
    "gmrm_eps_update_f64": [_P] * 6 + [_I] * 4 + [_P, _P],
    "gmrm_update_cdot_f64": [_P] * 11 + [_I] * 4 + [_P, _P],
    # Kernel C: kernel 6's template at double (csrc/serial_scan.cu), with
    # gmrm_serial_scan's arguments and TG, the traits of a CTA, after NG.
    "gmrm_serial_scan_f64": [_P] * 21 + [_I] * 10 + [_P],
    # Kernel E: kernel 3's template at double (csrc/wave_scan.cu), the
    # float64 wave scan of a --dtype float64 --wave-size W run, with
    # gmrm_wave_scan's arguments.
    "gmrm_wave_scan_f64": [_P] * 21 + [_I] * 10 + [_P],
    # x, out (n, 4), n, stream: kernel C's float64 reciprocal and exp
    # beside the IEEE division and the library's exp, for chip_smoke.py's
    # check (not counted)
    "gmrm_math_check": [_P, _P, _I, _P],
    # bed, na, y, keep (scratch), out, M, L, stream
    "gmrm_predict_sums_f64": [_P] * 5 + [_I] * 2 + [_P],
}

# The entry point suffix of each dtype a templated kernel takes (the value
# type of its csrc template): the passes (B at float64) and the wave scan
# (E at float64).
SUFFIX = {torch.float32: "", torch.float64: "_f64"}

# Launches per kernel since the last reset_launch_counts().  A wrapper
# adds one where it launches its kernel and nowhere else, and the replay
# of a CUDA graph adds the launches captured in it, so a run can show
# that its main path went through the kernels.  "sweep_blocks_mma"
# counts the launches of kernels 7/8 whose plan ran the column passes on
# the tensor cores (also counted under "sweep_blocks"), "block_sweep_mma"
# those of kernel 9 (also counted under "block_sweep").
_LAUNCHES = {"gram_cache": 0, "block_cdot": 0, "wave_scan": 0,
             "eps_update": 0, "block_gram": 0, "serial_scan": 0,
             "sweep_blocks": 0, "block_sweep": 0, "update_cdot": 0,
             "predict_sums": 0, "block_gram_f64": 0, "block_cdot_f64": 0,
             "eps_update_f64": 0, "update_cdot_f64": 0,
             "serial_scan_f64": 0, "predict_sums_f64": 0,
             "wave_scan_f64": 0, "sweep_blocks_mma": 0,
             "block_sweep_mma": 0}


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def count_launch(name: str, n: int = 1) -> None:
    """Count ``n`` launches under ``name``: a design that a launch's plan
    chose, beside its kernel's own count, or the launches of a kernel that
    a CUDA graph replays."""
    _LAUNCHES[name] += n


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of gmrm_tpu_torch "
                       "are built from source at first use")


def _run_all(cmds):
    """Run the commands in parallel; returns [(cmd, returncode, output)]."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [(cmd, p.communicate()[0]) for cmd, p in procs]
    return [(cmd, p.returncode, out)
            for (cmd, out), (_, p) in zip(outs, procs)]


def build() -> Path:
    """Compile csrc/*.cu into BUILD_DIR (once per source hash)."""
    lib = BUILD_DIR / f"libgmrm_kernels_{source_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    nvcc = _nvcc()
    objs = [work / f"{p.stem}.o" for p in _sources() if p.suffix == ".cu"]
    t0 = time.perf_counter()
    runs = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
                      str(o), str(CSRC / f"{o.stem}.cu")] for o in objs])
    if all(rc == 0 for _, rc, _ in runs):
        runs += _run_all([[nvcc, "-shared", "-o", str(work / "lib.so"),
                           *map(str, objs)]])
    (BUILD_DIR / "build.log").write_text(
        "".join(f"$ {' '.join(cmd)}\n{out}" for cmd, _, out in runs)
        + f"# {time.perf_counter() - t0:.1f} s\n")
    failed = [(cmd, rc, out) for cmd, rc, out in runs if rc != 0]
    if failed:
        shutil.rmtree(work)
        cmd, rc, out = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n"
                           f"{out[-4000:]}")
    os.replace(work / "lib.so", lib)
    shutil.rmtree(work)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gmrm_error_string.argtypes = [ctypes.c_int]
    lib.gmrm_error_string.restype = ctypes.c_char_p
    return lib


def _host_cxx() -> list:
    cxx = os.environ.get("CXX")
    if cxx:
        return shlex.split(cxx)
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return [found]
    raise RuntimeError("no host C++ compiler (CXX, c++ or g++): the I/O "
                       "library of gmrm_tpu_torch is built from source at "
                       "first use")


def host_build() -> Path:
    """Compile csrc/io_native.cpp with the host compiler into BUILD_DIR,
    once per hash of the source and flags.  Raises RuntimeError, with the
    compiler's output, when it cannot build."""
    h = hashlib.sha256(" ".join(HOST_CXX_FLAGS).encode())
    h.update(HOST_SOURCE.read_bytes())
    lib = BUILD_DIR / f"libgmrm_io_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Concurrent builds each compile in their own directory; the rename
    # is atomic, so no process loads a half-written library.
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        cmd = [*_host_cxx(), *HOST_CXX_FLAGS, "-o", str(work / "lib.so"),
               str(HOST_SOURCE)]
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            raise RuntimeError(f"host compiler failed: {' '.join(cmd)}: "
                               f"{e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"host compiler failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout[-4000:]}")
        os.replace(work / "lib.so", lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def host_library() -> ctypes.CDLL:
    """The host I/O library, built at first use; raises RuntimeError when
    it cannot be built or loaded (the readers do not fall back)."""
    path = host_build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    # Offsets and sizes as long long, buffers as c_void_p: a panel over
    # 2 GiB must not wrap, nor an address be cut to 32 bits.
    lib.gmrm_read_block.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                    ctypes.c_longlong, _P, _I]
    lib.gmrm_read_block.restype = ctypes.c_longlong
    lib.gmrm_parse_phen.argtypes = [ctypes.c_char_p, ctypes.c_longlong, _P,
                                    _P]
    lib.gmrm_parse_phen.restype = ctypes.c_longlong
    return lib


def error_string(err: int) -> str:
    return library().gmrm_error_string(err).decode()


def launch(kernel: str, *args) -> None:
    """Call ``gmrm_<kernel>`` on the current stream, count the launch and
    raise on a launch error.  Tensors pass as their data pointers."""
    lib = library()
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, f"gmrm_{kernel}")(*conv, stream)
    if err != 0:
        raise RuntimeError(f"gmrm_{kernel} launch failed: "
                           f"{error_string(err)}")
    _LAUNCHES[kernel] += 1


def check(x: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Device, dtype, shape and contiguity checks of a kernel operand."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_once(seen: dict, x: torch.Tensor, name: str, dtype, shape,
               device) -> int:
    """``check`` unless ``x`` is the tensor last checked under ``name``
    (``seen`` holds it weakly); returns its address.  For an operand that a
    sweep passes again at every block step."""
    ref = seen.get(name)
    if ref is None or ref() is not x:
        check(x, name, dtype, shape, device)
        seen[name] = weakref.ref(x)
    return x.data_ptr()
