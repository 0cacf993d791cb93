"""ctypes bindings to the port's host I/O library (``csrc/io_native.cpp``):
a multithreaded pread of a ``.bed`` byte range and a ``.phen`` parser, the
counterpart of the reference's C++ MPI-IO load (``src/bayes.cpp:867-900``,
``src/utilities.hpp:29-81``).

The library is built at first use with the host compiler
(``ops/_build.host_library``; no ``nvcc``).  ``read_bed`` and ``read_phen``
take it by default; when it cannot be built or loaded they raise, and do
not fall back to their NumPy routes.  Each call is counted
(:func:`call_counts`), so a run can show that its reads went through it.
"""

from __future__ import annotations

import ctypes

import numpy as np

# Calls since the last reset_call_counts(): preads, the bytes they read,
# .phen parses, and the parses sent back to the NumPy route (a line the
# parser does not read as that route does, or more lines than expected).
_CALLS = {"reads": 0, "bytes_read": 0, "parses": 0, "parses_deferred": 0}


def call_counts() -> dict:
    return dict(_CALLS)


def reset_call_counts() -> None:
    for k in _CALLS:
        _CALLS[k] = 0


def _library() -> ctypes.CDLL:
    # Imported here: ops/_build imports torch, which the readers' callers
    # (the simulator's worker processes among them) need not load.
    from gmrm_tpu_torch.ops import _build
    return _build.host_library()


def have_native() -> bool:
    """Whether the library builds and loads here."""
    try:
        _library()
    except RuntimeError:
        return False
    return True


def native_read_block(path: str, offset: int, nbytes: int,
                      n_threads: int = 0) -> np.ndarray:
    """Parallel pread of [offset, offset+nbytes) into a fresh uint8 array
    (``n_threads`` 0: the library picks, at most 16, at least 8 MiB a
    thread).  Raises IOError when fewer bytes come back."""
    lib = _library()
    buf = np.empty(nbytes, dtype=np.uint8)
    got = lib.gmrm_read_block(
        path.encode(), offset, nbytes,
        buf.ctypes.data_as(ctypes.c_void_p), int(n_threads),
    )
    _CALLS["reads"] += 1
    if got != nbytes:
        raise IOError(f"native read of {path} returned {got}, expected {nbytes}")
    _CALLS["bytes_read"] += nbytes
    return buf


def native_parse_phen(path: str, n_max: int) -> tuple[np.ndarray, np.ndarray]:
    """Parse a PLINK .phen (FID IID value|NA) into (values, isna) arrays.
    Raises IOError when the file cannot be read (-1), has more than
    ``n_max`` individuals (-2) or a line that is not plain (-3); read_phen
    then parses it on its NumPy route."""
    lib = _library()
    vals = np.empty(n_max, dtype=np.float64)
    isna = np.empty(n_max, dtype=np.uint8)
    n = lib.gmrm_parse_phen(
        path.encode(), n_max,
        vals.ctypes.data_as(ctypes.c_void_p),
        isna.ctypes.data_as(ctypes.c_void_p),
    )
    _CALLS["parses"] += 1
    if n < 0:
        _CALLS["parses_deferred"] += 1
        raise IOError(f"native phen parse of {path} failed ({n})")
    return vals[:n].copy(), isna[:n].astype(bool)
