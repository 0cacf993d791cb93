"""PLINK ``.phen`` phenotype I/O and preprocessing (the port's copy of
gmrm_tpu/io/phen.py).

Format (reference parser at ``src/phenotype.cpp:587-673``): one line per
individual, whitespace-separated ``FID IID value``; value may be the literal
``NA``.  Preprocessing mirrors the reference exactly:

- count NAs / non-NAs; build a per-individual NA mask (the reference packs
  it 4-per-byte as ``mask4``; we keep a dense float 0/1 vector and lay it
  out in phase-planes on device),
- mask out the byte-padding tail when N % 4 != 0 (``phenotype.cpp:633-645``),
- center by the non-NA mean, then scale so that the non-NA sum of squares
  equals ``nonas - 1`` (``phenotype.cpp:647-667``); the scaled, centered
  vector with zeros at NAs is the *initial residual* epsilon.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gmrm_tpu_torch.io.bed import bed_bytes_per_marker
from gmrm_tpu_torch.io.native import native_parse_phen


@dataclass
class Phenotype:
    filepath: str
    values: np.ndarray        # (N,) float64, raw values; NaN at NAs
    mask: np.ndarray          # (N,) bool, True where observed (non-NA)
    epsilon0: np.ndarray      # (N,) float64 centered+scaled, 0.0 at NAs
    nonas: int
    nas: int

    @property
    def n(self) -> int:
        return self.values.shape[0]

    def na_vector_padded(self) -> np.ndarray:
        """0/1 mask padded to 4*mbytes (padding = 0), the na_lut analog."""
        mb = bed_bytes_per_marker(self.n)
        out = np.zeros(mb * 4, dtype=np.float64)
        out[: self.n] = self.mask.astype(np.float64)
        return out

    def epsilon_padded(self) -> np.ndarray:
        mb = bed_bytes_per_marker(self.n)
        out = np.zeros(mb * 4, dtype=np.float64)
        out[: self.n] = self.epsilon0
        return out

    def centered_scaled_y(self) -> np.ndarray:
        """The centered+scaled phenotype (== epsilon0); reference
        get_centered_and_scaled_y used by predict (src/bayes.cpp:141)."""
        return self.epsilon0.copy()


def _parse_numpy(filepath: str) -> np.ndarray:
    """The NumPy route: Python's text mode, ``str.split`` and ``float``;
    NaN at NAs."""
    vals_list = []
    with open(filepath) as fh:
        for line in fh:
            toks = line.split()
            if not toks:
                continue
            if len(toks) < 3:
                raise IOError(
                    f"phen file {filepath}: expected 'FID IID value', got {line!r}"
                )
            v = toks[2]
            if v == "NA":
                vals_list.append(np.nan)
            else:
                try:
                    vals_list.append(float(v))
                except ValueError:
                    raise IOError(
                        f"phen file {filepath}: expected numeric value "
                        f"or NA, got {line!r}"
                    ) from None
    return np.asarray(vals_list, dtype=np.float64)


def read_phen(filepath: str, n_expected: int | None = None,
              route: str = "native") -> Phenotype:
    """Read and preprocess a .phen file.  Given ``n_expected``, it is parsed
    by the port's host library (``io/native.py``), as gmrm_tpu parses it;
    a file that library sends back (a line it does not read as the NumPy
    route does, or more lines than ``n_expected``) is parsed again on the
    NumPy route, so the values, or the error, are that route's.
    ``route="numpy"`` takes the NumPy route alone: the plain version that
    the tests hold the library against."""
    if route not in ("native", "numpy"):
        raise ValueError(f"route must be 'native' or 'numpy', got {route!r}")
    values = None
    if n_expected and route == "native":
        try:
            raw, isna = native_parse_phen(filepath, n_expected)
            values = np.where(isna, np.nan, raw)
        except IOError:
            pass
    if values is None:
        values = _parse_numpy(filepath)
    mask = ~np.isnan(values)
    nonas = int(mask.sum())
    nas = int((~mask).sum())
    n = values.shape[0]
    if n_expected is not None and n != n_expected:
        raise IOError(
            f"N = {n_expected} while phen file {filepath} has {n} individuals!"
        )
    # Center and scale exactly like reference phenotype.cpp:647-667.
    avg = values[mask].sum() / nonas
    eps = np.where(mask, values - avg, 0.0)
    sqn = np.sqrt((nonas - 1) / (eps[mask] ** 2).sum())
    eps = eps * sqn
    return Phenotype(
        filepath=filepath, values=values, mask=mask, epsilon0=eps,
        nonas=nonas, nas=nas,
    )
