"""Readers for the .dim, .gri (group index) and .grm (group mixtures) files.

- ``.dim``: one line, two ints ``N Mt`` (reference src/dimensions.cpp:8-29).
- ``.gri``: one ``label group`` pair per marker (reference
  src/bayes.cpp:830-853); 0-based group ids.
- ``.grm``: one row of K ascending variances per group; first entry 0.0
  (reference src/options.cpp:222-286).  Also exposed through
  Options.load_group_mixtures; the standalone reader here returns arrays.
"""

from __future__ import annotations

import numpy as np


def read_dim(filepath: str) -> tuple[int, int]:
    with open(filepath) as fh:
        line = fh.readline()
    toks = line.split()
    if len(toks) != 2:
        raise IOError("dim file should contain a single line with 2 integers")
    return int(toks[0]), int(toks[1])


def read_group_index(filepath: str, n_groups: int) -> np.ndarray:
    """Return (Mt,) int32 of group ids; errors on ids outside [0, n_groups).

    The reference only rejects ``group > G`` (src/bayes.cpp:846-850), which
    lets ``group == G`` overflow downstream arrays; we reject it up front.
    """
    labels = []
    groups = []
    with open(filepath) as fh:
        for line in fh:
            toks = line.split()
            if not toks:
                continue
            labels.append(toks[0])
            groups.append(int(toks[1]))
    g = np.asarray(groups, dtype=np.int32)
    if g.size and (g.min() < 0 or g.max() >= n_groups):
        raise IOError(
            "group index file contains a value that exceeds the number of "
            "groups given in group mixture file."
        )
    return g


def read_group_mixtures(filepath: str) -> tuple[np.ndarray, np.ndarray]:
    """Return (cva, cvai) both (G, K); see Options.load_group_mixtures."""
    from gmrm_tpu_torch.config import Options
    opt = Options(group_mixture_file=filepath)
    opt.load_group_mixtures()
    return opt.cva, opt.cvai
