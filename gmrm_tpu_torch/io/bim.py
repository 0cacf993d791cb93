"""PLINK ``.bim`` marker-map reading (rsid extraction).

The reference reads bim files only in predict mode to cross-reference rsids
between the analysis and reference panels (``src/bayes.cpp:288-316``): 6
whitespace-separated columns ``chr id genpos physpos allele1 allele2``; only
the id column is used, indexed by row number.
"""

from __future__ import annotations

from typing import Dict, List


def read_bim_ids(filepath: str) -> List[str]:
    ids = []
    with open(filepath) as fh:
        for line in fh:
            toks = line.split()
            if not toks:
                continue
            if len(toks) < 6:
                raise IOError(f"bim file {filepath}: expected 6 columns, got {line!r}")
            ids.append(toks[1])
    return ids


def bim_id_index(filepath: str) -> Dict[str, int]:
    """rsid -> row index map, as the reference builds for the ref panel."""
    return {rsid: i for i, rsid in enumerate(read_bim_ids(filepath))}
