"""PLINK ``.bed`` genotype I/O (the port's copy of gmrm_tpu/io/bed.py).

Format (consumed by the reference at ``src/bayes.cpp:867-900``): a 3-byte
magic header ``0x6c 0x1b 0x01`` (SNP-major), then, per marker, ``mbytes =
ceil(N/4)`` bytes; each byte packs 4 individuals, 2 bits each,
little-endian within the byte (individual ``4j+k`` lives in bits
``2k..2k+1`` of byte ``j``).

2-bit code semantics (defined by the reference LUT generator
``src/lut/mk_lut.cpp:25-36,54-65``):

====  ==========  =====================  ==
code  meaning     dosage a               b
====  ==========  =====================  ==
0b00  hom A1      2.0                    1
0b01  missing     0.0                    0
0b10  het         1.0                    1
0b11  hom A2      0.0                    1
====  ==========  =====================  ==

``b`` is the genotype-present mask.  When a marker's byte count does not
fill the last byte (N % 4 != 0), PLINK pads with 0b00 bits; the reference
neutralizes those via the phenotype NA mask (``src/phenotype.cpp:633-645``)
and this package does the same (see gmrm_tpu_torch.io.phen).
"""

from __future__ import annotations

import os

import numpy as np

BED_MAGIC = b"\x6c\x1b\x01"

# Byte value whose four 2-bit codes are all "missing" (0b01010101): decodes
# to a = b = 0, used for device-side padding so padded columns/markers
# contribute exactly zero everywhere.
MISSING_BYTE = 0x55


def bed_bytes_per_marker(n_individuals: int) -> int:
    """mbytes = ceil(N/4), as in reference src/bayes.cpp:776."""
    return (n_individuals + 3) // 4


def read_bed(
    path: str,
    n_individuals: int,
    n_markers_total: int,
    start_marker: int = 0,
    n_markers: int | None = None,
    use_mmap: bool = False,
) -> np.ndarray:
    """Read a marker slice of a .bed file into a (n_markers, mbytes) uint8 array.

    The slice [start_marker, start_marker + n_markers) mirrors the reference's
    per-rank load at offset ``3 + S * mbytes`` (src/bayes.cpp:882).
    """
    mbytes = bed_bytes_per_marker(n_individuals)
    if n_markers is None:
        n_markers = n_markers_total - start_marker
    expect = 3 + n_markers_total * mbytes
    size = os.path.getsize(path)
    if size < expect:
        raise IOError(
            f"bed file {path} too small: {size} bytes < expected {expect} "
            f"(N={n_individuals}, Mt={n_markers_total})"
        )
    with open(path, "rb") as fh:
        magic = fh.read(3)
    if magic != BED_MAGIC:
        raise IOError(
            f"bed file {path} has bad magic {magic!r}; expected SNP-major "
            f"PLINK magic {BED_MAGIC!r}"
        )
    offset = 3 + start_marker * mbytes
    if use_mmap:
        mm = np.memmap(path, dtype=np.uint8, mode="r", offset=offset,
                       shape=(n_markers, mbytes))
        return np.asarray(mm)
    # The NumPy route; the optional native reader (gmrm_tpu/io/native.py)
    # is not ported yet (ROADMAP.md).
    with open(path, "rb") as fh:
        fh.seek(offset)
        data = np.fromfile(fh, dtype=np.uint8, count=n_markers * mbytes)
    if data.size != n_markers * mbytes:
        raise IOError(f"short read from {path}")
    return data.reshape(n_markers, mbytes)


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Pack (n_markers, N) uint8 2-bit codes into (n_markers, mbytes) bytes."""
    n_markers, n = codes.shape
    mbytes = bed_bytes_per_marker(n)
    pad = mbytes * 4 - n
    if pad:
        # PLINK pads trailing bits with zeros (code 0b00).
        codes = np.concatenate(
            [codes, np.zeros((n_markers, pad), dtype=np.uint8)], axis=1
        )
    c = codes.reshape(n_markers, mbytes, 4).astype(np.uint16)
    packed = (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6))
    return packed.astype(np.uint8)


def write_bed(path: str, codes: np.ndarray) -> None:
    """Write 2-bit genotype codes (n_markers, N) uint8 in {0,1,2,3} to a .bed file."""
    with open(path, "wb") as fh:
        fh.write(BED_MAGIC)
        pack_codes(codes).tofile(fh)


def unpack_codes(bed: np.ndarray, n_individuals: int) -> np.ndarray:
    """Unpack (M, mbytes) packed bytes to (M, N) 2-bit codes (numpy oracle path)."""
    m = bed.shape[0]
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    codes = (bed[:, :, None] >> shifts[None, None, :]) & 0x3
    return codes.reshape(m, -1)[:, :n_individuals]


def decode_planes(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """codes -> (a, b) dosage / present planes, float64 (numpy oracle path)."""
    a = np.zeros(codes.shape, dtype=np.float64)
    a[codes == 0] = 2.0
    a[codes == 2] = 1.0
    b = (codes != 1).astype(np.float64)
    return a, b
