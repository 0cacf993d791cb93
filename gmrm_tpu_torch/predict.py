"""Posterior prediction / association statistics, the reference's
``--predict`` mode (port of gmrm_tpu/predict.py; reference
``src/bayes.cpp:16-284``).

Per phenotype:

1. validate the ``.bet`` chain header against the reference-panel bim
   (``bayes.cpp:47-55``) and report niter;
2. y_k = y: under the pinned 1-rank residualization (``bayes.cpp:138-147``)
   the genetic value cancels out of every output field, so neither it nor
   the chain is computed; sigma = sum(y^2) / nonas;
3. per-marker OLS on *uncentered* dosages (a * na, ``bayes.cpp:191-205``):
   beta = xty/xtx, t = xty/sqrt(sigma*xtx), se = beta/t, p = erfc(|t|/√2);
4. fixed-width ``.mlma`` lines, markers absent from the reference bim
   excluded (``bayes.cpp:223-254``).

The sums of step 3 are the only device work: ``ops/predict_sums`` (one
launch of csrc/predict_sums.cu per trait and bed chunk on CUDA, its plain
version on the CPU).  Everything else is float64 NumPy on the host, as in
the JAX package, so given the same sums the two write the same bytes.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from gmrm_tpu_torch.config import Options
from gmrm_tpu_torch.io.bed import bed_bytes_per_marker, read_bed
from gmrm_tpu_torch.io.bim import bim_id_index, read_bim_ids
from gmrm_tpu_torch.io.grouping import read_dim
from gmrm_tpu_torch.io.phen import read_phen
from gmrm_tpu_torch.io.writers import (
    MLMA_LINE_LEN, format_mlma_line, history_mtot,
)
from gmrm_tpu_torch.ops.decode import to_phase_planes
from gmrm_tpu_torch.ops.predict_sums import (
    pad_columns, padded_chunk, pitch_of, predict_sums,
)
from gmrm_tpu_torch.parallel.distributed import (
    Communicator, process_count, process_index,
)
from gmrm_tpu_torch.parallel.mesh import marker_blocks
from gmrm_tpu_torch.runner import resolve_device, stem

# Bytes of padded bed a process keeps on the device across traits; a
# larger slice goes up in chunks under this size, once per trait.
BED_BUDGET = 2 ** 30

# The phases of run_predict's wall time (its return value).
PHASES = ("read", "upload", "sums", "ols", "write")


def _check_bet_and_niter(bet_path: str, expect_mtot: int) -> int:
    """The .bet header's Mtot against the reference-panel bim size (the
    reference's own check, bayes.cpp:47-55), and the recorded iteration
    count.  Reads the header only; raises IOError on a mismatch or a
    ragged tail (gmrm_tpu/predict.py:96)."""
    mtot = history_mtot(bet_path)
    if mtot != expect_mtot:
        raise IOError(
            f"Mismatch between expected and Mtot read from .bet file: "
            f"{expect_mtot} vs {mtot}"
        )
    rec_bytes = 4 + mtot * 8
    size = os.path.getsize(bet_path)
    if (size - 4) % rec_bytes != 0:
        raise IOError(
            f"{bet_path}: size {size} not consistent with Mtot={mtot}")
    return (size - 4) // rec_bytes


class _Split:
    """Wall seconds by phase; ``lap`` ends the current phase after the
    device's queued work."""

    def __init__(self, device):
        self.device = device
        self.seconds = dict.fromkeys(PHASES, 0.0)
        self.t = time.perf_counter()

    def lap(self, phase: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[phase] += now - self.t
        self.t = now


def run_predict(opt: Options, device=None, verbose: bool = True) -> dict:
    """Write <out_dir>/<phen-stem>.mlma for every phenotype; ``device``
    None means CUDA.  Returns the wall seconds by phase (``PHASES``); a
    bed too large for ``BED_BUDGET`` goes up chunk by chunk under "sums".

    Each process takes its contiguous marker block (bayes.cpp:903-925),
    reads only its .bed slice and writes its lines at their byte offsets
    (bayes.cpp:223-254); the bytes are the same for any process count.
    ``--devices S`` changes nothing here: per-marker sums never cross
    markers, so one pass over the process's markers gives the bytes that S
    shards would (the JAX package's shard_map path gives the same bytes for
    the same reason), and the port adds no sharded path.
    """
    dev = resolve_device(device)
    split = _Split(dev)
    opt.validate()
    n, m_total = read_dim(opt.dim_file)
    if opt.trunc_markers:
        m_total = min(m_total, opt.trunc_markers)
    rsid = read_bim_ids(opt.bim_file)
    ref_idx = bim_id_index(opt.ref_bim_file)

    pid = process_index()
    s0, m_loc = marker_blocks(m_total, process_count())[pid]
    bed = read_bed(opt.bed_file, n, m_total, s0, m_loc)
    mb = bed_bytes_per_marker(n)
    pitch = pitch_of(mb)

    # Reference-panel membership over ALL markers: line numbers in the
    # .mlma are global prefix counts of kept markers (bayes.cpp:237-247).
    keep_all = np.array([rid in ref_idx for rid in rsid[:m_total]])
    rmglo_all = np.array([ref_idx.get(rid, -1) for rid in rsid[:m_total]])
    line_no = np.cumsum(keep_all) - 1
    n_keep = int(keep_all.sum())
    keep = keep_all[s0:s0 + m_loc]
    rmglo = rmglo_all[s0:s0 + m_loc]
    comm = Communicator(dev)
    split.lap("read")

    rows = max(1, BED_BUDGET // pitch)
    spans = [(s, min(s + rows, m_loc)) for s in range(0, m_loc, rows)]
    resident = padded_chunk(bed, 0, m_loc, dev) if len(spans) == 1 else None
    split.lap("upload")

    for phen_path in opt.phen_files:
        ph = read_phen(phen_path, n)
        base = os.path.join(opt.out_dir, stem(phen_path))
        niter = _check_bet_and_niter(base + ".bet", len(ref_idx))
        if verbose and pid == 0:
            print(f"INFO   : Number of recorded iterations in .bet file: "
                  f"{niter}")
        y = ph.epsilon_padded()                         # centered+scaled
        planes = [pad_columns(to_phase_planes(v).astype(np.float32), pitch,
                              0.0) for v in (ph.na_vector_padded(), y)]
        split.lap("read")

        na_d, y_d = (torch.from_numpy(p).to(dev) for p in planes)
        split.lap("upload")

        sums = [torch.stack(predict_sums(
            resident if resident is not None else padded_chunk(bed, s, e, dev),
            na_d, y_d)) for s, e in spans]
        # ONE stacked copy to the host per trait.
        xx = (torch.cat(sums, dim=1) if sums
              else torch.zeros((2, 0))).cpu().numpy().astype(np.float64)
        split.lap("sums")

        # float64 OLS on the host, as the reference (bayes.cpp:191-205).
        sigma = float(y @ y) / ph.nonas
        xtx, xty = xx[0], xx[1]
        with np.errstate(divide="ignore", invalid="ignore"):
            beta = xty / xtx
            tdist = xty / np.sqrt(sigma * xtx)
            se = beta / tdist
        # p = 1 - P(1/2, t^2/2) = erfc(|t|/sqrt(2)) (bayes.cpp:202-205).
        erfc_v = np.frompyfunc(math.erfc, 1, 1)
        with np.errstate(invalid="ignore"):
            pval = erfc_v(np.abs(tdist) / np.sqrt(2.0)).astype(np.float64)
        pval = np.where(np.isfinite(tdist), pval, np.nan)
        split.lap("ols")

        mlma_path = base + ".mlma"
        if pid == 0:
            if os.path.exists(mlma_path):
                os.remove(mlma_path)
            with open(mlma_path, "wb") as fh:
                fh.truncate(n_keep * MLMA_LINE_LEN)
        comm.barrier("mlma-create")
        with open(mlma_path, "r+b") as fh:
            for jl in range(m_loc):
                j = s0 + jl
                if not keep[jl]:
                    print(f"WARNING: marker id {rsid[j]} excluded -- "
                          f"no match")
                    continue
                fh.seek(int(line_no[j]) * MLMA_LINE_LEN)
                fh.write(format_mlma_line(
                    rsid[j], j, int(rmglo[jl]), beta[jl], tdist[jl],
                    se[jl], pval[jl]).encode())
        comm.barrier("mlma-done")
        if verbose and pid == 0:
            print(f"INFO   : wrote {n_keep} markers to {mlma_path}")
        split.lap("write")
    return split.seconds
