"""The cell's inputs, made from ``--seed`` on the device.

Genotypes: marker j has a minor-allele frequency p_j drawn uniformly from
the configuration's range and Hardy-Weinberg genotypes (data_sim.R's
binomial model), 16-bit uniforms compared with p^2 and p^2 + 2p(1-p).
Phenotypes: y_t = X_std beta_t + e_t with h2 of the variance on a random
``causal_share`` of the markers (io/sim.py's model), and per trait its
share of missing values.  Everything is drawn in large calls of one
``torch.Generator`` on the card; the genotype bytes never go through the
host unless the cell reads files.

A cell either reads files (``"inputs": "files"``: the .bed, .dim, .phen,
.gri and .grm are written here and read by the program's own readers) or
hands the program the genotypes in device memory (``"inputs": "device"``,
a deployment whose genotypes are too large to write once a run).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pbcore import reference as ref

BED_MAGIC = b"\x6c\x1b\x01"
CHUNK_BYTES = 1 << 30           # random words a generation step holds


@dataclass
class CellData:
    """The raw inputs of a run.  ``bed`` is in storage order (the layout
    the program works in: interleaved at W > 1, rows padded to m_pad with
    all-missing bytes, bytes to mb_pad) when ``storage`` is True, else in
    the file's order, (Mt, mb)."""
    n: int
    m: int
    traits: int
    bed: torch.Tensor
    storage: bool
    mask: torch.Tensor           # (T, N) bool, observed
    y: torch.Tensor              # (T, N) float64, NaN where missing
    groups: np.ndarray           # (Mt,) int, original order
    cva: np.ndarray              # (G, K)
    order: Optional[np.ndarray]  # storage row -> original marker
    files: Optional[dict] = None


def data_generator(seed: int, device) -> torch.Generator:
    """The data's own stream, apart from the program's draw scheme."""
    key = np.random.SeedSequence([int(seed), 0x6D61]).generate_state(1, np.uint64)
    g = torch.Generator(device=device)
    g.manual_seed(int(key[0]))
    return g


def genotypes(n: int, maf: torch.Tensor, beta: torch.Tensor, mb_out: int,
              gen: torch.Generator):
    """Packed genotype rows (len(maf), mb_out) uint8 for markers of
    frequencies ``maf`` and their genetic value X_std @ beta (N, T)
    float64.  Bytes past ceil(N/4) are all missing."""
    dev = maf.device
    rows = maf.shape[0]
    n4 = -(-n // 4) * 4
    out = torch.full((rows, mb_out), ref.MISSING, dtype=torch.uint8,
                     device=dev)
    gval = torch.zeros((n, beta.shape[1]), dtype=torch.float64, device=dev)
    step = max(1, CHUNK_BYTES // (4 * n4))
    for s in range(0, rows, step):
        e = min(rows, s + step)
        p = maf[s:e, None].to(torch.float64)
        t_hom = torch.round(p * p * 65536).to(torch.int32)
        t_het = torch.round((p * p + 2 * p * (1 - p)) * 65536).to(torch.int32)
        r = torch.randint(0, 65536, (e - s, n4), generator=gen, device=dev,
                          dtype=torch.int32)
        # 00 hom (p^2), 10 het (2p(1-p)), 11 the other hom.
        code = (r >= t_hom).to(torch.uint8) * 2 + (r >= t_het).to(torch.uint8)
        if n4 > n:
            code[:, n:] = 0             # PLINK's pad bits
        c = code.reshape(e - s, -1, 4)
        packed = c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)
        out[s:e, :n4 // 4] = packed
        b = beta[s:e]
        if bool((b != 0).any()):
            dose = torch.where(code == 0, 2.0, torch.where(code == 2, 1.0, 0.0))
            dose = dose[:, :n].to(torch.float32)
            pf = p.to(torch.float32)
            x = (dose - 2 * pf) / torch.sqrt(2 * pf * (1 - pf))
            gval += (x.T @ b.to(torch.float32)).to(torch.float64)
        del r, code, c, packed
    return out, gval


def make(config: dict, traffic: dict, seed: int, device, workdir: str,
         storage_layout: bool) -> CellData:
    """The run's inputs: genotypes, phenotypes, groups and mixtures."""
    n, m = int(config["individuals"]), int(config["markers"])
    T = int(traffic["traits"])
    G = int(config["groups"])
    cva = np.asarray([config["mixtures"]] * G, dtype=np.float64)
    gen = data_generator(seed, device)
    lo, hi = config["maf_range"]
    maf = lo + (hi - lo) * torch.rand((m,), generator=gen, device=device,
                                      dtype=torch.float64)
    causal = torch.rand((m,), generator=gen, device=device) < config["causal_share"]
    h2 = float(config["h2"])
    n_causal = max(1, int(causal.sum()))
    beta = (torch.randn((m, T), generator=gen, device=device,
                        dtype=torch.float64)
            * np.sqrt(h2 / n_causal)) * causal[:, None]
    groups = (np.arange(m) * G // m).astype(np.int64)
    B = int(traffic["block_size"])
    order = None
    if storage_layout:
        m_pad = ref.round_up(m, B)
        mb_pad = ref.round_up(-(-n // 4), 512)
        if int(traffic["wave"]) > 1:
            order, _ = ref.interleave_order(m, m_pad // B)
        else:
            order = np.arange(m)
        idx = torch.as_tensor(order, device=device)
        rows, gval = genotypes(n, maf[idx], beta[idx], mb_pad, gen)
        bed = torch.full((m_pad, mb_pad), ref.MISSING, dtype=torch.uint8,
                         device=device)
        bed[:m] = rows
        del rows
    else:
        bed, gval = genotypes(n, maf, beta, -(-n // 4), gen)
    noise = torch.randn((n, T), generator=gen, device=device,
                        dtype=torch.float64)
    vg = gval.var(dim=0)
    y = gval + noise * torch.sqrt(torch.clamp(1.0 - vg, min=1e-3))
    rates = torch.as_tensor(traffic["na_rates"], dtype=torch.float64,
                            device=device)
    mask = torch.rand((T, n), generator=gen, device=device,
                      dtype=torch.float64) >= rates[:, None]
    y = torch.where(mask, y.T, torch.nan)
    data = CellData(n=n, m=m, traits=T, bed=bed, storage=storage_layout,
                    mask=mask, y=y, groups=groups, cva=cva, order=order)
    data.files = write_files(data, workdir)
    return data


def write_phen(path: str, values: np.ndarray) -> None:
    lines = [f"{i + 1} {i + 1} NA" if np.isnan(v) else f"{i + 1} {i + 1} {v!r}"
             for i, v in enumerate(values.tolist())]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_files(data: CellData, workdir: str) -> dict:
    """The phenotype, dimension and group files, and the .bed where the
    cell reads it from a file (PLINK SNP-major)."""
    os.makedirs(workdir, exist_ok=True)
    paths = {"phens": []}
    y = data.y.cpu().numpy()
    for t in range(data.traits):
        p = os.path.join(workdir, f"trait{t + 1}.phen")
        write_phen(p, y[t])
        paths["phens"].append(p)
    paths["dim"] = os.path.join(workdir, "panel.dim")
    with open(paths["dim"], "w") as fh:
        fh.write(f"{data.n} {data.m}\n")
    paths["gri"] = os.path.join(workdir, "panel.gri")
    with open(paths["gri"], "w") as fh:
        fh.write("".join(f"{j} {g}\n" for j, g in enumerate(data.groups.tolist())))
    paths["grm"] = os.path.join(workdir, "panel.grm")
    with open(paths["grm"], "w") as fh:
        for row in data.cva:
            fh.write(" ".join(repr(float(v)) for v in row) + "\n")
    if not data.storage:
        paths["bed"] = os.path.join(workdir, "panel.bed")
        with open(paths["bed"], "wb") as fh:
            fh.write(BED_MAGIC)
            data.bed.cpu().numpy().tofile(fh)
    return paths


def storage_bed(data: CellData, B: int, wave: int) -> torch.Tensor:
    """The bed in the program's storage layout, for the reference: the
    run's own tensor where the cell hands it over, else built from the
    file-order rows by the reference's interleave and padding."""
    if data.storage:
        return data.bed
    m_pad = ref.round_up(data.m, B)
    mb_pad = ref.round_up(-(-data.n // 4), 512)
    if wave > 1:
        data.order, _ = ref.interleave_order(data.m, m_pad // B)
    else:
        data.order = np.arange(data.m)
    out = torch.full((m_pad, mb_pad), ref.MISSING, dtype=torch.uint8,
                     device=data.bed.device)
    out[:data.m, :data.bed.shape[1]] = data.bed[torch.as_tensor(
        data.order, device=data.bed.device)]
    return out


def reference_inputs(data: CellData, traffic: dict) -> ref.Inputs:
    """The reference's inputs: storage-order bed, masks in phase planes,
    groups in storage order, all worked out from the raw inputs."""
    B, W = int(traffic["block_size"]), int(traffic["wave"])
    bed = storage_bed(data, B, W)
    dev = bed.device
    m_pad, mb_pad = bed.shape
    na = ref.to_planes(data.mask.to(torch.float64), mb_pad)
    grp = np.zeros(m_pad, dtype=np.int64)
    grp[:data.m] = data.groups[data.order]
    G = data.cva.shape[0]
    return ref.Inputs(
        bed=bed, na=na, nonas=data.mask.sum(1).to(torch.float64),
        group_of=torch.as_tensor(grp, device=dev),
        mtotgrp=torch.as_tensor(np.bincount(data.groups, minlength=G),
                                device=dev),
        cva=torch.as_tensor(data.cva, device=dev), n_total=data.n,
        m_local=data.m, block_size=B, wave=W)

