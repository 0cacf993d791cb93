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

A cell on several cards is a marker-sharded deployment (:func:`make_shards`):
the markers split over ``shards`` shards as gmrm's ranks split them
(:func:`marker_blocks`), each shard's frequencies, effects and genotypes
drawn from a generator of its own, keyed by the seed and the shard, on the
card of the process that holds it, and the phenotypes from the sum of
every shard's genetic value, taken in shard order.  So the same seed gives
the same deployment whatever the number of processes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, List, Optional

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


def data_generator(seed: int, device, shard: Optional[int] = None
                   ) -> torch.Generator:
    """The data's own stream, apart from the program's draw scheme; on a
    sharded deployment each shard's markers have a stream of their own."""
    words = [int(seed), 0x6D61] + ([] if shard is None else [int(shard) + 1])
    key = np.random.SeedSequence(words).generate_state(1, np.uint64)
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



def marker_blocks(m: int, shards: int):
    """(start, length) of each shard's markers: the block partition, the
    remainder to the low shards (gmrm's set_block_of_markers)."""
    size, extra = divmod(m, shards)
    out, start = [], 0
    for i in range(shards):
        ln = size + (i < extra)
        out.append((start, ln))
        start += ln
    return out


@dataclass
class ShardData:
    """The raw inputs of a marker-sharded deployment as one process holds
    them: its shards' genotypes in storage order (interleaved at W > 1,
    padded to the common ``m_pad_shard`` rows and mb_pad bytes), and the
    phenotypes, groups and mixtures of the whole deployment.  ``storage``
    is True: no .bed is written."""
    n: int
    m: int                       # markers of the whole deployment
    traits: int
    n_shards: int
    shards: List[int]            # the global ids held here
    starts: List[int]            # first original marker of each
    m_locals: List[int]
    beds: List[torch.Tensor]     # (m_pad_shard, mb_pad) uint8 each
    orders: List[np.ndarray]     # storage row -> the shard's marker
    mask: torch.Tensor           # (T, N) bool, observed
    y: torch.Tensor              # (T, N) float64, NaN where missing
    groups: np.ndarray           # (Mt,) int, original order
    cva: np.ndarray              # (G, K)
    storage: bool = True
    files: Optional[dict] = None


def make_shards(config: dict, traffic: dict, seed: int, device, workdir: str,
                shards: List[int], gather: Callable, writer: bool = True,
                wait: Callable = lambda: None) -> ShardData:
    """This process's shards of a sharded deployment (module docstring).

    ``gather(x)`` returns the list of every process's ``x``, in rank order,
    each process holding a contiguous run of shards (the identity's
    ``[x]`` with one process).  The process with ``writer`` writes the
    phenotype and group files into ``workdir``, which every process
    shares; ``wait()`` holds the others until it has."""
    n, m = int(config["individuals"]), int(config["markers"])
    S = int(config["shards"])
    T = int(traffic["traits"])
    G = int(config["groups"])
    B, W = int(traffic["block_size"]), int(traffic["wave"])
    cva = np.asarray([config["mixtures"]] * G, dtype=np.float64)
    lo, hi = config["maf_range"]
    h2 = float(config["h2"])
    parts = marker_blocks(m, S)
    m_pad_shard = ref.round_up(max(ln for _, ln in parts), B)
    mb_pad = ref.round_up(-(-n // 4), 512)
    # Every shard's frequencies and causal markers, from its own stream:
    # the effects' scale counts the causal markers of all of them.
    gens, mafs, causals = [], [], []
    for i, (_, ln) in enumerate(parts):
        g = data_generator(seed, device, shard=i)
        maf = lo + (hi - lo) * torch.rand((ln,), generator=g, device=device,
                                          dtype=torch.float64)
        causal = torch.rand((ln,), generator=g, device=device) < config["causal_share"]
        gens.append(g)
        mafs.append(maf)
        causals.append(causal)
    n_causal = max(1, int(sum(int(c.sum()) for c in causals)))
    beds, orders, gvals = [], [], []
    for i in shards:
        ln, g = parts[i][1], gens[i]
        beta = (torch.randn((ln, T), generator=g, device=device,
                            dtype=torch.float64)
                * np.sqrt(h2 / n_causal)) * causals[i][:, None]
        order = (ref.interleave_order(ln, m_pad_shard // B)[0] if W > 1
                 else np.arange(ln))
        idx = torch.as_tensor(order, device=device)
        rows, gval = genotypes(n, mafs[i][idx], beta[idx], mb_pad, g)
        bed = torch.full((m_pad_shard, mb_pad), ref.MISSING,
                         dtype=torch.uint8, device=device)
        bed[:ln] = rows
        del rows
        beds.append(bed)
        orders.append(order)
        gvals.append(gval)
    # The genetic value of the whole deployment, summed in shard order.
    every = [x for part in gather(torch.stack(gvals)) for x in part]
    gval = every[0].clone()
    for x in every[1:]:
        gval += x
    del every
    gen = data_generator(seed, device)
    noise = torch.randn((n, T), generator=gen, device=device,
                        dtype=torch.float64)
    vg = gval.var(dim=0)
    y = gval + noise * torch.sqrt(torch.clamp(1.0 - vg, min=1e-3))
    rates = torch.as_tensor(traffic["na_rates"], dtype=torch.float64,
                            device=device)
    mask = torch.rand((T, n), generator=gen, device=device,
                      dtype=torch.float64) >= rates[:, None]
    y = torch.where(mask, y.T, torch.nan)
    data = ShardData(
        n=n, m=m, traits=T, n_shards=S, shards=list(shards),
        starts=[parts[i][0] for i in shards],
        m_locals=[parts[i][1] for i in shards], beds=beds, orders=orders,
        mask=mask, y=y, groups=(np.arange(m) * G // m).astype(np.int64),
        cva=cva)
    if writer:
        data.files = write_files(data, workdir)
    wait()
    if not writer:
        data.files = file_paths(workdir, T)
    return data


def file_paths(workdir: str, traits: int) -> dict:
    """The paths :func:`write_files` writes (no .bed)."""
    return {"phens": [os.path.join(workdir, f"trait{t + 1}.phen")
                      for t in range(traits)],
            "dim": os.path.join(workdir, "panel.dim"),
            "gri": os.path.join(workdir, "panel.gri"),
            "grm": os.path.join(workdir, "panel.grm")}


def shard_reference_inputs(data: ShardData, traffic: dict, q: int
                           ) -> ref.Inputs:
    """The reference's inputs of local shard ``q``: its bed as made, masks
    in phase planes, its groups in storage order, and the group counts of
    the whole deployment."""
    B, W = int(traffic["block_size"]), int(traffic["wave"])
    bed = data.beds[q]
    dev = bed.device
    m_pad, mb_pad = bed.shape
    ln, start = data.m_locals[q], data.starts[q]
    grp = np.zeros(m_pad, dtype=np.int64)
    grp[:ln] = data.groups[start:start + ln][data.orders[q]]
    G = data.cva.shape[0]
    return ref.Inputs(
        bed=bed, na=ref.to_planes(data.mask.to(torch.float64), mb_pad),
        nonas=data.mask.sum(1).to(torch.float64),
        group_of=torch.as_tensor(grp, device=dev),
        mtotgrp=torch.as_tensor(np.bincount(data.groups, minlength=G),
                                device=dev),
        cva=torch.as_tensor(data.cva, device=dev), n_total=data.n,
        m_local=ln, block_size=B, wave=W)
