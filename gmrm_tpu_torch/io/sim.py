"""Synthetic GWAS dataset simulator (the reference's ``example/data_sim.R``
equivalent, ``example/data_sim.R:1-80``, but emitting .bed directly).

Generative model: genotypes X ~ Binomial(2, maf) iid; a subset of
``n_causal`` markers gets effects b ~ N(0, h2/n_causal) on the standardized
scale; y = scale(X) @ beta + e with Var(e) chosen so Var(y) ~= 1.  Writes
the full file set consumed by the sampler: .bed/.dim/.bim/.phen/.gri/.grm.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from gmrm_tpu_torch.io.bed import write_bed

# Datasets up to this many genotype cells are generated in memory; larger
# ones stream marker chunks (tests shrink it to exercise the chunked
# path at toy sizes).
INMEM_LIMIT = 200_000_000


@dataclass
class SimResult:
    out_dir: str
    n: int
    m: int
    bed: str
    dim: str
    bim: str
    gri: str
    grm: str
    phens: list
    beta_true: np.ndarray       # (M, n_traits) standardized-scale effects
    h2_realized: np.ndarray     # (n_traits,)


def simulate(
    out_dir: str,
    n: int = 1000,
    m: int = 500,
    n_traits: int = 1,
    n_causal: int | None = None,
    h2: float = 0.5,
    maf: float = 0.4,
    n_groups: int = 1,
    mixtures: np.ndarray | None = None,
    na_rate: float = 0.0,
    seed: int = 171014,
    prefix: str = "test",
    ld_rho: float = 0.0,
) -> SimResult:
    """``ld_rho`` > 0 generates LD-STRUCTURED genotypes instead of iid:
    each individual's two haplotypes follow a Gaussian-copula AR(1) chain
    across markers (latent z_j = rho z_{j-1} + sqrt(1-rho^2) e_j,
    allele = z < Phi^{-1}(maf)), giving genomically adjacent markers the
    high pairwise r^2 real data has — the stress case for the wave
    relaxation (same-wave markers are blind to each other's moves)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    if n_causal is None:
        n_causal = max(1, m // 4)

    paths = {}
    bed_path = os.path.join(out_dir, f"{prefix}.bed")

    def ld_dosage_chunk(z, count):
        """Continue the Gaussian-copula AR(1) haplotype chain for
        ``count`` markers from latent state ``z`` ((2, n) or None) ->
        (dosage (count, n) uint8, new state).  The chain is Markov in z,
        so it streams across marker chunks with O(n) carried state —
        the chunked path generates LD at ANY M with the same draw
        sequence as the in-memory path."""
        from statistics import NormalDist
        thresh = NormalDist().inv_cdf(maf)
        rr = np.sqrt(1.0 - ld_rho * ld_rho)
        hap = np.empty((2, n, count), np.uint8)
        for j in range(count):
            z = (rng.normal(size=(2, n)) if z is None
                 else ld_rho * z + rr * rng.normal(size=(2, n)))
            hap[:, :, j] = z < thresh
        return hap.sum(axis=0).T.astype(np.uint8), z    # (count, N)

    if m * n <= INMEM_LIMIT:
        # Genotype codes on the dosage scale {0,1,2}; bed code mapping:
        # dosage 2 -> code 0, dosage 1 -> code 2, dosage 0 -> code 3.
        if ld_rho > 0.0:
            dosage, _ = ld_dosage_chunk(None, m)          # (M, N)
        else:
            dosage = rng.binomial(2, maf, size=(m, n)).astype(np.uint8)
        code = np.where(dosage == 2, 0,
                        np.where(dosage == 1, 2, 3)).astype(np.uint8)

        # Standardize columns of X (markers) for the effect model.
        xm = dosage.astype(np.float64)
        mu = xm.mean(axis=1, keepdims=True)
        sd = xm.std(axis=1, ddof=1, keepdims=True)
        sd[sd == 0] = 1.0
        xs = (xm - mu) / sd                 # (M, N)

        beta = np.zeros((m, n_traits))
        causal = rng.choice(m, size=n_causal, replace=False)
        beta[causal] = rng.normal(0.0, np.sqrt(h2 / n_causal),
                                  size=(n_causal, n_traits))
        g = xs.T @ beta                      # (N, n_traits)
        write_bed(bed_path, code)
    else:
        # Large-scale path: stream marker chunks so peak memory stays
        # ~O(chunk x N) regardless of M (UKB-scale sims).  Effects are
        # needed during streaming, so they come from a SEPARATE
        # deterministic generator — the main rng then spends exactly the
        # same draw sequence on genotypes as the in-memory path, making
        # the .bed bytes chunk-invariant (tested for the LD chain).
        rng_eff = np.random.default_rng([seed, 17])
        beta = np.zeros((m, n_traits))
        causal = rng_eff.choice(m, size=n_causal, replace=False)
        beta[causal] = rng_eff.normal(0.0, np.sqrt(h2 / n_causal),
                                      size=(n_causal, n_traits))
        g = np.zeros((n, n_traits))
        chunk = max(1, INMEM_LIMIT // n)
        z_state = None
        with open(bed_path, "wb") as fh:
            from gmrm_tpu_torch.io.bed import BED_MAGIC, pack_codes
            fh.write(BED_MAGIC)
            for s in range(0, m, chunk):
                e = min(m, s + chunk)
                if ld_rho > 0.0:
                    dosage, z_state = ld_dosage_chunk(z_state, e - s)
                else:
                    dosage = rng.binomial(
                        2, maf, size=(e - s, n)).astype(np.uint8)
                xm = dosage.astype(np.float64)
                mu = xm.mean(axis=1, keepdims=True)
                sd = xm.std(axis=1, ddof=1, keepdims=True)
                sd[sd == 0] = 1.0
                bc = beta[s:e]
                nz = np.flatnonzero(np.any(bc != 0, axis=1))
                if nz.size:
                    xs = (xm[nz] - mu[nz]) / sd[nz]
                    g += xs.T @ bc[nz]
                code = np.where(dosage == 2, 0,
                                np.where(dosage == 1, 2, 3)).astype(np.uint8)
                pack_codes(code).tofile(fh)

    vg = g.var(axis=0)
    ve = np.maximum(1.0 - vg, 1e-3)
    y = g + rng.normal(0.0, np.sqrt(ve), size=(n, n_traits))
    h2_real = vg / y.var(axis=0)
    paths["bed"] = bed_path

    dim_path = os.path.join(out_dir, f"{prefix}.dim")
    with open(dim_path, "w") as fh:
        fh.write(f"{n} {m}\n")
    paths["dim"] = dim_path

    bim_path = os.path.join(out_dir, f"{prefix}.bim")
    with open(bim_path, "w") as fh:
        for j in range(m):
            fh.write(f"1\trs{j + 1}\t0\t{j + 1}\tA\tG\n")
    paths["bim"] = bim_path

    gri_path = os.path.join(out_dir, f"{prefix}.gri")
    groups = (np.arange(m) * n_groups // m).astype(int)
    with open(gri_path, "w") as fh:
        for j in range(m):
            fh.write(f"{j} {groups[j]}\n")
    paths["gri"] = gri_path

    grm_path = os.path.join(out_dir, f"{prefix}.grm")
    if mixtures is None:
        mixtures = np.array([0.0, 0.0001, 0.001, 0.01])
    with open(grm_path, "w") as fh:
        for _ in range(n_groups):
            fh.write(" ".join(f"{v:.5f}" for v in np.atleast_1d(mixtures)) + "\n")
    paths["grm"] = grm_path

    phen_paths = []
    for t in range(n_traits):
        pp = os.path.join(out_dir, f"{prefix}{t + 1}.phen")
        na_idx = set()
        if na_rate > 0:
            n_na = int(round(na_rate * n))
            na_idx = set(rng.choice(n, size=n_na, replace=False).tolist())
        with open(pp, "w") as fh:
            for i in range(n):
                val = "NA" if i in na_idx else repr(float(y[i, t]))
                fh.write(f"{i + 1} {i + 1} {val}\n")
        phen_paths.append(pp)

    return SimResult(
        out_dir=out_dir, n=n, m=m, bed=paths["bed"], dim=paths["dim"],
        bim=paths["bim"], gri=paths["gri"], grm=paths["grm"],
        phens=phen_paths, beta_true=beta, h2_realized=h2_real,
    )
