"""Multi-seed posteriors of the port against the JAX package, each on its
own random numbers: the method of benchmarking/equivalence_ref.py, at the
W > 1 cadence (B=32, W=8: the JAX package's Pallas kernels in interpret
mode, mega-kernel on, against the port's default whole-sweep iteration).
tests/test_torch_chain_equivalence_w1.py holds the W=1 chains.

Both packages train ``sim_medium`` (tests/conftest.py: N=800, M=250, 2
traits, 2 groups, 2% NAs) through their own ``run_training`` at SEEDS
seeds a side, thin 2; the first 40% of each chain's records is burn-in.
The JAX step is compiled once and reused across seeds
(``gmrm_tpu.runner.make_gibbs_step`` memoized for the fixture).

Criterion per trait (benchmarking/EQUIVALENCE.md), all in one test, so
that the chains are made once:
- the pooled posterior-mean h2 differs by at most 3 hypot(SEM_jax,
  SEM_port) over seeds, with a floor of 0.015;
- the pooled posterior-mean sigmaE by at most 3 hypot(SEM_jax, SEM_port),
  with a floor of 3% of its pooled mean;
- the smallest cross-package correlation of posterior-mean betas (seed i
  against seed i) is at least 0.9.
"""

import os

import numpy as np
import pytest
import torch

import gmrm_tpu.ops.pallas_kernels as pk
import gmrm_tpu.ops.scan_kernel_wave as skw
import gmrm_tpu.ops.sweep_kernel as swk
from gmrm_tpu import runner as jrunner
from gmrm_tpu.config import Options as JaxOptions
from gmrm_tpu_torch.config import Options
from gmrm_tpu_torch.io.writers import read_history
from gmrm_tpu_torch.runner import run_training

torch.set_num_threads(2)

SEEDS = (42, 43, 44)
THIN, BURN = 2, 0.4
WAVE, ITERS = 8, 200


def parse_csv_chain(path):
    """(sigmaE, h2) per record of a .csv (equivalence_ref.parse_csv_chain)."""
    se, h2 = [], []
    with open(path) as fh:
        for line in fh:
            parts = [p.strip() for p in line.split(",") if p.strip()]
            if not parts:
                continue
            g = int(parts[1])
            se.append(float(parts[2 + g]))
            h2.append(float(parts[3 + g]))
    return np.asarray(se), np.asarray(h2)


def posterior(out_dir, sim, iters):
    """Per trait: post-burn-in means of h2 and sigmaE, and of the betas."""
    rows = []
    for ph in sim.phens:
        base = os.path.join(out_dir, os.path.splitext(
            os.path.basename(ph))[0])
        se, h2 = parse_csv_chain(base + ".csv")
        _, bet = read_history(base + ".bet", "f8")
        assert len(h2) == bet.shape[0] == iters // THIN
        k = int(len(h2) * BURN)
        rows.append({"h2": h2[k:].mean(), "sigmae": se[k:].mean(),
                     "beta": bet[int(bet.shape[0] * BURN):].mean(axis=0)})
    return rows


def run_chains(sim, tmp, wave, iters, use_pallas):
    """Each package's chains at every seed: {"jax": [...], "port": [...]},
    a list of per-trait posteriors per seed."""
    out = {"jax": [], "port": []}
    step_cache = {}
    make_step = jrunner.make_gibbs_step

    def memo(**kw):
        key = tuple(sorted(kw.items()))
        if key not in step_cache:
            step_cache[key] = make_step(**kw)
        return step_cache[key]

    with pytest.MonkeyPatch.context() as mp:
        for mod in (pk, skw, swk):
            mp.setattr(mod, "FORCE_INTERPRET", True)
        mp.setattr(jrunner, "make_gibbs_step", memo)
        for seed in SEEDS:
            for who in ("jax", "port"):
                d = os.path.join(tmp, f"{who}{seed}")
                kw = dict(bed_file=sim.bed, dim_file=sim.dim,
                          phen_files=sim.phens, group_index_file=sim.gri,
                          group_mixture_file=sim.grm, iterations=iters,
                          seed=seed, block_size=32, wave_size=wave,
                          output_thin_rate=THIN, out_dir=d)
                if who == "jax":
                    jrunner.run_training(
                        JaxOptions(use_pallas=use_pallas, **kw),
                        verbose=False)
                else:
                    run_training(Options(**kw), device="cpu", verbose=False)
                out[who].append(posterior(d, sim, iters))
    assert len(step_cache) == 1
    return out


def pooled(chains, who, t, key):
    x = np.array([seed[t][key] for seed in chains[who]])
    return x.mean(), x.std(ddof=1) / np.sqrt(len(x))


def check(chains, t, criterion):
    """One criterion of benchmarking/EQUIVALENCE.md for trait t: (ok,
    what it read)."""
    if criterion == "beta_corr":
        corr = [float(np.corrcoef(j[t]["beta"], p[t]["beta"])[0, 1])
                for j, p in zip(chains["jax"], chains["port"])]
        return min(corr) >= 0.9, (f"trait {t}: cross-package beta "
                                  f"correlations {np.round(corr, 4)}")
    mj, sj = pooled(chains, "jax", t, criterion)
    mp_, sp = pooled(chains, "port", t, criterion)
    floor = 0.015 if criterion == "h2" else 0.03 * (mj + mp_) / 2
    tol = max(3.0 * float(np.hypot(sj, sp)), floor)
    return abs(mj - mp_) <= tol, (
        f"trait {t} {criterion}: jax {mj:.4f}+-{sj:.4f}, port "
        f"{mp_:.4f}+-{sp:.4f}, diff {abs(mj - mp_):.4f}, tol {tol:.4f}")


def check_all(chains):
    """Every criterion for every trait, all read before any fails (one
    test a file: the chains are made once, in whichever worker runs
    it)."""
    T = len(chains["jax"][0])
    results = [check(chains, t, c) for t in range(T)
               for c in ("h2", "sigmae", "beta_corr")]
    for _, line in results:
        print(line)
    assert all(ok for ok, _ in results), [line for ok, line in results
                                          if not ok]


def test_wave_posteriors_match_jax(sim_medium, tmp_path):
    check_all(run_chains(sim_medium, str(tmp_path), WAVE, ITERS,
                         use_pallas=True))
