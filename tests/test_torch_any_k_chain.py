"""Whole Gibbs iterations at K = 17 mixture components in lockstep with
the JAX package's ``gibbs_iteration``, on the CPU, every random number
scripted (tests/test_torch_chain_lockstep.py's ``run_lockstep`` and its
gates, on a dataset whose .grm has 17 strictly ascending variances).

Paths: ``mega`` (float32 W=8, the JAX whole-sweep kernel in interpret
mode against the port's ``WholeSweepIteration``), ``w1_pallas`` (W=1
against the JAX Pallas serial sweep) and ``f64_wave`` (float64 W=8, the
JAX wave scan patched to the float64 reference).  On the card these
paths run kernels 7/8, 6 and E, held to these plain versions by
chip_smoke.py phase 11.
"""

import pytest
import torch

from gmrm_tpu.io.sim import simulate
from test_torch_any_k import mixtures
from test_torch_chain_lockstep import PATHS, run_lockstep

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def chain_sim17(tmp_path_factory):
    """tests/test_torch_chain_lockstep.py's chain_sim (120 markers, 2
    traits, 2 groups, 2% phenotype NAs, N=600) with 17 components."""
    return simulate(str(tmp_path_factory.mktemp("lockstep17")), n=600,
                    m=120, n_traits=2, n_causal=32, h2=0.5, n_groups=2,
                    na_rate=0.02, seed=29, mixtures=mixtures(17))


@pytest.mark.parametrize("name", ["mega", "w1_pallas", "f64_wave"])
def test_whole_iterations_at_17_components(chain_sim17, name, monkeypatch,
                                           tmp_path):
    run_lockstep(chain_sim17, PATHS[name], monkeypatch, tmp_path)
