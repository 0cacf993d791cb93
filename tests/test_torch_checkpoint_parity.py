"""The guard scenarios of tests/test_checkpoint.py run through gmrm_tpu and
through the port on the same inputs: each must succeed in both packages or
raise the same exception type in both (the port's messages are its own).

Scenarios: --resume without a checkpoint in an empty out-dir (starts
fresh) and over a previous chain's outputs (refused); a checkpoint whose
.bet is gone; a resume under another wave, block size or --trunc-markers;
a checkpoint without its layout stamp; a fresh run clearing the checkpoint
files of the chain before it; a sharded runner's file handed to the
single-device runner, as checkpoint.npz and as checkpoint.p0.npz.  The JAX
package runs on the CPU (its Pallas kernels in interpret mode), the port
with device="cpu".
"""

import os

import numpy as np
import pytest
import torch

from gmrm_tpu.config import Options as JaxOptions
from gmrm_tpu.parallel.runner import run_training_sharded as jax_sharded
from gmrm_tpu.runner import run_training as jax_training
from gmrm_tpu_torch.config import Options
from gmrm_tpu_torch.parallel.runner import run_training_sharded
from gmrm_tpu_torch.runner import run_training

torch.set_num_threads(2)

WAVE = dict(use_pallas=True, wave_size=4)


class _Jax:
    name = "gmrm_tpu"

    @staticmethod
    def train(kw):
        return jax_training(JaxOptions(**kw), verbose=False)

    @staticmethod
    def train_sharded(kw):
        return jax_sharded(JaxOptions(**kw), n_devices=2, verbose=False)


class _Port:
    name = "gmrm_tpu_torch"

    @staticmethod
    def train(kw):
        return run_training(Options(**kw), device="cpu", verbose=False)

    @staticmethod
    def train_sharded(kw):
        return run_training_sharded(Options(**kw), n_devices=2, device="cpu",
                                    verbose=False)


def _kw(sim, out, iterations, **kw):
    base = dict(bed_file=sim.bed, dim_file=sim.dim, phen_files=[sim.phens[0]],
                group_index_file=sim.gri, group_mixture_file=sim.grm,
                iterations=iterations, seed=7, out_dir=out, block_size=16,
                wave_size=1, output_thin_rate=2)
    base.update(kw)
    return base


def _outcome(fn):
    """None when ``fn`` returns, else the type of what it raised."""
    try:
        fn()
    except Exception as e:                    # compared across packages
        return type(e)
    return None


def _resume_in_empty_dir(pkg, sim, out):
    res = pkg.train(_kw(sim, out, 4, resume=True))
    assert len(res.iter_seconds) == 4
    return [None]


def _resume_over_outputs(pkg, sim, out):
    pkg.train(_kw(sim, out, 6))
    return [_outcome(lambda: pkg.train(_kw(sim, out, 8, resume=True)))]


def _missing_bet(pkg, sim, out):
    pkg.train(_kw(sim, out, 8, checkpoint_every=4))
    os.remove(os.path.join(out, "test1.bet"))
    return [_outcome(lambda: pkg.train(
        _kw(sim, out, 12, checkpoint_every=4, resume=True)))]


def _layout_change(**change):
    def scenario(pkg, sim, out):
        pkg.train(_kw(sim, out, 6, checkpoint_every=3, **WAVE))
        kw = dict(WAVE, **change)
        if change.get("trunc_markers"):
            kw["trunc_markers"] = sim.m - 16
        return [_outcome(lambda: pkg.train(
            _kw(sim, out, 10, checkpoint_every=3, resume=True, **kw)))]
    return scenario


def _unstamped(pkg, sim, out):
    pkg.train(_kw(sim, out, 6, checkpoint_every=3))
    ck = os.path.join(out, "checkpoint.npz")
    with np.load(ck) as z:
        arrays = {k: z[k] for k in z.files if not k.startswith("layout_")}
    np.savez(ck, **arrays)
    return [_outcome(lambda: pkg.train(
        _kw(sim, out, 8, checkpoint_every=3, resume=True)))]


def _fresh_run_clears(pkg, sim, out):
    pkg.train(_kw(sim, out, 6, checkpoint_every=3))
    assert os.path.exists(os.path.join(out, "checkpoint.npz"))
    pkg.train(_kw(sim, out, 4))
    assert not os.path.exists(os.path.join(out, "checkpoint.npz"))
    return [None]


def _sharded_file(pkg, sim, out):
    pkg.train_sharded(_kw(sim, out, 6, checkpoint_every=3))
    got = [_outcome(lambda: pkg.train(
        _kw(sim, out, 8, checkpoint_every=3, resume=True)))]
    os.rename(os.path.join(out, "checkpoint.npz"),
              os.path.join(out, "checkpoint.p0.npz"))
    got.append(_outcome(lambda: pkg.train(_kw(sim, out, 8, resume=True))))
    return got


SCENARIOS = {
    "resume_in_empty_dir": (_resume_in_empty_dir, [None]),
    "resume_over_outputs": (_resume_over_outputs, [ValueError]),
    "missing_bet": (_missing_bet, [OSError]),
    "wave_changed": (_layout_change(wave_size=1), [ValueError]),
    "block_size_changed": (_layout_change(block_size=32), [ValueError]),
    "trunc_markers_changed": (_layout_change(trunc_markers=True),
                              [ValueError]),
    "unstamped": (_unstamped, [ValueError]),
    "fresh_run_clears": (_fresh_run_clears, [None]),
    "sharded_file": (_sharded_file, [ValueError, ValueError]),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_guard_scenario_as_gmrm_tpu(sim_small, tmp_path, scenario):
    run, want = SCENARIOS[scenario]
    got = {pkg.name: run(pkg, sim_small, str(tmp_path / pkg.name))
           for pkg in (_Jax, _Port)}
    assert got["gmrm_tpu"] == got["gmrm_tpu_torch"] == want, got
