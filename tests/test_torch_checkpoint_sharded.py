"""Checkpoint/resume and the startup cache of the port's marker-sharded
runner on the CPU (format v2 of gmrm_tpu_torch/checkpoint.py,
parallel/runner.run_training_sharded), with two gloo processes
(tests/torch_sharded_worker.py) against one.

- S = 2 saved by one process and resumed by two, and the reverse: the
  artifacts are byte-equal to an uninterrupted one-process chain (two
  shards' deltas sum to the same bits in either split); the checkpoint at
  7 is not a thin boundary and the rows written after it are truncated;
- S = 4 saved by one process and resumed by 2 x 2: the records before the
  checkpoint are byte-equal, the later ones agree within the float noise
  of 2 x 2 against 1 x 4 (tests/test_torch_sharded.py: the two layouts sum
  the four deltas in other groupings, so no chain of one is byte-equal to
  a chain of the other);
- a resume under another shard count and wave re-assembles the global
  state exactly at the resume point, and the shards share one residual;
- the newest incomplete save era falls back to the previous complete one;
- refusals: another seed, a single-device checkpoint;
- the per-shard startup cache: a start with one shard warm and one cold
  writes the bytes of an all-cold start.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gmrm_tpu.io.sim import simulate
from gmrm_tpu.io.writers import read_history
from gmrm_tpu_torch.config import Options
from gmrm_tpu_torch.parallel.mesh import marker_blocks
from gmrm_tpu_torch.parallel.runner import run_training_sharded
from gmrm_tpu_torch.runner import interleave_order, run_training

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ARTIFACTS = (".bet", ".cpn", ".csv")


@pytest.fixture(scope="module")
def mp_sim(tmp_path_factory):
    return simulate(str(tmp_path_factory.mktemp("ckmp")), n=400, m=300,
                    n_traits=2, n_causal=64, h2=0.5, n_groups=2,
                    na_rate=0.02, seed=7)


def _opt(sim, out_dir, iterations, **kw):
    """The options of tests/torch_sharded_worker.py."""
    base = dict(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                group_index_file=sim.gri, group_mixture_file=sim.grm,
                iterations=iterations, seed=42, out_dir=out_dir,
                block_size=16, wave_size=4, output_thin_rate=2)
    base.update(kw)
    return Options(**base)


def _one(sim, out, n_shards, iterations, **kw):
    return run_training_sharded(_opt(sim, out, iterations, **kw),
                                n_devices=n_shards, device="cpu",
                                verbose=False)


def _two_processes(sim, out, n_shards, tmp_path, iterations, every=0,
                   resume=False, cache="-"):
    worker = os.path.join(HERE, "torch_sharded_worker.py")
    init = f"file://{tmp_path}/rendezvous_{n_shards}_{int(resume)}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(rank), "2", init,
         os.path.dirname(sim.bed), out, str(n_shards), str(iterations),
         str(every), str(int(resume)), cache],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-3000:]
        assert "EPS_EQUAL" in text


def _read(out, name):
    return open(os.path.join(out, name), "rb").read()


@pytest.mark.parametrize("saver", ["one_process", "two_processes"])
def test_resume_across_a_process_split_is_byte_equal(mp_sim, tmp_path,
                                                     saver):
    """S = 2 as 1 x 2 and 2 x 1: the save by one split, checkpoint at 7 and
    the chain run on to 10, the resume to 12 by the other (with a startup
    cache warmed by the reference run, so each process finds its shard's
    entry); byte-equal to 12 uninterrupted iterations of one process."""
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    cache = str(tmp_path / "cache")
    _one(mp_sim, full, 2, 12, cache_dir=cache)
    assert len(os.listdir(cache)) == 2
    if saver == "one_process":
        _one(mp_sim, part, 2, 10, checkpoint_every=7)
        assert os.path.exists(os.path.join(part, "checkpoint.npz"))
        _two_processes(mp_sim, part, 2, tmp_path, 12, every=7, resume=True,
                       cache=cache)
    else:
        _two_processes(mp_sim, part, 2, tmp_path, 10, every=7)
        assert {"checkpoint.p0.npz", "checkpoint.p1.npz"} <= set(
            os.listdir(part))
        res = _one(mp_sim, part, 2, 12, checkpoint_every=7, resume=True,
                   cache_dir=cache)
        assert res.iters_run == 5 and all(c.warm for c in res.caches)
    assert len(os.listdir(cache)) == 2
    for t in (1, 2):
        for suffix in ARTIFACTS:
            name = f"test{t}{suffix}"
            assert _read(full, name) == _read(part, name), name


def test_resume_one_by_four_as_two_by_two(mp_sim, tmp_path):
    """S = 4 saved by one process (checkpoint at 7, chain on to 10) and
    resumed to 12 by 2 x 2: six records, the three before the checkpoint
    byte-equal to the uninterrupted 1 x 4 chain's, the rest within its
    float noise against 2 x 2 (tests/test_torch_sharded.py:669-692)."""
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    _one(mp_sim, full, 4, 12)
    _one(mp_sim, part, 4, 10, checkpoint_every=7)
    _two_processes(mp_sim, part, 4, tmp_path, 12, every=7, resume=True)
    for t in (1, 2):
        for kind, suffix in (("f8", ".bet"), ("i4", ".cpn")):
            its_f, d_f = read_history(os.path.join(full, f"test{t}{suffix}"),
                                      kind)
            its_p, d_p = read_history(os.path.join(part, f"test{t}{suffix}"),
                                      kind)
            assert list(its_p) == list(its_f) == [2, 4, 6, 8, 10, 12]
            np.testing.assert_array_equal(d_p[:3], d_f[:3])
            if kind == "f8":
                np.testing.assert_allclose(d_p, d_f, rtol=1e-3, atol=1e-5)
            else:
                assert (d_p != d_f).mean() < 0.01
        rows_f = _read(full, f"test{t}.csv").splitlines()
        rows_p = _read(part, f"test{t}.csv").splitlines()
        assert len(rows_p) == 6 and rows_p[:3] == rows_f[:3]


def _natural(res, n_shards, wave, m, name):
    """The global natural-order array ``name`` of a sharded run's states
    (block size 16; storage interleaved at W > 1)."""
    parts = []
    for st, (_, ln) in zip(res.state, marker_blocks(m, n_shards)):
        d = getattr(st, name)[:, :ln].numpy()
        if wave > 1:
            _, inv = interleave_order(ln, st.betas.shape[1] // 16)
            d = d[:, inv]
        parts.append(d)
    return np.concatenate(parts, axis=1)


@pytest.mark.parametrize("saved,resumed", [((4, 4), (2, 4)),
                                           ((2, 4), (4, 1))],
                         ids=["s4_to_s2", "s2_w4_to_s4_w1"])
def test_topology_change_reassembles_the_state(mp_sim, tmp_path, saved,
                                               resumed):
    """Saved at S shards and wave W, resumed under S' and W' with the
    iteration count at the checkpoint (no iteration runs): every marker's
    betas, comp and acum and the replicated leaves equal the saver's, and
    the resumed shards share one residual tensor."""
    out = str(tmp_path / "o")
    ref = _one(mp_sim, out, saved[0], 6, wave_size=saved[1],
               checkpoint_every=6)
    res = _one(mp_sim, out, resumed[0], 6, wave_size=resumed[1],
               resume=True)
    assert res.iters_run == 0 and len(res.state) == resumed[0]
    assert all(st.eps is res.state[0].eps for st in res.state)
    for name in ("betas", "comp", "acum"):
        np.testing.assert_array_equal(
            _natural(ref, *saved, mp_sim.m, name),
            _natural(res, *resumed, mp_sim.m, name), err_msg=name)
    for name in ("eps", "cass", "sigmag", "sigmae", "pi_est", "mu"):
        assert torch.equal(getattr(ref.state[0], name),
                           getattr(res.state[0], name)), name
    np.testing.assert_array_equal(ref.beta_mean, res.beta_mean)


def test_incomplete_era_falls_back_to_the_previous_save(mp_sim, tmp_path):
    """The newest save with one shard's slices gone no longer covers every
    marker: the resume takes the previous save (kept as *.prev.npz)."""
    out = str(tmp_path / "o")
    _one(mp_sim, out, 2, 6, checkpoint_every=3)
    ck = os.path.join(out, "checkpoint.npz")
    assert os.path.exists(os.path.join(out, "checkpoint.prev.npz"))
    with np.load(ck) as z:
        arrays = {k: z[k] for k in z.files}
    for f in ("betas", "comp", "acum"):
        del arrays[f"{f}_1"]
    arrays["starts"] = arrays["starts"][:1]
    np.savez(ck, **arrays)
    res = _one(mp_sim, out, 2, 8, checkpoint_every=3, resume=True)
    assert res.iters_run == 5


def test_sharded_refusals(mp_sim, tmp_path):
    out = str(tmp_path / "o")
    _one(mp_sim, out, 2, 4, checkpoint_every=2)
    with pytest.raises(ValueError, match="--seed 42.*--seed 43"):
        _one(mp_sim, out, 2, 6, seed=43, resume=True)
    run_training(_opt(mp_sim, out, 4, checkpoint_every=2), device="cpu",
                 verbose=False)
    with pytest.raises(ValueError, match="single-device runner"):
        _one(mp_sim, out, 2, 6, resume=True)


def test_mixed_warm_and_cold_start_is_byte_equal(mp_sim, tmp_path):
    """One shard's entry removed: that shard builds cold, the other loads
    warm, and the artifacts equal those of the all-cold start."""
    cache = str(tmp_path / "cache")
    cold = _one(mp_sim, str(tmp_path / "cold"), 2, 6, cache_dir=cache)
    assert [c.warm for c in cold.caches] == [False, False]
    os.remove(cold.caches[1].path)
    mixed = _one(mp_sim, str(tmp_path / "mixed"), 2, 6, cache_dir=cache)
    assert [c.warm for c in mixed.caches] == [True, False]
    assert os.path.exists(cold.caches[1].path)
    for t in (1, 2):
        for suffix in ARTIFACTS:
            name = f"test{t}{suffix}"
            assert _read(str(tmp_path / "cold"), name) == _read(
                str(tmp_path / "mixed"), name), name
