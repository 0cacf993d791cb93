"""Checkpoint/resume and the startup cache of the port on one device, on
the CPU (gmrm_tpu_torch/checkpoint.py, gmrm_tpu_torch/startup_cache.py,
runner.run_training).

- a resumed chain's .csv/.bet/.cpn are byte-equal to an uninterrupted
  one's, at W > 1 (the whole-sweep iteration) and at W = 1, from a
  checkpoint at an iteration that is not a thin boundary, with the rows
  written after it truncated; the state too, bit for bit;
- the port's own refusals: a resume under another seed, a gmrm_tpu file;
- the startup cache: a warm start's statistics and Gram cache bit-equal to
  a cold start's and its artifacts byte-equal; a changed geometry or phen
  file keys a new entry, and so does a same-size .bed with one middle
  byte edited and its mtime restored, which the JAX package's fingerprint
  (gmrm_tpu/runner.py:172-189) would serve from the stale entry.

The guard scenarios of tests/test_checkpoint.py, run through both packages,
are in tests/test_torch_checkpoint_parity.py; the sharded forms in
tests/test_torch_checkpoint_sharded.py.
"""

import hashlib
import os
import shutil

import numpy as np
import pytest
import torch

from gmrm_tpu.config import Options as JaxOptions
from gmrm_tpu.runner import hash_dataset_content
from gmrm_tpu.runner import run_training as jax_run_training
from gmrm_tpu_torch.config import Options, resolve_plan
from gmrm_tpu_torch.io.sim import simulate
from gmrm_tpu_torch.runner import (
    build_static, load_data, run_training, startup_cache,
)

torch.set_num_threads(2)

CPU = torch.device("cpu")
ARTIFACTS = (".bet", ".cpn", ".csv")


def _kw(sim, out_dir, iterations, **kw):
    base = dict(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                group_index_file=sim.gri, group_mixture_file=sim.grm,
                iterations=iterations, seed=7, out_dir=out_dir, block_size=16,
                output_thin_rate=2)
    base.update(kw)
    return base


def _opt(sim, out_dir, iterations, **kw):
    return Options(**_kw(sim, out_dir, iterations, **kw))


def _same_artifacts(sim, dir_a, dir_b):
    for ph in sim.phens:
        base = os.path.splitext(os.path.basename(ph))[0]
        for suffix in ARTIFACTS:
            a = open(os.path.join(dir_a, base + suffix), "rb").read()
            b = open(os.path.join(dir_b, base + suffix), "rb").read()
            assert a == b, f"{base}{suffix} differs"


@pytest.mark.parametrize("wave", [4, 1], ids=["w4", "w1"])
def test_resume_is_byte_equal_to_an_uninterrupted_chain(sim_small, tmp_path,
                                                        wave):
    """Checkpoint at iteration 7 (thin rate 2: not a record), the chain
    run on to 10 (records at 8 and 10 are stale), then resumed to 12: the
    artifacts and the final state equal those of 12 uninterrupted
    iterations, and the resumed call ran 5 iterations."""
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    ref = run_training(_opt(sim_small, full, 12, wave_size=wave),
                       device="cpu", verbose=False)
    run_training(_opt(sim_small, part, 10, wave_size=wave,
                      checkpoint_every=7), device="cpu", verbose=False)
    assert os.path.exists(os.path.join(part, "checkpoint.npz"))
    res = run_training(_opt(sim_small, part, 12, wave_size=wave,
                            checkpoint_every=7, resume=True),
                       device="cpu", verbose=False)
    assert res.iters_run == 5 and len(res.iter_seconds) == 5
    _same_artifacts(sim_small, full, part)
    for name in ("eps", "betas", "comp", "acum", "cass", "sigmag", "sigmae",
                 "pi_est", "mu"):
        assert torch.equal(getattr(ref.state, name),
                           getattr(res.state, name)), name
    np.testing.assert_array_equal(ref.beta_mean, res.beta_mean)


def test_resume_refuses_another_seed(sim_tiny, tmp_path):
    out = str(tmp_path / "o")
    run_training(_opt(sim_tiny, out, 4, block_size=8, checkpoint_every=2),
                 device="cpu", verbose=False)
    with pytest.raises(ValueError, match="--seed 7.*--seed 8"):
        run_training(_opt(sim_tiny, out, 6, block_size=8, seed=8,
                          resume=True), device="cpu", verbose=False)


def test_resume_refuses_a_gmrm_tpu_checkpoint(sim_tiny, tmp_path):
    """A checkpoint written by the JAX package carries a PRNG key and no
    format tag: the port refuses it with a message, whatever its layout."""
    out = str(tmp_path / "o")
    jax_run_training(JaxOptions(**_kw(sim_tiny, out, 4, block_size=8,
                                      wave_size=1, checkpoint_every=2)),
                     verbose=False)
    assert os.path.exists(os.path.join(out, "checkpoint.npz"))
    with pytest.raises(ValueError, match="gmrm_tpu checkpoint"):
        run_training(_opt(sim_tiny, out, 6, block_size=8, wave_size=1,
                          resume=True), device="cpu", verbose=False)


def _data(sim, opt):
    opt.load_group_mixtures()
    resolve_plan(opt, "cpu", sim.m)
    return load_data(opt)


def _static(sim, opt, cache):
    data = _data(sim, opt)
    return build_static(data, opt, CPU, startup_cache(data, opt)
                        if cache else None)


def test_warm_start_is_bit_equal_to_a_cold_start(sim_small, tmp_path,
                                                 capsys):
    """Cold then warm through run_training: one entry, the warm run says
    so, its artifacts are byte-equal; the warm statistics and Gram cache are
    torch.equal to a build without the cache."""
    cache = str(tmp_path / "cache")
    kw = dict(wave_size=4, cache_dir=cache)
    cold = run_training(_opt(sim_small, str(tmp_path / "cold"), 6, **kw),
                        device="cpu", verbose=False)
    assert [c.warm for c in cold.caches] == [False]
    entries = os.listdir(cache)
    assert len(entries) == 1 and entries[0].startswith("startup_")
    with np.load(os.path.join(cache, entries[0])) as z:
        assert set(z.files) == {"mave", "msig", "gram"}
    warm = run_training(_opt(sim_small, str(tmp_path / "warm"), 6, **kw),
                        device="cpu", verbose=True)
    assert [c.warm for c in warm.caches] == [True]
    assert f"INFO   : warm startup from {warm.caches[0].path}" in \
        capsys.readouterr().out
    assert os.listdir(cache) == entries
    _same_artifacts(sim_small, str(tmp_path / "cold"), str(tmp_path / "warm"))

    built = _static(sim_small, _opt(sim_small, "", 1, wave_size=4), False)
    loaded = _static(sim_small, _opt(sim_small, "", 1, **kw), True)
    assert loaded.gram_cache is not None
    for name in ("mave", "msig", "gram_cache"):
        assert torch.equal(getattr(built, name), getattr(loaded, name)), name


def test_cache_entry_keys(sim_small, tmp_path):
    """A W = 1 entry holds no Gram cache; another block size or wave, or
    another phen file, keys a new entry."""
    cache = str(tmp_path / "cache")

    def entry(**kw):
        opt = _opt(sim_small, "", 1, cache_dir=cache, **kw)
        c = startup_cache(_data(sim_small, opt), opt)
        return os.path.basename(c.path)

    base = entry(wave_size=4)
    assert entry(wave_size=4) == base
    assert len({base, entry(wave_size=4, block_size=32),
                entry(wave_size=1), entry(wave_size=4, trunc_markers=80),
                entry(wave_size=4, phen_files=sim_small.phens[:1])}) == 5
    _static(sim_small, _opt(sim_small, "", 1, wave_size=1, cache_dir=cache),
            True)
    with np.load(os.path.join(cache, entry(wave_size=1))) as z:
        assert set(z.files) == {"mave", "msig"}


def test_cache_misses_an_edited_bed_of_the_same_size(tmp_path):
    """One byte in the middle of the .bed changed, size and mtime kept: the
    JAX package's fingerprint does not change, the port's key does, and the
    warm start then rebuilds statistics that differ from the stale entry's."""
    sim = simulate(str(tmp_path / "d"), n=4000, m=4096, n_traits=1,
                   n_causal=16, h2=0.5, n_groups=1, na_rate=0.0, seed=3)
    cache = str(tmp_path / "cache")
    kw = dict(wave_size=1, block_size=64, cache_dir=cache)
    first = _static(sim, _opt(sim, "", 1, **kw), True)

    def jax_fingerprint():
        h = hashlib.sha256()
        hash_dataset_content(h, JaxOptions(**_kw(sim, "", 1)))
        return h.hexdigest()

    before = jax_fingerprint()
    st = os.stat(sim.bed)
    assert st.st_size > 3 << 20          # the middle lies outside both MiBs
    with open(sim.bed, "r+b") as fh:
        fh.seek(st.st_size // 2)
        byte = fh.read(1)
        fh.seek(st.st_size // 2)
        fh.write(bytes([byte[0] ^ 0xFF]))
    os.utime(sim.bed, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert jax_fingerprint() == before
    second = _static(sim, _opt(sim, "", 1, **kw), True)
    assert len(os.listdir(cache)) == 2
    assert not torch.equal(first.mave, second.mave)
    shutil.rmtree(cache)
    rebuilt = _static(sim, _opt(sim, "", 1, wave_size=1, block_size=64),
                      False)
    assert torch.equal(rebuilt.mave, second.mave)
    assert torch.equal(rebuilt.msig, second.msig)
