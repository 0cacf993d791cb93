"""The port's training path end to end on the CPU: run_training and the
CLI, artifacts, chain quality, the JAX-free import, the exact serial (W=1)
runs, a marker-sharded run through the CLI and the options the ported
slices refuse or, since they were ported, take."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gmrm_tpu.config import Options
from gmrm_tpu.io.writers import read_history
from gmrm_tpu_torch import cli
from gmrm_tpu_torch.runner import run_training

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _opt(sim, out_dir, **kw):
    base = dict(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                group_index_file=sim.gri, group_mixture_file=sim.grm,
                iterations=30, seed=42, out_dir=out_dir, block_size=32,
                wave_size=8, output_thin_rate=3)
    base.update(kw)
    return Options(**base)


def test_run_training_cpu_chain(sim_medium, tmp_path):
    """30 iterations at B=32, W=8: artifacts read back, h2 heads toward
    the simulated value and the posterior means track the true effects
    (the criteria of .claude/skills/verify/SKILL.md)."""
    out = str(tmp_path / "out")
    res = run_training(_opt(sim_medium, out), device="cpu", verbose=False)
    m = sim_medium.m
    T = len(sim_medium.phens)
    assert res.iters_run == 30 and len(res.iter_seconds) == 30
    # CPU tensors take the plain versions, which launch no kernel.
    assert set(res.kernel_launches.values()) == {0}
    for t, ph in enumerate(sim_medium.phens):
        base = os.path.join(out, os.path.splitext(os.path.basename(ph))[0])
        its, bet = read_history(base + ".bet", "f8")
        _, cpn = read_history(base + ".cpn", "i4")
        assert list(its) == list(range(3, 31, 3))
        assert bet.shape == (10, m) and cpn.shape == (10, m)
        assert np.isfinite(bet).all() and cpn.min() >= 0 and cpn.max() <= 3
        rows = open(base + ".csv").read().splitlines()
        assert len(rows) == 10 and len({len(r) for r in rows}) == 1
        np.testing.assert_allclose(bet.mean(0), res.beta_mean[t], rtol=1e-12)
        # 0.90-0.93 over chain seeds 42, 1 and 2 on this fixture.
        r = np.corrcoef(res.beta_mean[t], sim_medium.beta_true[:, t])[0, 1]
        assert r > 0.85, r
    sg = res.state.sigmag.sum(dim=1).numpy()
    se = res.state.sigmae.numpy()
    h2 = sg / (sg + se)
    assert T == 2
    np.testing.assert_allclose(h2, sim_medium.h2_realized, atol=0.1)


def test_import_and_train_without_jax(sim_tiny, tmp_path):
    """gmrm_tpu_torch never imports jax, flax or anything of gmrm_tpu: a
    meta-path hook makes each of those imports raise, and the port still
    imports (its predict mode and tools script too), parses a command line
    and trains on the CPU, on one device and marker-sharded over two
    shards."""
    code = f"""
import sys
BLOCKED = ('jax', 'jaxlib', 'flax', 'gmrm_tpu')
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import gmrm_tpu_torch, gmrm_tpu_torch.cli, gmrm_tpu_torch.io.sim
import gmrm_tpu_torch.predict, gmrm_tpu_torch.tools
from gmrm_tpu_torch.cli import build_parser, options_from_args
from gmrm_tpu_torch.runner import run_training
opt = options_from_args(build_parser().parse_args([
    '--bed-file', {sim_tiny.bed!r}, '--dim-file', {sim_tiny.dim!r},
    '--phen-files', {",".join(sim_tiny.phens)!r},
    '--group-index-file', {sim_tiny.gri!r},
    '--group-mixture-file', {sim_tiny.grm!r}, '--iterations', '2',
    '--seed', '1', '--out-dir', {str(tmp_path)!r}, '--block-size', '8',
    '--wave-size', '8']))
res = run_training(opt, device='cpu', verbose=False)
from gmrm_tpu_torch.parallel.runner import run_training_sharded
sharded = run_training_sharded(opt, n_devices=2, device='cpu', verbose=False)
assert len(sharded.state) == 2
assert not any(m.split('.')[0] in BLOCKED for m in sys.modules)
print('OK', res.iters_run, sharded.iters_run)
"""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "OK 2 2" in proc.stdout


@pytest.mark.parametrize("flags", [
    # Predict and float64 are ported: predict at float64 on the .bet files
    # of a float64 run.
    ["--predict", "--bim-file", "x.bim", "--ref-bim-file", "y.bim",
     "--dtype", "float64"],
    ["--resume"],
    ["--checkpoint-every", "5"],
    ["--cache-dir", "cache"],
    ["--dtype", "float64"],
], ids=lambda f: f[0])
def test_cli_refuses_uncovered_options(sim_tiny, tmp_path, flags):
    """Every option this test once saw refused is ported: the command line
    takes --dtype float64 (a W=1 float64 chain, other bytes than the
    float32 chain of the same seed; predict at float64 writes the
    .mlma), --resume, --checkpoint-every and --cache-dir, and the run
    writes its chain, checkpoint or startup cache, or resumes a chain from
    one.  (--dtype float64 with an explicit --wave-size > 1 trains the
    float64 wave path: tests/test_torch_float64_wave.py.)"""
    out = str(tmp_path / "out")
    argv = ["--bed-file", sim_tiny.bed, "--dim-file", sim_tiny.dim,
            "--phen-files", ",".join(sim_tiny.phens),
            "--group-index-file", sim_tiny.gri,
            "--group-mixture-file", sim_tiny.grm, "--iterations", "5",
            "--block-size", "8", "--out-dir", out, "--verbosity", "-1"]
    flags = [str(tmp_path / f) if f == "cache"
             else sim_tiny.bim if f.endswith(".bim") else f for f in flags]
    if flags[0] == "--predict":
        assert cli.main(argv + ["--dtype", "float64"], device="cpu") == 0
        assert cli.main(argv + flags, device="cpu") == 0
        with open(os.path.join(out, "test1.mlma")) as fh:
            lines = fh.read().splitlines()
        assert len(lines) == sim_tiny.m
        assert [int(ln.split()[1]) for ln in lines] == list(range(sim_tiny.m))
        return
    if flags == ["--resume"]:
        assert cli.main(argv + ["--iterations", "3", "--checkpoint-every",
                                "3"], device="cpu") == 0
    assert cli.main(argv + flags, device="cpu") == 0
    its, _ = read_history(os.path.join(out, "test1.bet"), "f8")
    assert list(its) == [1, 2, 3, 4, 5]
    if flags[0] == "--cache-dir":
        assert [f[:8] for f in os.listdir(flags[1])] == ["startup_"]
    elif flags[0] == "--dtype":
        f32 = str(tmp_path / "f32")
        argv[argv.index(out)] = f32
        assert cli.main(argv, device="cpu") == 0
        _, b64 = read_history(os.path.join(out, "test1.bet"), "f8")
        _, b32 = read_history(os.path.join(f32, "test1.bet"), "f8")
        assert np.isfinite(b64).all() and not np.array_equal(b64, b32)
    else:
        assert os.path.exists(os.path.join(out, "checkpoint.npz"))


def test_cli_trains_and_refuses_missing_cuda(sim_tiny, tmp_path):
    argv = ["--bed-file", sim_tiny.bed, "--dim-file", sim_tiny.dim,
            "--phen-files", ",".join(sim_tiny.phens),
            "--group-index-file", sim_tiny.gri,
            "--group-mixture-file", sim_tiny.grm, "--iterations", "2",
            "--block-size", "8", "--wave-size", "8",
            "--out-dir", str(tmp_path), "--verbosity", "-1"]
    assert cli.main(argv, device="cpu") == 0
    assert os.path.exists(tmp_path / "test1.bet")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)
    # Too few blocks for the auto wave: the plan falls back to W=1.
    i = argv.index("--wave-size")
    assert cli.main(argv[:i] + argv[i + 2:], device="cpu") == 0


def test_cli_trains_sharded(sim_tiny, tmp_path):
    """--devices 2 goes to the sharded runner, both shards on the one
    device, and writes the chain in the original marker order."""
    argv = ["--bed-file", sim_tiny.bed, "--dim-file", sim_tiny.dim,
            "--phen-files", ",".join(sim_tiny.phens),
            "--group-index-file", sim_tiny.gri,
            "--group-mixture-file", sim_tiny.grm, "--iterations", "3",
            "--block-size", "4", "--wave-size", "4", "--devices", "2",
            "--out-dir", str(tmp_path), "--verbosity", "-1"]
    assert cli.main(argv, device="cpu") == 0
    its, bet = read_history(str(tmp_path / "test1.bet"), "f8")
    _, cpn = read_history(str(tmp_path / "test1.cpn"), "i4")
    assert list(its) == [1, 2, 3] and bet.shape == (3, sim_tiny.m)
    assert np.isfinite(bet).all() and cpn.shape == bet.shape
    assert len(open(tmp_path / "test1.csv").read().splitlines()) == 3


@pytest.mark.parametrize("flags", [
    ["--wave-size", "1", "--block-size", "8"],
    ["--block-size", "12"],          # no wave of 32/16/8 divides it
    ["--use-pallas", "0", "--block-size", "8"],
], ids=["wave1", "block12", "no_pallas"])
def test_cli_trains_exact_serial(sim_tiny, tmp_path, flags):
    """Flags that resolve to W=1 train through the exact serial sweep and
    write the chain in the original marker order."""
    argv = ["--bed-file", sim_tiny.bed, "--dim-file", sim_tiny.dim,
            "--phen-files", ",".join(sim_tiny.phens),
            "--group-index-file", sim_tiny.gri,
            "--group-mixture-file", sim_tiny.grm, "--iterations", "3",
            "--out-dir", str(tmp_path), "--verbosity", "-1"] + flags
    assert cli.main(argv, device="cpu") == 0
    its, bet = read_history(str(tmp_path / "test1.bet"), "f8")
    assert list(its) == [1, 2, 3] and bet.shape == (3, sim_tiny.m)
    assert np.isfinite(bet).all()


def test_verbosity_2_prints_the_phenotype_na_lines(sim_small, tmp_path,
                                                   capsys):
    """At --verbosity 2 the port prints one 'has <nas> NAs and <nonas>
    non-NAs.' line per phenotype after the load time, the same lines as
    gmrm_tpu's run_training, on a fixture with phenotype NAs."""
    from gmrm_tpu.runner import run_training as jax_run_training

    def na_lines(run, **kw):
        opt = _opt(sim_small, "", iterations=1, wave_size=1, verbosity=2)
        run(opt, verbose=True, **kw)
        lines = capsys.readouterr().out.splitlines()
        load = next(i for i, s in enumerate(lines)
                    if s.startswith("INFO   : time to load"))
        got = [s for s in lines if " NAs and " in s]
        assert lines[load + 1:load + 1 + len(got)] == got
        return got

    port = na_lines(run_training, device="cpu")
    assert len(port) == len(sim_small.phens)
    assert all(s.startswith("INFO   : ") and s.endswith(" non-NAs.")
               for s in port)
    assert port == na_lines(jax_run_training)
    assert any(" 0 NAs" not in s for s in port)
