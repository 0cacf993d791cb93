"""The port's predict mode (gmrm_tpu_torch/predict.py, ops/predict_sums.py)
and its tools script against the JAX package, on the CPU.

- ``predict_sums_plain`` against ``_chunked_predict_sums``: xtx bit-equal
  (a sum of integers below 2^24), xty within ``XTY_RTOL * sum|val*y| +
  XTY_ATOL`` (float32 sums in another order), on ``sim_small`` and on a
  panel of N=203 (mb=51, no multiple of 4 or 16) with 2% NAs and one
  all-missing marker, unpadded and at the kernel's 16-byte row pitch;
- the host stage bit for bit: given the JAX package's own sums, the
  port's ``.mlma`` is byte-identical to JAX ``run_predict``'s, with a
  reference bim that drops and reorders markers;
- end to end on the CPU against JAX: ids and line layout exact, fields
  within the tolerance the xty bound gives each of them;
- the port's own layouts: ``--devices 2``, a bed in chunks and two gloo
  processes give the bytes of one process;
- the ``.bet`` checks, the command line (the training-only flags ignored,
  its stdout at ``--verbosity -1`` equal to the JAX CLI's) and
  ``gmrm-tpu-torch-tools``.

The CUDA kernel is held against ``predict_sums_plain`` on the card by
chip_smoke.py.
"""

import io
import os
import struct
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import gmrm_tpu.cli as jcli
import gmrm_tpu.predict as jpredict
import gmrm_tpu.tools as jtools
from gmrm_tpu.config import Options as JaxOptions
from gmrm_tpu_torch import cli
from gmrm_tpu_torch import predict as tpredict
from gmrm_tpu_torch import tools as ttools
from gmrm_tpu_torch.config import Options, SliceNotCovered, check_slice
from gmrm_tpu_torch.io.bed import MISSING_BYTE, read_bed
from gmrm_tpu_torch.io.grouping import read_dim
from gmrm_tpu_torch.io.phen import read_phen
from gmrm_tpu_torch.io.sim import simulate
from gmrm_tpu_torch.io.writers import MLMA_LINE_LEN
from gmrm_tpu_torch.ops.decode import decode_planes, to_phase_planes
from gmrm_tpu_torch.ops.predict_sums import (
    pad_columns, pitch_of, predict_sums, predict_sums_plain,
)
from gmrm_tpu_torch.runner import run_training

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
XTY_RTOL, XTY_ATOL = 1e-5, 1e-6
DEAD = 8            # the all-missing marker of the N=203 panel (kept)


@pytest.fixture(scope="module")
def odd(tmp_path_factory):
    """N=203 (mb=51), 40 markers, 2 traits with 2% NAs; marker DEAD is
    all 0x55 (every code missing)."""
    sim = simulate(str(tmp_path_factory.mktemp("odd")), n=203, m=40,
                   n_traits=2, n_causal=8, h2=0.5, na_rate=0.02, seed=11)
    mb = (203 + 3) // 4
    with open(sim.bed, "r+b") as fh:
        fh.seek(3 + DEAD * mb)
        fh.write(bytes([MISSING_BYTE]) * mb)
    return sim


@pytest.fixture(params=["sim_small", "odd"])
def panel(request):
    return request.getfixturevalue(request.param)


def _inputs(sim, trait=0):
    """The bed, and one trait's na and y planes as run_predict makes them:
    float32 from the float64 host vectors."""
    n, m = read_dim(sim.dim)
    ph = read_phen(sim.phens[trait], n)
    na = to_phase_planes(ph.na_vector_padded()).astype(np.float32)
    y = to_phase_planes(ph.epsilon_padded()).astype(np.float32)
    return read_bed(sim.bed, n, m), na, y


def _xty_bound(bed, na, y):
    """XTY_RTOL * sum|val*y| + XTY_ATOL per marker, in float64."""
    a, _ = decode_planes(torch.from_numpy(bed), dtype=torch.float64)
    val = a.numpy() * na
    return XTY_RTOL * np.abs(val * y).sum(axis=(1, 2)) + XTY_ATOL


def _jax_sums(bed, na, y):
    xtx, xty = jpredict._chunked_predict_sums(
        bed, jnp.asarray(na), jnp.asarray(y), dtype=jnp.float32)
    return np.asarray(xtx), np.asarray(xty)


def test_plain_sums_against_jax(panel):
    bed, na, y = _inputs(panel)
    want_xtx, want_xty = _jax_sums(bed, na, y)
    bound = _xty_bound(bed, na, y)
    L = pitch_of(bed.shape[1])
    for b, n_, y_ in ((bed, na, y),
                      (pad_columns(bed, L, MISSING_BYTE),
                       pad_columns(na, L, 0.0), pad_columns(y, L, 0.0))):
        xtx, xty = predict_sums(*map(torch.from_numpy, (b, n_, y_)))
        np.testing.assert_array_equal(xtx.numpy(), want_xtx)
        assert (np.abs(xty.numpy() - want_xty) <= bound).all()
    if panel.n == 203:
        assert xtx[DEAD] == 0 and xty[DEAD] == 0
    # Chunks of 7 markers: the same bits as chunks of 512.
    again = predict_sums_plain(*map(torch.from_numpy, (bed, na, y)), chunk=7)
    np.testing.assert_array_equal(again[0].numpy(), xtx.numpy())


def _fake_bet(path, mtot, records=3):
    """A .bet history of ``records`` records of ``mtot`` betas; predict
    reads only its header."""
    with open(path, "wb") as fh:
        fh.write(struct.pack("<I", mtot))
        for r in range(records):
            fh.write(struct.pack("<I", r + 1))
            fh.write(np.zeros(mtot, "<f8").tobytes())


def _ref_bim(sim, path):
    """The panel's bim without every fifth marker, the rest in reverse
    order, and one id that the panel lacks: excluded lines, and rmglo
    differing from mglo."""
    lines = open(sim.bim).read().splitlines()
    kept = [ln for i, ln in enumerate(lines) if i % 5 != 2][::-1]
    kept.insert(3, "1 rs_not_in_panel 0 1 A G")
    with open(path, "w") as fh:
        fh.write("\n".join(kept) + "\n")
    return len(kept)


def _setup(sim, out, ref_bim=None):
    """Fake .bet files framed by the reference bim in ``out``; returns the
    two packages' Options (the JAX one on one device)."""
    os.makedirs(out, exist_ok=True)
    ref = sim.bim
    mtot = sim.m
    if ref_bim:
        mtot = _ref_bim(sim, ref_bim)
        ref = ref_bim
    for p in sim.phens:
        _fake_bet(os.path.join(out, os.path.basename(p)[:-5] + ".bet"), mtot)
    kw = dict(bed_file=sim.bed, dim_file=sim.dim, phen_files=list(sim.phens),
              bim_file=sim.bim, ref_bim_file=ref, out_dir=out, predict=True)
    return Options(**kw), JaxOptions(**kw, n_devices=1)


def _mlmas(sim, out):
    return [open(os.path.join(out, os.path.basename(p)[:-5] + ".mlma"),
                 "rb").read() for p in sim.phens]


def test_host_stage_bytes_equal_jax(panel, tmp_path, monkeypatch, capsys):
    """The port's run_predict, fed the JAX package's own sums, writes the
    bytes and the WARNING lines of JAX run_predict."""
    mb = (panel.n + 3) // 4
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    opt_t, _ = _setup(panel, out_t, str(tmp_path / "ref.bim"))
    _, opt_j = _setup(panel, out_j, str(tmp_path / "ref.bim"))

    def jax_sums(bed, na, y):
        xtx, xty = _jax_sums(bed.numpy()[:, :mb], na.numpy()[:, :mb],
                             y.numpy()[:, :mb])
        return torch.tensor(xtx), torch.tensor(xty)

    monkeypatch.setattr(tpredict, "predict_sums", jax_sums)
    tpredict.run_predict(opt_t, device="cpu")
    said_t = capsys.readouterr().out
    jpredict.run_predict(opt_j)
    said_j = capsys.readouterr().out
    assert said_t.replace(out_t, out_j) == said_j
    assert said_t.count("excluded -- no match") == len(panel.phens) * len(
        range(2, panel.m, 5))
    for got, want in zip(_mlmas(panel, out_t), _mlmas(panel, out_j)):
        assert got == want
        lines = got.decode().splitlines(keepends=True)
        assert all(len(ln) == MLMA_LINE_LEN for ln in lines)
        assert len(lines) == panel.m - len(range(2, panel.m, 5))
        if panel.n == 203:
            dead = [ln.split() for ln in lines if int(ln.split()[1]) == DEAD]
            assert dead and dead[0][3:] == ["nan"] * 4


def _parse(blob):
    rows = [ln.split() for ln in blob.decode().splitlines()]
    ids = [(r[0], int(r[1]), int(r[2])) for r in rows]
    return ids, np.array([[float(v) for v in r[3:]] for r in rows])


def test_end_to_end_cpu_against_jax(panel, tmp_path, capsys):
    """ids, mglo, rmglo and the line count exact; beta, t, se and p within
    what the xty bound allows each (se = sqrt(sigma/xtx) does not depend
    on xty; |dp/dt| <= sqrt(2/pi)); NaN at the same places."""
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    opt_t, _ = _setup(panel, out_t)
    _, opt_j = _setup(panel, out_j)
    tpredict.run_predict(opt_t, device="cpu", verbose=False)
    jpredict.run_predict(opt_j, verbose=False)
    capsys.readouterr()
    n, _ = read_dim(panel.dim)
    for t, (got, want) in enumerate(zip(_mlmas(panel, out_t),
                                        _mlmas(panel, out_j))):
        assert len(got) == len(want) == panel.m * MLMA_LINE_LEN
        ids_t, f_t = _parse(got)
        ids_j, f_j = _parse(want)
        assert ids_t == ids_j
        bed, na, y = _inputs(panel, t)
        xtx, _ = _jax_sums(bed, na, y)
        xtx = xtx.astype(np.float64)
        d = _xty_bound(bed, na, y)
        ph = read_phen(panel.phens[t], n)
        sigma = float(ph.epsilon_padded() @ ph.epsilon_padded()) / ph.nonas
        with np.errstate(divide="ignore", invalid="ignore"):
            dt = d / np.sqrt(sigma * xtx)
            tol = np.stack([d / xtx, dt, np.full_like(d, 1e-12),
                            0.8 * dt], axis=1) + 2e-15
        np.testing.assert_array_equal(np.isnan(f_t), np.isnan(f_j))
        live = ~np.isnan(f_j)
        assert (np.abs(f_t - f_j)[live] <= tol[live]).all()


def test_devices_and_chunks_give_the_same_bytes(sim_small, tmp_path,
                                                monkeypatch, capsys):
    """--devices 2 in one process, and the bed in chunks of 10 markers
    (one sums call per chunk and trait), write the bytes of one pass."""
    base = ["--predict", "--bed-file", sim_small.bed, "--dim-file",
            sim_small.dim, "--phen-files", ",".join(sim_small.phens),
            "--bim-file", sim_small.bim, "--ref-bim-file", sim_small.bim]
    outs = {}
    for name, extra in (("one", []), ("two", ["--devices", "2"]),
                        ("chunks", [])):
        outs[name] = str(tmp_path / name)
        _setup(sim_small, outs[name])
        if name == "chunks":
            pitch = pitch_of((sim_small.n + 3) // 4)
            monkeypatch.setattr(tpredict, "BED_BUDGET", 10 * pitch)
            calls = []
            monkeypatch.setattr(tpredict, "predict_sums",
                                lambda *a: calls.append(1) or
                                predict_sums(*a))
        assert cli.main(base + ["--out-dir", outs[name]] + extra,
                        device="cpu") == 0
    capsys.readouterr()
    assert len(calls) == 10 * len(sim_small.phens)
    one = _mlmas(sim_small, outs["one"])
    assert _mlmas(sim_small, outs["two"]) == one
    assert _mlmas(sim_small, outs["chunks"]) == one


def test_two_gloo_processes_give_the_same_bytes(sim_small, tmp_path,
                                                capsys):
    """Two processes, each with half of the markers (reading its own bed
    slice and writing its own lines at their offsets), against one; the
    reference bim drops markers, so that line numbers are global prefix
    counts."""
    out_mp, out_sp = str(tmp_path / "mp"), str(tmp_path / "sp")
    ref = str(tmp_path / "ref.bim")
    opt, _ = _setup(sim_small, out_sp, ref)
    _setup(sim_small, out_mp, ref)
    tpredict.run_predict(opt, device="cpu", verbose=False)
    capsys.readouterr()
    argv = ["--predict", "--bed-file", sim_small.bed, "--dim-file",
            sim_small.dim, "--phen-files", ",".join(sim_small.phens),
            "--bim-file", sim_small.bim, "--ref-bim-file", ref,
            "--out-dir", out_mp]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_predict_worker.py"),
         str(rank), "2", f"file://{tmp_path}/rendezvous"] + argv,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-3000:]
        assert "PREDICT_RC 0" in text
    # Each process warns about its own excluded markers only.
    assert sum(t.count("excluded -- no match") for t in outs) == len(
        sim_small.phens) * len(range(2, sim_small.m, 5))
    assert _mlmas(sim_small, out_mp) == _mlmas(sim_small, out_sp)


@pytest.mark.parametrize("fault", ["mismatch", "ragged"])
def test_bet_checks_raise_as_jax(sim_small, tmp_path, fault):
    out = str(tmp_path / "o")
    opt_t, opt_j = _setup(sim_small, out)
    bet = os.path.join(out, "test1.bet")
    if fault == "mismatch":
        _fake_bet(bet, sim_small.m + 1)
    else:
        with open(bet, "ab") as fh:
            fh.write(b"\0" * 5)
    with pytest.raises(IOError) as want:
        jpredict.run_predict(opt_j, verbose=False)
    with pytest.raises(IOError) as got:
        tpredict.run_predict(opt_t, device="cpu", verbose=False)
    assert str(got.value) == str(want.value)
    assert ("Mismatch between expected and Mtot" in str(got.value)) == (
        fault == "mismatch")


def test_cli_predicts_without_group_mixtures(sim_small, tmp_path, capsys):
    """``python -m gmrm_tpu_torch --predict`` needs no group files (the
    group mixtures are not loaded in predict mode), and prints what the
    JAX package prints; ``--dtype float64`` still raises."""
    out = str(tmp_path / "o")
    _setup(sim_small, out)
    argv = ["--predict", "--bed-file", sim_small.bed, "--dim-file",
            sim_small.dim, "--phen-files", ",".join(sim_small.phens),
            "--bim-file", sim_small.bim, "--ref-bim-file", sim_small.bim,
            "--out-dir", out, "--group-mixture-file", "/no/such/file.grm"]
    assert cli.main(argv, device="cpu") == 0
    said = capsys.readouterr().out
    assert "Number of recorded iterations in .bet file: 3" in said
    assert f"wrote {sim_small.m} markers" in said
    with pytest.raises(SliceNotCovered, match="float64"):
        cli.main(argv + ["--dtype", "float64"], device="cpu")
    assert cli.main(argv[:3] + argv[5:], device="cpu") == 1   # no dim file


def _predict_argv(sim, out):
    return ["--predict", "--bed-file", sim.bed, "--dim-file", sim.dim,
            "--phen-files", ",".join(sim.phens), "--bim-file", sim.bim,
            "--ref-bim-file", sim.bim, "--out-dir", out]


def test_predict_ignores_training_only_flags(sim_small, tmp_path, capsys):
    """--resume, --checkpoint-every, --cache-dir and --use-pallas 0 do not
    concern predict (gmrm_tpu/predict.py reads none of them): the command
    line takes them, writes the .mlma bytes of a run without them and no
    cache or checkpoint file; --use-pallas 0 is not refused on CUDA in
    predict mode either."""
    plain, flagged = str(tmp_path / "plain"), str(tmp_path / "flagged")
    cache = str(tmp_path / "cache")
    for out in (plain, flagged):
        _setup(sim_small, out)
    assert cli.main(_predict_argv(sim_small, plain), device="cpu") == 0
    extra = ["--resume", "--checkpoint-every", "5", "--cache-dir", cache,
             "--use-pallas", "0"]
    assert cli.main(_predict_argv(sim_small, flagged) + extra,
                    device="cpu") == 0
    capsys.readouterr()
    assert _mlmas(sim_small, flagged) == _mlmas(sim_small, plain)
    assert not os.path.exists(cache)
    assert not [f for f in os.listdir(flagged) if f.startswith("checkpoint")]
    opt = cli.options_from_args(cli.build_parser().parse_args(
        _predict_argv(sim_small, flagged) + extra))
    check_slice(opt, "cuda")
    opt.predict = False
    with pytest.raises(SliceNotCovered, match="--use-pallas 0"):
        check_slice(opt, "cuda")


def test_cli_predict_stdout_at_verbosity_minus_one_as_jax(sim_small, tmp_path,
                                                          capsys):
    """At --verbosity -1 the port's predict prints what gmrm_tpu's CLI
    prints (it runs run_predict verbose whatever the verbosity), paths
    aside."""
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    for out in (out_t, out_j):
        _setup(sim_small, out)
    quiet = ["--verbosity", "-1"]
    assert cli.main(_predict_argv(sim_small, out_t) + quiet,
                    device="cpu") == 0
    said_t = capsys.readouterr().out
    assert jcli.main(_predict_argv(sim_small, out_j) + quiet) == 0
    said_j = capsys.readouterr().out
    assert said_t.count("INFO   :") == 2 * len(sim_small.phens)
    assert said_t.replace(out_t, out_j) == said_j


def test_tools_extract_nonzero_beta_as_jax(sim_small, tmp_path):
    """gmrm-tpu-torch-tools prints what gmrm-tpu-tools prints on one .bet of
    a short CPU training run, for a window that drops records at both
    ends."""
    opt = Options(bed_file=sim_small.bed, dim_file=sim_small.dim,
                  phen_files=[sim_small.phens[0]],
                  group_index_file=sim_small.gri,
                  group_mixture_file=sim_small.grm, iterations=8, seed=3,
                  out_dir=str(tmp_path), block_size=16, wave_size=1,
                  output_thin_rate=2)
    run_training(opt, device="cpu", verbose=False)
    argv = ["extract-nonzero-beta", str(tmp_path / "test1.bet"), "3", "6"]
    said = []
    for main in (ttools.main, jtools.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(argv) == 0
        said.append(buf.getvalue())
    assert said[0] == said[1]
    its = {int(ln.split()[0]) for ln in said[0].splitlines()}
    assert its == {4, 6}
    rows = ttools.extract_nonzero_beta(argv[1], 0, 100)
    assert {r[0] for r in rows} == {2, 4, 6, 8}
