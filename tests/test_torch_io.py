"""The port's own copies of the NumPy-only modules (``Options``, the CLI
parser, the I/O readers and writers, the simulator) against the originals
in the JAX package, on the same files and the same command lines."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

import gmrm_tpu.cli as jcli
import gmrm_tpu.config as jconfig
import gmrm_tpu.io as jio
import gmrm_tpu.io.bed as jbed
import gmrm_tpu.io.sim as jsim
import gmrm_tpu.io.writers as jwriters
import gmrm_tpu_torch.cli as tcli
import gmrm_tpu_torch.config as tconfig
import gmrm_tpu_torch.io as tio
import gmrm_tpu_torch.io.bed as tbed
import gmrm_tpu_torch.io.sim as tsim
import gmrm_tpu_torch.io.writers as twriters


def _fields(cls):
    return {f.name: (f.type, f.default, f.default_factory)
            for f in dataclasses.fields(cls)}


def test_options_fields_defaults_and_priors_equal():
    assert _fields(tconfig.Options) == _fields(jconfig.Options)
    for name in ("V0E", "S02E", "V0G", "S02G"):
        assert getattr(tconfig, name) == getattr(jconfig, name)
    assert issubclass(tconfig.OptionsError, ValueError)
    # What asks JAX for its backend, and the TPU-only limit, stay behind.
    assert not hasattr(tconfig.Options, "resolve_compute_plan")
    assert not hasattr(tconfig.Options, "check_group_limit")


TRAIN = ["--bed-file", "a.bed", "--dim-file", "a.dim", "--phen-files",
         "p1.phen,p2.phen", "--group-index-file", "a.gri",
         "--group-mixture-file", "a.grm"]


@pytest.mark.parametrize("extra", [
    [],
    ["--iterations", "50", "--seed", "7", "--out-dir", "o",
     "--output-thin-rate", "5", "--verbosity", "2", "--trunc-markers", "9"],
    ["--block-size", "64", "--wave-size", "16", "--shuffle-markers", "0"],
    ["--use-pallas", "0", "--mimic-hydra", "--S", "ignored"],
    ["--use-pallas", "1", "--wave-size", "1"],
    ["--predict", "--bim-file", "x.bim", "--ref-bim-file", "y.bim"],
    ["--resume", "--checkpoint-every", "5", "--cache-dir", "c"],
    ["--devices", "4", "--dtype", "float64"],
], ids=lambda e: "_".join(x.lstrip("-") for x in e[:3:2]) or "defaults")
def test_parsers_give_equal_options(extra):
    argv = TRAIN + extra
    want = jcli.options_from_args(jcli.build_parser().parse_args(argv))
    got = tcli.options_from_args(tcli.build_parser().parse_args(argv))
    assert isinstance(got, tconfig.Options)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("argv", [
    ["--no-such-flag"], TRAIN + ["--dtype", "float16"],
    TRAIN + ["--iterations", "many"],
], ids=["unknown", "dtype", "int"])
def test_parsers_refuse_the_same_command_lines(argv, capsys):
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(argv)
    capsys.readouterr()


@pytest.mark.parametrize("change,match", [
    (dict(bed_file=""), "no bed file"),
    (dict(dim_file=""), "no dim file"),
    (dict(phen_files=[]), "no phen file"),
    (dict(group_mixture_file=""), "BOTH"),
    (dict(seed=-1), "--seed"),
    (dict(iterations=0), "--iterations"),
    (dict(output_thin_rate=0), "--output-thin-rate"),
    (dict(block_size=0), "--block-size"),
    (dict(wave_size=0), "--wave-size"),
    (dict(predict=True), "--bim-file"),
    (dict(mimic_hydra=True), "--mimic-hydra"),
], ids=lambda c: next(iter(c)) if isinstance(c, dict) else None)
def test_validate_refuses_what_the_original_refuses(sim_small, change,
                                                    match):
    base = dict(bed_file=sim_small.bed, dim_file=sim_small.dim,
                phen_files=list(sim_small.phens),
                group_index_file=sim_small.gri,
                group_mixture_file=sim_small.grm)
    tconfig.Options(**base).validate()
    base.update(change)
    with pytest.raises(jconfig.OptionsError) as want:
        jconfig.Options(**base).validate()
    with pytest.raises(tconfig.OptionsError, match=match) as got:
        tconfig.Options(**base).validate()
    assert str(got.value) == str(want.value)


def test_readers_return_equal_arrays(sim_small):
    n, m = jio.read_dim(sim_small.dim)
    assert tio.read_dim(sim_small.dim) == (n, m)
    np.testing.assert_array_equal(
        tio.read_bed(sim_small.bed, n, m), jio.read_bed(sim_small.bed, n, m))
    np.testing.assert_array_equal(
        tio.read_bed(sim_small.bed, n, m, 10, 30),
        jio.read_bed(sim_small.bed, n, m, 10, 30))
    assert tio.bed_bytes_per_marker(n) == jio.bed_bytes_per_marker(n)
    assert tbed.MISSING_BYTE == jbed.MISSING_BYTE
    for fp in sim_small.phens:
        got, want = tio.read_phen(fp, n), jio.read_phen(fp, n)
        assert (got.nonas, got.nas) == (want.nonas, want.nas) and got.nas > 0
        for f in ("values", "mask", "epsilon0"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(got.na_vector_padded(),
                                      want.na_vector_padded())
        np.testing.assert_array_equal(got.epsilon_padded(),
                                      want.epsilon_padded())
    cva, cvai = jio.read_group_mixtures(sim_small.grm)
    got_cva, got_cvai = tio.read_group_mixtures(sim_small.grm)
    np.testing.assert_array_equal(got_cva, cva)
    np.testing.assert_array_equal(got_cvai, cvai)
    np.testing.assert_array_equal(
        tio.read_group_index(sim_small.gri, cva.shape[0]),
        jio.read_group_index(sim_small.gri, cva.shape[0]))
    assert tio.read_bim_ids(sim_small.bim) == jio.read_bim_ids(sim_small.bim)
    opt = tconfig.Options(group_mixture_file=sim_small.grm)
    opt.load_group_mixtures()
    np.testing.assert_array_equal(opt.cva, cva)
    assert (opt.n_groups, opt.n_mixtures) == cva.shape


def test_readers_refuse_malformed_files(tmp_path, sim_small):
    n, m = jio.read_dim(sim_small.dim)
    bad = tmp_path / "bad.bed"
    bad.write_bytes(b"\x00\x00\x00" + bytes(m * tio.bed_bytes_per_marker(n)))
    short = tmp_path / "short.bed"
    short.write_bytes(b"\x6c\x1b\x01")
    phen = tmp_path / "bad.phen"
    phen.write_text("f i 1.0\nf i oops\n")
    for io in (jio, tio):
        with pytest.raises(IOError, match="bad magic"):
            io.read_bed(str(bad), n, m)
        with pytest.raises(IOError, match="too small"):
            io.read_bed(str(short), n, m)
        with pytest.raises(IOError, match="numeric value"):
            io.read_phen(str(phen), 2)
        with pytest.raises(IOError, match="exceeds the number of groups"):
            io.read_group_index(sim_small.gri, 1)


@pytest.mark.parametrize("kw", [
    dict(n=57, m=24, n_traits=1, n_causal=8, n_groups=1, na_rate=0.0),
    dict(n=402, m=96, n_traits=2, n_causal=24, n_groups=2, na_rate=0.03,
         mixtures=np.array([0.0, 0.001, 0.01, 0.05])),
    dict(n=120, m=40, n_traits=2, n_causal=10, n_groups=2, na_rate=0.02,
         ld_rho=0.9),
], ids=["tiny", "small_na", "ld"])
def test_simulate_writes_identical_files(tmp_path, kw):
    want = jsim.simulate(str(tmp_path / "jax"), h2=0.5, seed=99, **kw)
    got = tsim.simulate(str(tmp_path / "torch"), h2=0.5, seed=99, **kw)
    names = sorted(os.listdir(want.out_dir))
    assert names == sorted(os.listdir(got.out_dir)) and len(names) >= 6
    match, mismatch, errors = filecmp.cmpfiles(want.out_dir, got.out_dir,
                                               names, shallow=False)
    assert (mismatch, errors) == ([], []) and match == names
    np.testing.assert_array_equal(got.beta_true, want.beta_true)
    np.testing.assert_array_equal(got.h2_realized, want.h2_realized)


def test_simulate_chunked_route_is_identical(tmp_path, monkeypatch):
    """Above INMEM_LIMIT both simulators stream marker chunks."""
    monkeypatch.setattr(jsim, "INMEM_LIMIT", 1000)
    monkeypatch.setattr(tsim, "INMEM_LIMIT", 1000)
    kw = dict(n=90, m=64, n_traits=2, n_causal=16, h2=0.5, n_groups=2,
              na_rate=0.02, seed=5)
    want = jsim.simulate(str(tmp_path / "jax"), **kw)
    got = tsim.simulate(str(tmp_path / "torch"), **kw)
    names = sorted(os.listdir(want.out_dir))
    _, mismatch, errors = filecmp.cmpfiles(want.out_dir, got.out_dir, names,
                                           shallow=False)
    assert (mismatch, errors) == ([], [])


def test_writers_bytes_read_back_by_the_original(tmp_path):
    rng = np.random.default_rng(3)
    m = 37
    for kind, dtype in (("f8", np.float64), ("i4", np.int32)):
        recs = [(it, (rng.normal(size=m) * 5).astype(dtype))
                for it in (5, 10, 15)]
        paths = {}
        for name, mod in (("jax", jwriters), ("torch", twriters)):
            paths[name] = str(tmp_path / f"{name}.{kind}")
            w = mod.HistoryWriter(paths[name], m, kind)
            for rec, (it, row) in enumerate(recs):
                w.write_record(it, row, rec=rec)
        assert filecmp.cmp(paths["jax"], paths["torch"], shallow=False)
        its, rows = jwriters.read_history(paths["torch"], kind)
        assert list(its) == [5, 10, 15]
        np.testing.assert_array_equal(rows, np.stack([r for _, r in recs]))
        its2, rows2 = twriters.read_history(paths["jax"], kind)
        np.testing.assert_array_equal(its2, its)
        np.testing.assert_array_equal(rows2, rows)
        assert twriters.history_mtot(paths["jax"]) == m

    sigmag = np.array([0.21, 0.0])
    pi = rng.dirichlet(np.ones(4), size=2)
    rows = [mod.format_csv_record(7, sigmag, 0.55, 12, pi)
            for mod in (jwriters, twriters)]
    assert rows[0] == rows[1]
    for name, mod in (("jax", jwriters), ("torch", twriters)):
        for rec in range(3):
            mod.write_csv_record(str(tmp_path / f"{name}.csv"), rec, rows[0])
    assert filecmp.cmp(tmp_path / "jax.csv", tmp_path / "torch.csv",
                       shallow=False)
    assert (twriters.format_mlma_line("rs1", 3, 4, 0.1, 0.2, 0.3, 0.4)
            == jwriters.format_mlma_line("rs1", 3, 4, 0.1, 0.2, 0.3, 0.4))
