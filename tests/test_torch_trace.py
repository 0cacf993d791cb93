"""The port's spans and stamp reducers (gmrm_tpu_torch/trace.py) on the
CPU: the gate while no profiler records, the spans of each iteration path
and of a record under a CPU profiler, state bit-identical with tracing on
and off, the kernels' stamp reducers on hand-built buffers, and
``RunResult.iter_seconds``."""

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gmrm_tpu_torch import runner, trace
from gmrm_tpu_torch.config import Options, resolve_plan
from gmrm_tpu_torch.io.sim import simulate
from gmrm_tpu_torch.ops import scan_kernel, sweep_kernel
from gmrm_tpu_torch.parallel.runner import run_training_sharded
from gmrm_tpu_torch.sampler import gibbs
from gmrm_tpu_torch.sampler.dists import RngPlan

torch.set_num_threads(2)

B = 16
WHOLE = ["iteration", "draws", "pre", "sweep", "post"]
SERIAL = ["iteration", "intercept", "draws", "sweep", "hyper"]


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    return simulate(str(tmp_path_factory.mktemp("trace_sim")), n=120, m=96,
                    n_traits=2, n_causal=12, na_rate=0.05, seed=5)


def _setup(panel, out_dir, wave, thin=2):
    opt = Options(bed_file=panel.bed, dim_file=panel.dim,
                  phen_files=panel.phens, group_index_file=panel.gri,
                  group_mixture_file=panel.grm, iterations=4, seed=3,
                  out_dir=str(out_dir), block_size=B, wave_size=wave,
                  output_thin_rate=thin)
    opt.validate()
    opt.load_group_mixtures()
    resolve_plan(opt, "cpu", panel.m)
    data = runner.load_data(opt)
    static = runner.build_static(data, opt, "cpu")
    return opt, data, static


def _chain(panel, out_dir, wave):
    """(step, data, opt) of a fresh chain."""
    opt, data, static = _setup(panel, out_dir, wave)
    state = runner.init_sampler_state(data, opt, torch.device("cpu"))
    step = runner.iteration_step(state, static, RngPlan(opt.seed, "cpu"),
                                 opt)
    return step, data, opt


def _gmrm_events(prof):
    """(name without the prefix, start ns, end ns) of the gmrm. spans."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(trace.PREFIX):
            s = ev.start_ns()
            out.append((ev.name()[len(trace.PREFIX):], s,
                        s + ev.duration_ns()))
    return out


def test_span_without_profiler_is_the_shared_null_context(panel, tmp_path,
                                                          monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not trace.recording()
    assert trace.span("iteration") is trace.span("sweep")
    for wave in (8, 1):
        step, _, _ = _chain(panel, tmp_path / f"w{wave}", wave)
        step(1)
        step(2)


@pytest.mark.parametrize("wave, names", [(8, WHOLE), (1, SERIAL)],
                         ids=["whole_sweep", "serial"])
def test_one_iteration_gives_each_phase_span_once(panel, tmp_path,
                                                  monkeypatch, wave, names):
    # Two blocks a Gram run, so the W=1 sweep builds several runs.
    monkeypatch.setattr(gibbs, "gram_run_blocks", lambda *a: 2)
    step, data, opt = _chain(panel, tmp_path, wave)
    step(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(2)
    spans = _gmrm_events(prof)
    got = sorted(n for n, _, _ in spans)
    nblocks = data.m_pad // B
    grams = ["grams"] * (math.ceil(nblocks / 2) if wave == 1 else 0)
    assert got == sorted(names + grams)
    (_, lo, hi), = [s for s in spans if s[0] == "iteration"]
    assert all(lo <= s <= e <= hi for _, s, e in spans)
    sums = trace.span_summaries()
    assert sorted(sums) == sorted(set(names + grams))
    assert sums["iteration"]["calls"] == 1
    assert sums["iteration"]["host_ms"] >= sums["sweep"]["host_ms"] > 0
    assert trace.stamp_summaries() == {}                 # no kernel


def test_record_spans(panel, tmp_path):
    step, data, opt = _chain(panel, tmp_path, 8)
    state, aux = step(1)
    outputs = runner.OutputSet(opt, data)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        host = runner._host_record(state, data)
        outputs.write_thinned(0, 1, host, aux.m0.numpy(), data)
    assert sorted(n for n, _, _ in _gmrm_events(prof)) == [
        "record.fetch", "record.write"]
    assert sorted(trace.span_summaries()) == ["record.fetch", "record.write"]


def test_a_new_profiler_drops_the_last_stretch(panel, tmp_path):
    step, _, _ = _chain(panel, tmp_path, 8)
    with profile(activities=[ProfilerActivity.CPU]):
        step(1)
        step(2)
    step(3)
    with profile(activities=[ProfilerActivity.CPU]):
        step(4)
    assert trace.span_summaries()["iteration"]["calls"] == 1


def test_one_stamped_sweep_a_stretch():
    cpu = torch.device("cpu")

    def reduce(buf):
        return int(buf.sum())

    assert not trace.recording()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            assert trace.recording()
            buf = trace.sweep_stamps("k", (2, 3), cpu, reduce)
            assert buf.shape == (2, 3) and buf.dtype == torch.int64
            assert trace.sweep_stamps("k", (2, 3), cpu, reduce) is None
            buf.fill_(1)
        assert trace.stamp_summaries() == {"k": 6}
        trace.recording()            # the profiler stopped


@pytest.mark.parametrize("wave", [8, 1], ids=["whole_sweep", "serial"])
def test_state_is_bit_identical_with_tracing_on_and_off(panel, tmp_path,
                                                        wave):
    finals = []
    for traced in (True, False):
        step, _, _ = _chain(panel, tmp_path / str(traced), wave)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                step(1)
                state, aux = step(2)
        else:
            step(1)
            state, aux = step(2)
        finals.append([getattr(state, k).clone() for k in (
            "eps", "betas", "comp", "acum", "sigmag", "sigmae", "pi_est",
            "mu", "cass")] + [aux.m0.clone(), aux.e_sqn.clone()])
    for a, b in zip(*finals):
        assert torch.equal(a, b)


def test_sweep_stamp_summary_by_hand():
    grid, nblocks = 3, 6
    c = torch.arange(grid)[:, None, None]
    r = torch.arange(nblocks + 1)[None, :, None]
    e = torch.arange(sweep_kernel.NST)[None, None, :]
    # CTA 0: a block every 20 us, its events 1 us apart; the column CTAs'
    # 2 us apart, CTA c 0.1 us * c late.
    stamps = torch.where(c == 0, r * 20000 + e * 1000,
                         r * 20000 + e * 2000 + c * 100).to(torch.int64)
    s = sweep_kernel.stamp_summary(stamps)
    assert s["blocks"] == nblocks and s["block_us"] == pytest.approx(20.0)
    assert list(s["scan"].values()) == pytest.approx([1.0] * 6)
    assert list(s["column"].values()) == pytest.approx([2.0] * 6)
    # The chain's events (the last column CTA, 0.2 us late, at each column
    # event): scan e5 of block b, then column e2, e4, e5 and scan e1, e2,
    # e5 of block b + 1.
    assert list(s["chain"].values()) == pytest.approx(
        [19.2, 4.0, 2.0, -9.2, 1.0, 3.0])
    assert s["scan_us"] == pytest.approx(4.0)
    assert sweep_kernel.stamp_summary(stamps[:, :4]) is None


def test_scan_stamp_summary_by_hand():
    n, steps = 3, 128
    rows = torch.zeros((n, len(scan_kernel.SCAN_STAMPS)), dtype=torch.int64)
    col = {k: i for i, k in enumerate(scan_kernel.SCAN_STAMPS)}
    for i in range(n):
        rows[i, col["start_ns"]] = 1000 * i
        rows[i, col["end_ns"]] = 1000 * i + 500
        rows[i, col["cycles"]] = 1000 + i
        for j, p in enumerate(scan_kernel.SCAN_PHASES):
            rows[i, col[p]] = j + 1
        rows[i, col["helper_waits"]] = 1
        rows[i, col["helper_wait_cycles"]] = 7
        rows[i, col["ring_waits"]] = i
        rows[i, col["ring_wait_cycles"]] = 10 * i
    s = scan_kernel.scan_stamp_summary(rows, steps)
    assert s["chain_ns"] == 1500 and s["cycles"] == 3003
    assert s["steps"] == 384
    assert s["cycles_per_step"] == pytest.approx(3003 / 384)
    assert s["phases"] == {p: 3 * (j + 1) for j, p in
                           enumerate(scan_kernel.SCAN_PHASES)}
    assert (s["helper_waits"], s["helper_wait_cycles"], s["ring_waits"],
            s["ring_wait_cycles"]) == (3, 21, 3, 30)


@pytest.mark.parametrize("wave, shards", [(8, 0), (1, 0), (8, 2)],
                         ids=["whole_sweep", "serial", "sharded"])
def test_iter_seconds_one_positive_interval_an_iteration(panel, tmp_path,
                                                         wave, shards):
    opt, _, _ = _setup(panel, tmp_path, wave, thin=3)
    opt.iterations = 5
    if shards:
        res = run_training_sharded(opt, n_devices=shards, device="cpu",
                                   verbose=False)
    else:
        res = runner.run_training(opt, device="cpu", verbose=False)
    assert len(res.iter_seconds) == 5
    assert all(s > 0 for s in res.iter_seconds)
