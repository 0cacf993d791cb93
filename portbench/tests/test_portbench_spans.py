"""The program's spans and stamps as the harness reads them: the
attribution of device time to ``gmrm.`` spans (``pbcore/spans.py``) on
synthetic events, the new metrics of a traced CPU run and of a program
without the record, and on the card the stamps read and the chain
bit-identical with tracing on and off."""

import sys

import pytest

from conftest import tiny_cell
from pbcore import drive, program, spans, spec

NEW = ("sampler.host_ms_per_iter", "record.fetch_ms", "record.write_ms",
       "sweep.block_us", "sweep.scan_us", "scan.cycles_per_step")


def read(name, run):
    return spec.metric_reader(name)(run)


def test_device_time_goes_to_the_innermost_span_of_its_launch():
    host = [("gmrm.iteration", 0.0, 10.0, 1), ("gmrm.draws", 0.5, 2.0, 2),
            ("cudaLaunchKernel", 1.0, 1.1, 101),
            ("gmrm.pre", 2.0, 3.0, 3), ("cudaGraphLaunch", 2.5, 2.6, 102),
            ("cudaLaunchKernel", 4.0, 4.1, 103),
            ("aten::add", 4.0, 4.2, 101)]
    dev = [("draw", 2.0, 2.5, 101),            # launched in draws
           ("g1", 2.6, 3.0, 102), ("g2", 3.0, 3.5, 102),   # graph replay
           ("k", 4.5, 6.0, 103)]               # iteration, no inner span
    r = spans.reduce_spans(dev, host, 0.0, 10.0)
    s = r["spans"]
    assert s["draws"]["busy_ms"] == pytest.approx(500.0)
    assert s["pre"]["busy_ms"] == pytest.approx(900.0)
    assert s["iteration"]["busy_ms"] == pytest.approx(1500.0)
    assert (s["draws"]["launches"], s["pre"]["launches"],
            s["iteration"]["launches"]) == (1, 1, 1)
    assert s["iteration"]["host_ms"] == pytest.approx(10000.0)
    assert s["iteration"]["self_host_ms"] == pytest.approx(7500.0)
    assert r["unattributed_ms"] == 0.0
    assert r["busy_ms"] == pytest.approx(2900.0)


def test_an_idle_gap_goes_to_the_innermost_span_at_its_midpoint():
    host = [("gmrm.iteration", 0.0, 10.0, 1), ("gmrm.sweep", 3.0, 9.0, 2),
            ("cudaLaunchKernel", 0.1, 0.2, 7), ("cudaLaunchKernel", 3.1, 3.2, 8)]
    dev = [("a", 0.0, 1.0, 7), ("b", 5.0, 10.0, 8)]
    r = spans.reduce_spans(dev, host, 0.0, 10.0)
    # The gap [1, 5] has its midpoint 3 under the sweep.
    assert r["spans"]["sweep"]["idle_ms"] == pytest.approx(4000.0)
    assert r["spans"]["iteration"]["idle_ms"] == 0.0
    assert r["idle_outside_ms"] == 0.0


def test_activities_no_span_launched_are_unattributed():
    host = [("gmrm.iteration", 0.0, 2.0, 1), ("cudaLaunchKernel", 0.5, 0.6, 5),
            ("cudaMemcpyAsync", 3.0, 3.1, 6)]
    dev = [("k", 1.0, 2.0, 5), ("Memcpy DtoH", 3.2, 3.7, 6),
           ("orphan", 3.8, 4.0, 99)]
    r = spans.reduce_spans(dev, host, 0.0, 5.0)
    assert r["unattributed_ms"] == pytest.approx(700.0)
    assert r["spans"]["iteration"]["busy_ms"] == pytest.approx(1000.0)
    # Gaps [0, 1] (under the iteration), [2, 3.2], [3.7, 3.8], [4, 5].
    assert r["spans"]["iteration"]["idle_ms"] == pytest.approx(1000.0)
    assert r["idle_outside_ms"] == pytest.approx(2300.0)


def test_a_traced_cpu_run_reads_the_program_spans(monkeypatch):
    cell = tiny_cell(trace_iterations=4)
    run = drive.run(cell, 2 ** 31 + 5, 0.3, True, device="cpu",
                    log=lambda *a: None)
    s = program.spans(run)
    assert s["iteration"]["calls"] == 4
    assert s["sweep"]["calls"] == 4
    assert read("sampler.host_ms_per_iter", run) > 0
    assert read("record.fetch_ms", run) > 0       # 4 traced: one a record
    assert read("record.write_ms", run) > 0
    # No card: no stamps.
    for name in ("sweep.block_us", "sweep.scan_us", "scan.cycles_per_step"):
        assert read(name, run) is None
    # A program without the record (a tree before it): every one None.
    import gmrm_tpu_torch
    monkeypatch.delattr(gmrm_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "gmrm_tpu_torch.trace", None)
    assert program.spans(run) == {} and program.stamps(run) == {}
    assert all(read(name, run) is None for name in NEW)


def test_an_untraced_run_reads_none():
    assert all(read(name, {"markers": 1}) is None for name in NEW)


@pytest.mark.card
@pytest.mark.parametrize("wave", [8, 1])
def test_traced_chain_on_the_card(card, tmp_path, wave):
    """Two chains from one start, one traced: bit-identical states; the
    traced one's kernels stamped, its spans timed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gmrm_tpu_torch import runner, trace
    from gmrm_tpu_torch.config import Options, resolve_plan
    from gmrm_tpu_torch.io.sim import simulate
    from gmrm_tpu_torch.sampler.dists import RngPlan

    sim = simulate(str(tmp_path / "sim"), n=2000, m=1024, n_traits=2,
                   n_causal=64, na_rate=0.02, seed=11)
    opt = Options(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                  group_index_file=sim.gri, group_mixture_file=sim.grm,
                  iterations=5, seed=7, out_dir=str(tmp_path / "out"),
                  block_size=32, wave_size=wave, output_thin_rate=2)
    opt.validate()
    opt.load_group_mixtures()
    resolve_plan(opt, "cuda", sim.m)
    data = runner.load_data(opt)
    static = runner.build_static(data, opt, card)
    finals = []
    for traced in (True, False):
        state = runner.init_sampler_state(data, opt, card)
        step = runner.iteration_step(state, static, RngPlan(opt.seed, card),
                                     opt)
        for it in (1, 2, 3):          # the graphs captured untraced
            step(it)
        if traced:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                step(4)
                state, _ = step(5)
            torch.cuda.synchronize()
            sums, stamps = trace.span_summaries(), trace.stamp_summaries()
        else:
            step(4)
            state, _ = step(5)
        finals.append([getattr(state, k).clone() for k in
                       drive.STATE_KEYS])
    for a, b in zip(*finals):
        assert torch.equal(a, b)
    assert sums["iteration"]["calls"] == 2
    assert 0 < sums["sweep"]["host_ms"] < sums["iteration"]["host_ms"]
    if wave > 1:
        s = stamps["sweep_blocks"]
        assert s["blocks"] == 32 and s["block_us"] > 0 and s["scan_us"] > 0
    else:
        s = stamps["serial_scan"]
        assert s["steps"] == 32 * 32 and s["cycles_per_step"] > 0
