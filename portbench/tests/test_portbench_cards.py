"""A cell on several cards, driven on the CPU: two gloo processes, each on
its shard of a tiny marker-sharded deployment built here, through the
program's sharded path (its plain versions), judged by the sharded plain
reference; the control and every fault the cell can have read ``correct``
false; the deployment does not depend on the number of processes; and a
one-card cell's run keeps its keys."""

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import PORTBENCH, ROOT, TINY_LIMITS, tiny_cell
from pbcore import cards, data, drive, judge, spec

SEED = 2 ** 31 + 11
SHARDED_CONFIG = dict(name="tiny_x2", inputs="device", individuals=512,
                      markers=2048, groups=2, mixtures=[0.0, 1e-4, 1e-3, 1e-2],
                      maf_range=[0.05, 0.5], causal_share=0.25, h2=0.5,
                      shards=2)
SHARDED_TRAFFIC = dict(dtype="float32", block_size=32, wave=4, traits=2,
                       na_rates=[0.0, 0.05], thin=4, warmup_iterations=3,
                       trace_iterations=2, check_blocks=8,
                       gram_check_blocks=4)
FAULTS = ["unchanged", "half_left_out", "exchange_left_out", "altered"]


def sharded_cell():
    return spec.Cell(name="tiny_x2", chips=2, config=dict(SHARDED_CONFIG),
                     traffic=dict(SHARDED_TRAFFIC),
                     limits=dict(TINY_LIMITS, replica_mismatch=0))


def values(checks):
    return {k: v["value"] for k, v in checks.items() if not k.startswith("_")}


@pytest.fixture(scope="module")
def sound():
    """One traced run with the control, merged over the two processes."""
    item = dict(seed=SEED, seconds=0.2, traced=True, fault=None,
                control=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")
        per = cards.launch(sharded_cell(), [item], device="cpu",
                           log=lambda *a: None)[0]
    return per, cards.merge(per)


@pytest.fixture(scope="module")
def broken():
    """One run with each fault planted under the timed path."""
    items = [dict(seed=SEED, seconds=0.2, traced=False, fault=f,
                  control=False) for f in FAULTS]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")
        runs = cards.launch(sharded_cell(), items, device="cpu",
                            log=lambda *a: None)
    return {f: cards.merge(per) for f, per in zip(FAULTS, runs)}


def test_two_processes_are_correct(sound):
    per, run = sound
    assert judge.correct(run["checks"]), values(run["checks"])
    assert run["checks"]["replica_mismatch"]["value"] == 0
    assert [p["rank"] for p in per] == [0, 1]
    assert run["markers"] == SHARDED_CONFIG["markers"]
    assert run["iterations"] >= 1 and run["trace"]["iterations"] == 2
    assert "ops" in run["trace"]
    host = run["host"]
    assert host["steps_per_iter"] == 2048 // 2 // 32
    assert 0 < host["step_ms"] and host["calls_ms_per_iter"] > 0


def test_the_tf32_control_fails_the_sharded_limits(sound):
    _, run = sound
    ctl = run["extra"]
    assert any(ctl[k] > TINY_LIMITS[k] for k in TINY_LIMITS if k in ctl), ctl


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_sharded_step_is_not_correct(broken, fault):
    run = broken[fault]
    assert not judge.correct(run["checks"]), values(run["checks"])


def test_the_exchange_left_out_breaks_the_replicas(broken):
    assert broken["exchange_left_out"]["checks"]["replica_mismatch"]["value"] > 0


WORKER = """
import json, sys, torch, torch.distributed as dist
sys.path[:0] = [%r, %r]
from pbcore import data
SHARDED_CONFIG, SHARDED_TRAFFIC = json.loads(%r)
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method=sys.argv[2], world_size=2,
                        rank=rank)
torch.set_num_threads(1)

def gather(x):
    out = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(out, x)
    return out
d = data.make_shards(SHARDED_CONFIG, SHARDED_TRAFFIC, %d, "cpu", sys.argv[3],
                     [rank], gather, writer=rank == 0, wait=dist.barrier)
torch.save({"bed": d.beds[0], "y": d.y, "files": d.files},
           sys.argv[3] + "/rank%%d.pt" %% rank)
dist.destroy_process_group()
"""


def test_one_process_with_both_shards_makes_the_same_deployment(tmp_path):
    """In bytes and in y; one thread on every side, since the CPU's float32
    product of the genetic value sums in an order that follows the
    threads (on the card every process runs the same kernel)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = data.make_shards(SHARDED_CONFIG, SHARDED_TRAFFIC, SEED, "cpu",
                               str(tmp_path / "one"), [0, 1], lambda x: [x])
    finally:
        torch.set_num_threads(threads)
    two = tmp_path / "two"
    two.mkdir()
    code = WORKER % (PORTBENCH, ROOT,
                     json.dumps([SHARDED_CONFIG, SHARDED_TRAFFIC]), SEED)
    init = f"file://{tmp_path}/rendezvous"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), init,
                               str(two)], cwd=ROOT,
                              env=dict(os.environ, OMP_NUM_THREADS="1"),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for p in procs:
        out = p.communicate(timeout=120)[0]
        assert p.returncode == 0, out[-3000:]
    parts = [torch.load(two / f"rank{r}.pt") for r in range(2)]
    for r in range(2):
        assert torch.equal(parts[r]["bed"], one.beds[r])
        assert torch.equal(parts[r]["y"].isnan(), one.y.isnan())
        assert torch.equal(torch.nan_to_num(parts[r]["y"]),
                           torch.nan_to_num(one.y))
    for name in ("dim", "gri", "grm"):
        assert (open(parts[0]["files"][name], "rb").read()
                == open(one.files[name], "rb").read())
    for a, b in zip(parts[0]["files"]["phens"], one.files["phens"]):
        assert open(a, "rb").read() == open(b, "rb").read()


ONE_CARD_RUN_KEYS = ["cell", "check_s", "checks", "data_s", "intervals_s",
                     "iterations", "markers", "memory_peak_bytes",
                     "records_s", "seed", "setup_s", "spans", "trace",
                     "window_s"]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "breakdown", "checks"]


def test_a_one_card_cell_keeps_its_run_and_result_keys():
    """A one-card cell's run dict, its trace and its result line keep the
    keys they had before cells on several cards."""
    import run as run_py
    c = tiny_cell()
    bench = spec.benchmark()
    one = spec.cell("sim10k_100k.w32", bench)
    c.metrics = one.metrics
    r = drive.run(c, SEED, 0.2, True, device="cpu", log=lambda *a: None)
    assert sorted(r) == ONE_CARD_RUN_KEYS
    assert sorted(r["trace"]) == ["busy_s", "device_ops", "idle_gaps",
                                  "iterations", "launches", "window_s"]
    res = run_py.finish(c, r, True, "cpu")
    assert list(res) == RESULT_KEYS
    assert list(res["device"]) == ["platform", "kind", "count",
                                   "memory_peak_bytes", "busy_s", "window_s"]
    assert list(res["checks"]) == list(TINY_LIMITS)
    json.dumps(res)
