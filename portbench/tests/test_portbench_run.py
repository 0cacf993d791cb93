"""The command fails, and prints no result, where it cannot measure: no
card, or a checkout that holds only the benchmark."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import PORTBENCH, ROOT, TINY_LIMITS


def run(cwd, *extra, workload="sim10k_100k.w32"):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, timeout=600, cwd=cwd)


def no_result(out):
    for line in out.stdout.strip().splitlines()[-1:]:
        try:
            json.loads(line)
        except ValueError:
            continue
        return False
    return True


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = run(ROOT)
    assert out.returncode != 0 and no_result(out)
    assert "needs 1 CUDA device" in out.stderr


def test_fewer_cards_than_the_cell_asks_no_result(tmp_path):
    """A cell on four cards, on a machine with fewer: no result, whatever
    the machine has below four."""
    import torch
    from test_portbench_cards import SHARDED_CONFIG
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("this machine has four cards")
    shutil.copytree(PORTBENCH, tmp_path / "portbench")
    bench = json.loads((Path(ROOT) / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="tiny_x4",
                                 file="portbench/configs/tiny_x4.json"))
    bench["workloads"].append(dict(name="tiny_x4.w32", config="tiny_x4",
                                   traffic="w32", chips=4, why="four cards"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench/configs/tiny_x4.json").write_text(
        json.dumps(dict(SHARDED_CONFIG, name="tiny_x4", shards=4)))
    (tmp_path / "portbench/limits/tiny_x4.w32.json").write_text(
        json.dumps({"limits": dict(TINY_LIMITS, replica_mismatch=0)}))
    out = run(tmp_path, workload="tiny_x4.w32")
    assert out.returncode != 0 and no_result(out)
    assert "needs 4 CUDA device(s)" in out.stderr


@pytest.mark.card
def test_the_benchmark_alone_is_no_run(card, tmp_path):
    shutil.copytree(PORTBENCH, tmp_path / "portbench")
    shutil.copy(Path(ROOT) / "BENCHMARK.json", tmp_path)
    out = run(tmp_path)
    assert out.returncode != 0 and no_result(out)
