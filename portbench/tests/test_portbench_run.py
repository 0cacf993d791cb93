"""The command fails, and prints no result, where it cannot measure: no
card, or a checkout that holds only the benchmark."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import PORTBENCH, ROOT


def run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "sim10k_100k.w32",
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


@pytest.mark.card
def test_the_benchmark_alone_is_no_run(card, tmp_path):
    shutil.copytree(PORTBENCH, tmp_path / "portbench")
    shutil.copy(Path(ROOT) / "BENCHMARK.json", tmp_path)
    out = run(tmp_path)
    assert out.returncode != 0 and no_result(out)
