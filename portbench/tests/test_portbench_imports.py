"""Nothing the benchmark runs imports JAX or the JAX package: each
import's top-level name (the part before the first dot) is compared
whole, since the port's name begins with the JAX package's.  The
reference and the judge import nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import PORTBENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gmrm_tpu"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources():
    yield from sorted(Path(PORTBENCH).rglob("*.py"))
    yield from sorted((Path(ROOT) / "gmrm_tpu_torch").rglob("*.py"))


@pytest.mark.parametrize("path", list(sources()),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_run_on_the_card_imports_jax(path):
    bad = set(imported_tops(path)) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("name", ["reference.py", "judge.py", "data.py"])
def test_the_reference_side_imports_nothing_of_the_program(name):
    tops = set(imported_tops(Path(PORTBENCH) / "pbcore" / name))
    assert "gmrm_tpu_torch" not in tops and not tops & FORBIDDEN


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run of the tiny cell in a fresh process, then its modules."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from conftest import tiny_cell\n"
        "from pbcore import drive\n"
        "drive.run(tiny_cell(), 7, 0.2, False, device='cpu', log=lambda *a: None)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n"
        % (str(Path(PORTBENCH) / "tests"), PORTBENCH, FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
