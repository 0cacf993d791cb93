"""The tiny cell on the card: the program's CUDA kernels judged correct,
the TF32 control judged not, and a trace with device time."""

import pytest

from conftest import TINY_LIMITS, tiny_cell
from pbcore import drive, judge


@pytest.mark.card
@pytest.mark.parametrize("wave", [8, 1])
def test_the_tiny_cell_on_the_card(card, wave):
    r = drive.run(tiny_cell(wave=wave, block_size=32, traits=2), 2 ** 31 + 9,
                  0.5, True, device=card, extra=judge.control,
                  log=lambda *a: None)
    assert judge.correct(r["checks"]), r["checks"]
    assert r["trace"]["busy_s"] > 0 and r["trace"]["launches"] > 0
    assert any(r["extra"][k] > TINY_LIMITS[k] for k in TINY_LIMITS
               if k in r["extra"]), r["extra"]
