"""The check that decides ``correct`` fails its control and every fault
the cells can have, with the harness's whole run driven on the CPU (the
program's plain versions) and the timed path broken underneath."""

import pytest
import torch

from conftest import TINY_LIMITS, tiny_cell
from pbcore import drive, judge

SEED = 2 ** 31 + 5


def warm_then(make):
    """A fault that lets the warm-up iterations through."""
    def wrap(step):
        broken = make(step)

        def f(it):
            return step(it) if it <= 3 else broken(it)
        return f
    return wrap


def unchanged(step):
    """A step that returns the state unchanged."""
    last = {}

    def f(it):
        if "st" not in last:
            last["st"] = step(it)
        return last["st"]
    return f


def half_left_out(step):
    """Half of the markers (every other block) left out of the sweep."""
    keep = {}

    def g(it):
        st, aux = keep.get("last", (None, None))
        old = None if st is None else {k: getattr(st, k).clone()
                                       for k in ("betas", "comp", "acum")}
        st, aux = step(it)
        if old is not None:
            B = 16
            for k, v in old.items():
                x = getattr(st, k).view(v.shape[0], -1, B)
                x[:, 1::2] = v.view(v.shape[0], -1, B)[:, 1::2]
        keep["last"] = (st, aux)
        return st, aux
    return g


def altered(step):
    """One marker's new effect altered where the sweep produces it."""
    def f(it):
        st, aux = step(it)
        j = int(st.betas[0].abs().argmax())
        st.betas[0, j] *= 1.01
        return st, aux
    return f


def values(r):
    return {k: v["value"] for k, v in r["checks"].items()
            if not k.startswith("_")}


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered],
                         ids=["unchanged", "half_left_out", "altered"])
@pytest.mark.parametrize("wave", [8, 1])
def test_a_broken_step_is_not_correct(fault, wave):
    c = tiny_cell(wave=wave)
    r = drive.run(c, SEED, 0.3, False, device="cpu", fault=warm_then(fault),
                  log=lambda *a: None)
    assert not judge.correct(r["checks"]), values(r)


@pytest.mark.parametrize("wave", [8, 1])
def test_the_tf32_control_fails_the_limits(wave):
    c = tiny_cell(wave=wave)
    r = drive.run(c, SEED, 0.3, False, device="cpu", extra=judge.control,
                  log=lambda *a: None)
    assert judge.correct(r["checks"]), values(r)
    ctl = r["extra"]
    assert any(ctl[k] > TINY_LIMITS[k] for k in TINY_LIMITS if k in ctl), ctl


def test_float32_fails_the_float64_limits():
    """The float64 cell's control: the program's own float32 path."""
    c = tiny_cell(wave=1, dtype="float64")
    c64 = drive.run(c, SEED, 0.3, False, device="cpu", log=lambda *a: None)
    assert judge.correct(c64["checks"]), values(c64)
    lim = {k: max(10 * v, 1e-14) for k, v in values(c64).items()
           if k not in ("gram_mismatch", "record_mismatch")}
    c32 = drive.run(tiny_cell(wave=1, dtype="float32"), SEED, 0.3, False,
                    device="cpu", log=lambda *a: None)
    assert any(values(c32)[k] > lim[k] for k in lim), (values(c32), lim)
