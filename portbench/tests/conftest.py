"""Shared pieces of the harness's tests: the ``card`` marker (tests that
need a CUDA card; each decides inside itself whether there is one) and a
tiny cell that runs on the program's plain PyTorch versions on the CPU."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PORTBENCH)
for p in (ROOT, PORTBENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIG = dict(name="tiny", inputs="files", individuals=510, markers=1000,
                   groups=2, mixtures=[0.0, 1e-4, 1e-3, 1e-2],
                   maf_range=[0.05, 0.5], causal_share=0.25, h2=0.5)
TINY_TRAFFIC = dict(dtype="float32", block_size=16, wave=8, traits=2,
                    na_rates=[0.0, 0.05], thin=4, warmup_iterations=3,
                    trace_iterations=3, check_blocks=0, gram_check_blocks=4)
# Limits for the tiny cell's float32 CPU runs: the plain versions read
# about 1e-6 (beta_gap, eps_gap) and 2e-7 (hyper_gap); the TF32 control
# reads about 1e-3, 1e-3 and 4e-5.
TINY_LIMITS = dict(beta_gap=3e-5, cdf_gap=1e-6, eps_gap=3e-5,
                   hyper_gap=3e-6, gram_mismatch=0, record_mismatch=0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips here with the reason")


def tiny_cell(inputs="files", **traffic):
    from pbcore import spec
    return spec.Cell(name="tiny", chips=1,
                     config=dict(TINY_CONFIG, inputs=inputs),
                     traffic=dict(TINY_TRAFFIC, **traffic),
                     limits=dict(TINY_LIMITS))


@pytest.fixture
def card():
    """The CUDA device, or a skip where this machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")
