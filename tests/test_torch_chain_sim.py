"""The port's simulator writes the JAX package's dataset, byte for byte,
for the anchor-scale parameters of benchmarking/equivalence_ref.py:154-156
(4 traits, causal M/4, h2 0.5, 2 groups, 1% NAs, seed 20260819, mixtures
[0, 1e-4, 1e-3, 1e-2]) at cut N and M, in memory and through the chunked
path.  chip_smoke.py phase 10(b) regenerates the full-size dataset with
the port's simulator and checks its digest against one made with the
JAX package's; this is why the two agree.
"""

import os

import numpy as np
import pytest

import gmrm_tpu.io.sim as jsim
import gmrm_tpu_torch.io.sim as psim

MIXTURES = np.array([0.0, 0.0001, 0.001, 0.01])


@pytest.mark.parametrize("n, m, inmem", [(1_000, 2_000, True),
                                         (301, 997, True),
                                         (301, 997, False)],
                         ids=["1000x2000", "301x997", "301x997_chunked"])
def test_port_simulator_writes_the_jax_dataset(n, m, inmem, tmp_path,
                                               monkeypatch):
    if not inmem:
        for mod in (jsim, psim):
            monkeypatch.setattr(mod, "INMEM_LIMIT", 50 * n)
    sims = {}
    for name, mod in (("jax", jsim), ("port", psim)):
        sims[name] = mod.simulate(
            str(tmp_path / name), n=n, m=m, n_traits=4, n_causal=m // 4,
            h2=0.5, n_groups=2, na_rate=0.01, seed=20260819,
            mixtures=MIXTURES)
    a, b = sims["jax"], sims["port"]
    files = [(a.bed, b.bed), (a.dim, b.dim), (a.bim, b.bim),
             (a.gri, b.gri), (a.grm, b.grm), *zip(a.phens, b.phens)]
    assert len(files) == 9
    for fa, fb in files:
        assert os.path.basename(fa) == os.path.basename(fb)
        with open(fa, "rb") as x, open(fb, "rb") as y:
            assert x.read() == y.read(), os.path.basename(fa)
    np.testing.assert_array_equal(a.beta_true, b.beta_true)
    np.testing.assert_array_equal(a.h2_realized, b.h2_realized)
    with open(a.phens[0]) as fh:
        assert sum("NA" in line for line in fh) == round(0.01 * n)
