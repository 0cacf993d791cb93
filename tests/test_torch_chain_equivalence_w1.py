"""Multi-seed posteriors of the port against the JAX package at W=1 (the
exact serial recursion; the JAX package's XLA sweep), each on its own
random numbers: tests/test_torch_chain_equivalence.py's method and
criterion.  The chains are shorter than there: the port's plain serial
scan, a Python loop over markers, costs ~0.1 s an iteration on the CPU.
"""

from test_torch_chain_equivalence import check_all, run_chains

ITERS = 90


def test_serial_posteriors_match_jax(sim_medium, tmp_path):
    check_all(run_chains(sim_medium, str(tmp_path), 1, ITERS,
                         use_pallas=False))
