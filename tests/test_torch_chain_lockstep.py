"""Whole Gibbs iterations of the port in lockstep with the JAX package's
``gibbs_iteration``, on the CPU, every random number scripted.

Both packages start from the JAX package's own state and static inputs
(``init_sampler_state`` / ``build_static``, or what its
``run_training_sharded`` hands its first step), carried across by
``state_from_numpy`` / ``static_from_numpy``, and each carries its own
state from iteration to iteration: the intercept step and the first
iteration's sigmaE, the order feeding the sweep, the sweep, the
hyperparameter block, and m0, the new sigmaG and pi feeding the next
iteration's tables.  ``tests/torch_chain_script.py`` feeds both from one
numpy seed (its gamma variates by ``scipy.special.gammaincinv`` of each
package's own shape).  The JAX step is jitted once per case with the draws
as an argument.

Paths, each with 2% phenotype NAs (NT = T) and without (NT = 1):
- ``mega``: float32 W=8 in block mode, the JAX whole-sweep kernel in
  interpret mode against the port's default ``WholeSweepIteration``;
- ``composed``: the same with ``megakernel=False`` on both sides;
- ``w1_xla`` / ``w1_pallas``: W=1 against the JAX XLA sweep and its
  Pallas sweep;
- ``f64_w1``: float64 W=1 against the JAX XLA sweep;
- ``f64_wave``: float64 W=8; the JAX wave scan patched to the float64
  ``wave_reference`` (tests/test_torch_float64_wave.py), since the JAX
  package's own float64 wave scan narrows to float32;
- ``sharded_wave`` / ``sharded_w1``: S=2 marker shards, JAX
  ``gibbs_iteration`` under ``shard_map`` on two of the 8 host devices
  against the port's ``gibbs_iteration_sharded`` (kernel 9's plain version
  at W=8; the composed W=1 kernels' at W=1), the order and sweep draws
  scripted per shard.

Gates after every iteration (``torch_chain_script.Lockstep``): comp, cass
and m0 equal; betas, eps and acum within tests/test_sweep_kernel.py:57-66
at float32, sigmaG, sigmaE, pi and mu within rtol 1e-4 (sigmaG also by
what the betas' differences move a group's sum of beta^2 by); everything
within 1e-10 relative at float64.  A trait whose comp differs fails unless its
first differing draw lies within 4 ulps of its CDF boundary in the JAX
package's arithmetic (printed, and the trait left out from then on).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmrm_tpu.ops.pallas_kernels as pk
import gmrm_tpu.ops.scan_kernel_wave as skw
import gmrm_tpu.ops.sweep_kernel as swk
from gmrm_tpu.config import Options as JaxOptions
from gmrm_tpu.io.sim import simulate
from gmrm_tpu.parallel.mesh import MARKER_AXIS
from gmrm_tpu.runner import build_static, init_sampler_state, load_data
from gmrm_tpu_torch.parallel.distributed import Communicator
from gmrm_tpu_torch.sampler.gibbs import (
    gibbs_iteration, gibbs_iteration_sharded,
)
from gmrm_tpu_torch.sampler.state import state_from_numpy, static_from_numpy
from gmrm_tpu_torch.sampler.whole_sweep import WholeSweepIteration
from test_torch_float64_wave import wave_reference
import torch_chain_script as cs

torch.set_num_threads(2)

CPU = torch.device("cpu")
B = 32
ITERS = 5

# name: (wave, use_pallas, dtype, shards, megakernel)
PATHS = {
    "mega": (8, True, "float32", 1, None),
    "composed": (8, True, "float32", 1, False),
    "w1_xla": (1, False, "float32", 1, None),
    "w1_pallas": (1, True, "float32", 1, None),
    "f64_w1": (1, False, "float64", 1, None),
    "f64_wave": (8, True, "float64", 1, None),
    "sharded_wave": (8, True, "float32", 2, None),
    "sharded_w1": (1, False, "float32", 2, None),
}


@pytest.fixture(scope="module", params=[0.02, 0.0], ids=["na", "no_na"])
def chain_sim(request, tmp_path_factory):
    """120 markers (4 blocks of 32 on one device, the last with 8 pad
    slots; 2 shards of 60, each 2 blocks with 4 pad slots), 2 traits, 2
    groups, N=600."""
    return simulate(str(tmp_path_factory.mktemp("lockstep")), n=600, m=120,
                    n_traits=2, n_causal=32, h2=0.5, n_groups=2,
                    na_rate=request.param, seed=29,
                    mixtures=np.array([0.0, 0.001, 0.01, 0.05]))


def jax_options(sim, wave, use_pallas, dtype, out_dir=""):
    opt = JaxOptions(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                     group_index_file=sim.gri, group_mixture_file=sim.grm,
                     iterations=1, seed=3, block_size=B, wave_size=wave,
                     use_pallas=use_pallas, dtype=dtype, out_dir=out_dir,
                     output_thin_rate=10 ** 9)
    opt.validate()
    opt.load_group_mixtures()
    return opt


def run_lockstep(sim, path, monkeypatch, tmp_path, iters=ITERS, seed=7):
    """Runs ``iters`` whole iterations of both packages on ``path``
    (``PATHS``'s fields) and checks every one; returns the Lockstep."""
    wave, use_pallas, dtype, shards, mega = path
    f64 = dtype == "float64"
    jdt = jnp.float64 if f64 else jnp.float32
    for mod in (pk, skw, swk):
        monkeypatch.setattr(mod, "FORCE_INTERPRET", True)
    if f64 and wave > 1:
        monkeypatch.setattr(skw, "make_block_scan_wave", wave_reference)
    feed = cs.JaxFeed()
    cs.jax_patches(monkeypatch, feed)
    shared_na = all("NA" not in open(p).read() for p in sim.phens)
    with jax.enable_x64(f64):
        opt = jax_options(sim, wave, use_pallas, dtype, str(tmp_path))
        if shards > 1:
            mesh, jstate, jstatic = cs.jax_sharded_start(opt, shards)
            m_locals = [int(x) for x in np.asarray(jstatic.m_local)]
        else:
            mesh = None
            data = load_data(opt)
            jstatic = build_static(data, opt, jdt)
            jstate = init_sampler_state(data, opt, jdt)
            m_locals = [int(jstatic.m_local)]
        T, m_glob = jstate.betas.shape
        m_pad = m_glob // shards
        G, K = np.asarray(jstatic.cva).shape
        nblocks = m_pad // B
        block_mode = (use_pallas and not f64 and wave > 1)
        assert (jstatic.gram_cache is not None) == block_mode
        kw = dict(block_size=B, use_pallas=use_pallas, shared_na=shared_na,
                  wave_size=wave)
        if shards > 1:
            kw["axis_name"] = MARKER_AXIS
        else:
            kw["megakernel"] = mega
        jstep = cs.make_jax_step(feed, mesh=mesh,
                                 with_cache=jstatic.gram_cache is not None,
                                 **kw)
        script = cs.Script(seed, T, G, K, nblocks, B, n_shards=shards)

        # The port, from the same start.
        n_sh = shards if shards > 1 else None
        pstatic = static_from_numpy(cs.leaves(jstatic), CPU, n_shards=n_sh)
        pstate = state_from_numpy(cs.leaves(jstate), CPU, n_shards=n_sh)
        cs.port_patches(monkeypatch.setattr, script)
        if shards > 1:
            pstatic = [dataclasses.replace(s, shared_na=shared_na)
                       for s in pstatic]
            plans = [cs.ScriptedPlan(script, CPU, shard=i)
                     for i in range(shards)]
            comm = Communicator(CPU)

            def port_step(it):
                nonlocal pstate
                pstate, aux = gibbs_iteration_sharded(
                    pstate, pstatic, it, plans, block_size=B, wave=wave,
                    comm=comm)
                return pstate, aux
        elif mega is None and block_mode:
            pstatic = dataclasses.replace(pstatic, shared_na=shared_na)
            port_step = WholeSweepIteration(
                pstate, pstatic, cs.ScriptedPlan(script, CPU),
                block_size=B, wave=wave)
        else:
            pstatic = dataclasses.replace(pstatic, shared_na=shared_na)
            plan = cs.ScriptedPlan(script, CPU)

            def port_step(it):
                nonlocal pstate
                pstate, aux = gibbs_iteration(
                    pstate, pstatic, it, plan, block_size=B, wave=wave,
                    megakernel=mega)
                return pstate, aux

        lock = cs.Lockstep(
            f64, lambda it: cs.natural_u(script, it, block_mode, m_locals,
                                         m_pad),
            f"{'f64' if f64 else 'f32'} W={wave} S={shards}",
            np.asarray(jstatic.group_of))
        for it in range(1, iters + 1):
            jstate, jaux = jstep(jstate, jstatic, jnp.asarray(it, jnp.int32),
                                 cs.jax_script(script, it, np.dtype(dtype)))
            want = cs.jax_fields(jstate, jaux)
            got = cs.port_fields(*port_step(it))
            assert got["eps"].dtype == want["eps"].dtype
            lock.check(it, want, got)
        assert (want["comp"][:, :m_locals[0]] != 0).any()
    return lock


@pytest.mark.parametrize("name", list(PATHS))
def test_whole_iterations_in_lockstep(chain_sim, name, monkeypatch,
                                      tmp_path):
    run_lockstep(chain_sim, PATHS[name], monkeypatch, tmp_path)
