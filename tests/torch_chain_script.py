"""Scripted draws for whole Gibbs iterations, fed alike to the JAX package
and to the port.

``Script`` makes every random number of an iteration from a numpy seed:
the intercept's normal z_mu (T,); the processing order, as a block order
pi_b (nblocks,) and row keys (nblocks, B) whose argsort is each block's
row order (block mode), or as marker keys (m_pad,) whose argsort is the
uniform shuffle; the sweep's uniforms u and normals z (nblocks, T, B); and
one uniform for each gamma variate of the hyperparameter block, sigmaG
(T, G), pi (T, G, K) and sigmaE (T,).  The order, u and z are drawn per
shard (the draws a sharded run keys by shard); the others once.  Keys are
distinct multiples of 1/B or 1/m_pad, so an argsort has no ties.

Each gamma variate is ``scipy.special.gammaincinv(shape, u)`` in float64
of the shape that the package itself computed, cast to the run's dtype:
both packages get the same variate for the same shape, and what differs
comes from the model's arithmetic.

- ``JaxFeed`` stands in for ``jax.random`` in ``gmrm_tpu.sampler.gibbs``
  and ``gmrm_tpu.sampler.dists`` (``jax_patches``).  It tells the draws
  apart by their shapes and reads them from ``feed.cur``, a dict of the
  iteration's arrays that ``make_jax_step`` passes to the jitted step as an
  argument, so one compilation serves every iteration; the variates go
  through ``jax.pure_callback``.  Under ``shard_map`` the per-shard draws
  are split along their first axis (``jax_script``'s layout).
- ``ScriptedPlan`` stands in for ``RngPlan``: its ``gen(it, purpose)``
  returns a ``Token``, which ``TorchProxy`` (put in place of ``torch`` in
  the port's ``sampler.gibbs`` and ``sampler.whole_sweep``) answers with
  the scripted numbers; ``port_patches`` also replaces ``gamma_draws`` (the
  uniform in the boost slot) and ``gamma_from_draws`` (the variate).
"""

from __future__ import annotations

import numpy as np
import scipy.special
import torch

from gmrm_tpu_torch.config import S02G, V0G

SHARD_KEYED = ("block_order", "row_order", "marker_order", "u", "z")
GAMMA = ("sigmag", "pi", "sigmae")


class Script:
    """The draws of iterations 1, 2, ... of a run of T traits, G groups, K
    components and ``n_shards`` shards of ``nblocks`` blocks of B."""

    def __init__(self, seed, T, G, K, nblocks, B, n_shards=1):
        self.seed, self.T, self.G, self.K = seed, T, G, K
        self.nblocks, self.B, self.n_shards = nblocks, B, n_shards
        self.cache = {}

    def __call__(self, it):
        """Iteration ``it``'s draws, float64 (orders int64 and float32);
        the shard-keyed ones with a leading shard axis."""
        if it not in self.cache:
            T, G, K, nb, B, D = (self.T, self.G, self.K, self.nblocks,
                                 self.B, self.n_shards)
            rng = np.random.default_rng([self.seed, it])
            m_pad = nb * B
            self.cache[it] = {
                "mu": rng.normal(size=T),
                "block_order": np.stack([rng.permutation(nb)
                                         for _ in range(D)]),
                "row_order": ((np.stack([np.stack([rng.permutation(B)
                                                   for _ in range(nb)])
                                         for _ in range(D)]) + 0.5) / B
                              ).astype(np.float32),
                "marker_order": ((np.stack([rng.permutation(m_pad)
                                            for _ in range(D)]) + 0.5)
                                 / m_pad).astype(np.float32),
                "u": rng.uniform(size=(D, nb, T, B)),
                "z": rng.normal(size=(D, nb, T, B)),
                "sigmag": rng.uniform(size=(T, G)),
                "pi": rng.uniform(size=(T, G, K)),
                # One uniform for every trait: the JAX package draws ONE
                # gamma variate for all traits' sigmaE (its shape,
                # 0.5 * (V0E + N), is a scalar; gibbs.py:559-562), the
                # port one a trait, so the same variate needs equal
                # uniforms.
                "sigmae": np.full(T, rng.uniform()),
            }
        return self.cache[it]

    def value(self, it, purpose, shard=0):
        x = self(it)[purpose]
        return x[shard] if purpose in SHARD_KEYED else x

    def order(self, it, block_mode, m_local, shard=0):
        """The processing order (m_pad,) that the packages derive."""
        B = self.B
        if block_mode:
            pi_b = self.value(it, "block_order", shard)
            rows = np.argsort(self.value(it, "row_order", shard), axis=1)
            return (pi_b[:, None] * B + rows).reshape(-1)
        r = self.value(it, "marker_order", shard).astype(np.float64)
        r = np.where(np.arange(r.size) < m_local, r, 2.0)
        return np.argsort(r, kind="stable")


def variate_np(shape, u):
    """Gamma(shape, 1) at quantile u, float64."""
    return scipy.special.gammaincinv(np.asarray(shape, np.float64),
                                     np.asarray(u, np.float64))


# --------------------------------------------------------------------------
# The JAX package
# --------------------------------------------------------------------------

def jax_script(script, it, dtype):
    """Iteration ``it``'s draws as the JAX step takes them: the per-shard
    arrays concatenated along their first axis (a ``P(axis)`` split gives
    each shard its own), u and z in ``dtype``."""
    d = script(it)
    out = {}
    for k, x in d.items():
        if k in SHARD_KEYED:
            x = x.reshape((-1,) + x.shape[2:])
        if k in ("u", "z", "mu"):
            x = x.astype(dtype)
        out[k] = x
    out["block_order"] = out["block_order"].astype(np.int32)
    return out


class JaxFeed:
    """``jax.random`` with its draws replaced by the script's while a
    scripted step is traced (``cur`` set); keys are still split and folded
    by the real functions, and other draws (the start's sigmaG) are
    real."""

    def __init__(self):
        import jax
        self.jax = jax
        self.cur = None

    def __getattr__(self, name):
        return getattr(self.jax.random, name)

    def _take(self, name, shape, dtype):
        x = self.cur[name]
        assert tuple(x.shape) == tuple(shape), (name, x.shape, shape)
        return x.astype(dtype)

    def normal(self, key, shape=(), dtype=np.float32):
        if self.cur is None:
            return self.jax.random.normal(key, shape, dtype)
        return self._take("mu" if len(shape) == 1 else "z", shape, dtype)

    def uniform(self, key, shape=(), dtype=np.float32, minval=0.0,
                maxval=1.0):
        if self.cur is None:
            return self.jax.random.uniform(key, shape, dtype, minval, maxval)
        name = {1: "marker_order", 2: "row_order", 3: "u"}[len(shape)]
        return self._take(name, shape, dtype)

    def permutation(self, key, x, axis=0, independent=False):
        return self._take("block_order", x.shape, x.dtype)

    def gamma(self, key, a, shape=None, dtype=np.float32):
        jax = self.jax
        dtype = np.dtype(dtype)     # here, under the caller's x64 setting
        name = {2: "sigmag", 3: "pi", 0: "sigmae"}[a.ndim]
        u = self.cur[name]
        if name == "sigmae":
            u = u[0]
        assert u.shape == a.shape, (name, u.shape, a.shape)
        if dtype != np.float64:
            return jax.pure_callback(
                lambda a_, u_: variate_np(a_, u_).astype(dtype),
                jax.ShapeDtypeStruct(a.shape, dtype), a, u)
        # A callback's float64 operands and results are narrowed on a
        # thread without x64, so they cross as their bits, uint32 pairs.
        def f64(bits):
            bits = np.asarray(bits)
            return bits.reshape(-1).view(np.float64).reshape(bits.shape[:-1])

        def call(a_bits, u_bits):
            g = np.asarray(variate_np(f64(a_bits), f64(u_bits)), np.float64)
            return g.reshape(-1).view(np.uint32).reshape(g.shape + (2,))

        def to_bits(x):
            return jax.lax.bitcast_convert_type(
                jax.numpy.asarray(x, dtype), np.uint32)

        bits = jax.pure_callback(
            call, jax.ShapeDtypeStruct(a.shape + (2,), np.uint32),
            to_bits(a), to_bits(u))
        return jax.lax.bitcast_convert_type(bits, dtype)


def jax_patches(monkeypatch, feed):
    """Put ``feed`` in place of ``jax.random`` where the JAX package's
    iteration draws."""
    from gmrm_tpu.sampler import dists as jdists
    from gmrm_tpu.sampler import gibbs as jgibbs
    monkeypatch.setattr(jgibbs, "jr", feed)
    monkeypatch.setattr(jdists, "jr", feed)


def make_jax_step(feed, mesh=None, with_cache=False, **kw):
    """``gibbs_iteration(state, static, it, **kw)`` jitted as
    ``step(state, static, it, draws)``, ``draws`` from ``jax_script``;
    with ``mesh``, under ``shard_map`` on its marker axis."""
    import jax
    from gmrm_tpu.sampler import gibbs as jgibbs

    def step(state, static, it, draws):
        feed.cur = draws
        try:
            return jgibbs.gibbs_iteration(state, static, it, **kw)
        finally:
            feed.cur = None

    if mesh is not None:
        from jax.sharding import PartitionSpec as P
        from gmrm_tpu.parallel.mesh import MARKER_AXIS
        from gmrm_tpu.parallel.runner import _state_specs, _static_specs
        dspec = {k: P(MARKER_AXIS) if k in SHARD_KEYED else P()
                 for k in ("mu", *SHARD_KEYED, *GAMMA)}
        step = jax.shard_map(
            step, mesh=mesh,
            in_specs=(_state_specs(), _static_specs(with_cache), P(), dspec),
            out_specs=(_state_specs(), P()), check_vma=False)
    return jax.jit(step)


# --------------------------------------------------------------------------
# The port
# --------------------------------------------------------------------------

class Token:
    """What ``ScriptedPlan.gen`` returns in place of a generator."""

    def __init__(self, it, purpose, shard):
        self.it, self.purpose, self.shard = it, purpose, shard


class ScriptedPlan:
    """``RngPlan``'s interface over a script; ``shard`` as RngPlan's."""

    def __init__(self, script, device, shard=None):
        self.script = script
        self.device = torch.device(device)
        self.shard = 0 if shard is None else int(shard)

    def gen(self, it, purpose):
        return Token(int(it), purpose, self.shard)


class TorchProxy:
    """``torch`` with ``randn``, ``rand`` and ``randperm`` answered from the
    script when their generator is a ``Token``."""

    def __init__(self, script):
        self.script = script

    def __getattr__(self, name):
        return getattr(torch, name)

    def _draw(self, real, size, generator, out, dtype, device, kw):
        if not isinstance(generator, Token):
            return real(size, generator=generator, out=out, dtype=dtype,
                        device=device, **kw)
        x = torch.from_numpy(np.ascontiguousarray(self.script.value(
            generator.it, generator.purpose, generator.shard)))
        want = (size,) if isinstance(size, int) else tuple(size)
        assert tuple(x.shape) == want, (generator.purpose, x.shape, want)
        if out is not None:
            return out.copy_(x)
        if dtype is None:
            dtype = torch.int64 if real is torch.randperm else torch.float32
        return x.to(device=device, dtype=dtype)

    def randn(self, size, *, generator=None, out=None, dtype=None,
              device=None, **kw):
        return self._draw(torch.randn, size, generator, out, dtype, device,
                          kw)

    def rand(self, size, *, generator=None, out=None, dtype=None,
             device=None, **kw):
        return self._draw(torch.rand, size, generator, out, dtype, device,
                          kw)

    def randperm(self, n, *, generator=None, out=None, dtype=None,
                 device=None, **kw):
        return self._draw(torch.randperm, n, generator, out, dtype, device,
                          kw)


def variate_cpu(shape, u):
    """``variate_np`` on tensors (float64, on shape's device)."""
    return torch.from_numpy(variate_np(shape.detach().cpu().double().numpy(),
                                       u.detach().cpu().double().numpy())
                            ).to(shape.device)


def port_patches(setattr_, script, variate=variate_cpu):
    """Feed the port's iteration from ``script`` (with ``ScriptedPlan`` in
    place of its ``RngPlan``): ``setattr_(obj, name, value)`` is
    ``monkeypatch.setattr`` or any setter that undoes itself."""
    from gmrm_tpu_torch.sampler import dists
    from gmrm_tpu_torch.sampler import gibbs as pgibbs
    from gmrm_tpu_torch.sampler import whole_sweep

    proxy = TorchProxy(script)

    def gamma_draws(gen, shape, device, out=None):
        u = torch.as_tensor(script.value(gen.it, gen.purpose),
                            dtype=torch.float64, device=device)
        assert tuple(u.shape) == tuple(shape), (gen.purpose, u.shape, shape)
        if out is None:
            return (None, None, u)
        out[2].copy_(u)
        return out

    def gamma_from_draws(shape, draws):
        return variate(shape, draws[2]).to(dists._out_dtype(shape))

    setattr_(pgibbs, "torch", proxy)
    setattr_(whole_sweep, "torch", proxy)
    setattr_(pgibbs, "gamma_draws", gamma_draws)
    setattr_(dists, "gamma_draws", gamma_draws)
    setattr_(dists, "gamma_from_draws", gamma_from_draws)


# --------------------------------------------------------------------------
# Both packages from one start, iteration by iteration
# --------------------------------------------------------------------------

def leaves(x):
    """A JAX state's or static inputs' leaves as NumPy (the key dropped)."""
    return {k: (None if v is None else np.asarray(v))
            for k, v in vars(x).items() if k != "key"}


def jax_sharded_start(opt, n_shards):
    """The JAX package's own sharded (mesh, state, static): those that its
    ``run_training_sharded`` hands its first step (its jitted step is
    replaced by one that stops the run there)."""
    import pytest
    from gmrm_tpu.parallel import runner as jpr

    class Captured(Exception):
        pass

    def make_step(mesh, **kw):
        def step(state, static, it):
            raise Captured(mesh, state, static)
        return step

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpr, "make_sharded_step", make_step)
        try:
            jpr.run_training_sharded(opt, n_devices=n_shards, verbose=False)
        except Captured as c:
            return c.args
    raise AssertionError("run_training_sharded reached no step")


# Tolerances: the sweep's of tests/test_sweep_kernel.py:57-66 at float32,
# rtol 1e-4 for the hyperparameters (sigmaG also what the betas'
# differences carry into it, Lockstep.check); 1e-10 relative at float64
# (atol 1e-12 for the entries near 0).
TOL32 = {"betas": (1e-4, 1e-5), "eps": (1e-3, 2e-4), "acum": (1e-3, 1e-5),
         "hyper": (1e-4, 0.0)}
TOL64 = {"betas": (1e-10, 1e-12), "eps": (1e-10, 1e-12),
         "acum": (1e-10, 1e-12), "hyper": (1e-10, 0.0)}
TIE_ULPS = 4


def first_flip(got_comp, want_comp, order, t):
    """Trait t's first marker in processing order ``order`` whose comp
    differs."""
    diff = got_comp[t, order] != want_comp[t, order]
    return int(order[int(np.argmax(diff))])


class Lockstep:
    """Compares the JAX package's and the port's state after each whole
    iteration.  ``orders(it)`` gives (global marker order, u in natural
    global order (T, m)) of iteration ``it``, for the tie check: a trait
    whose comp differs is a fault unless its first differing draw in
    processing order lies within TIE_ULPS ulps of its CDF boundary in the
    JAX package's arithmetic (|u - acum_jax|); such a trait is printed and
    left out from then on."""

    def __init__(self, f64, orders, name, group_of):
        self.tol = TOL64 if f64 else TOL32
        self.fdt = np.float64 if f64 else np.float32
        self.orders = orders
        self.name = name
        self.group_of = np.asarray(group_of)
        self.tied = set()
        self.ties = []

    def check(self, it, want, got):
        """``want``/``got``: dicts of NumPy arrays of eps, betas, comp,
        acum, cass, sigmag, sigmae, pi_est, mu, m0 (marker axis global)."""
        T = want["betas"].shape[0]
        order, u_nat = self.orders(it)
        for t in range(T):
            if t in self.tied or np.array_equal(got["comp"][t],
                                                want["comp"][t]):
                continue
            r = first_flip(got["comp"], want["comp"], order, t)
            u = self.fdt(u_nat[t, r])
            margin = abs(float(u) - float(want["acum"][t, r]))
            ulps = margin / float(np.spacing(u))
            msg = (f"{self.name}: iteration {it}, trait {t}: comp differs "
                   f"first at marker {r} (jax {want['comp'][t, r]}, port "
                   f"{got['comp'][t, r]}); u {float(u):.17g}, acum jax "
                   f"{float(want['acum'][t, r]):.17g}, port "
                   f"{float(got['acum'][t, r]):.17g}; |u - cdf| "
                   f"{margin:.3e} = {ulps:.2f} ulps")
            assert ulps <= TIE_ULPS, msg
            print("TIE " + msg)
            self.ties.append(msg)
            self.tied.add(t)
        keep = [t for t in range(T) if t not in self.tied]
        assert keep, f"{self.name}: every trait tied"
        where = f"{self.name}, iteration {it}"
        for k in ("comp", "cass", "m0"):
            np.testing.assert_array_equal(got[k][keep], want[k][keep],
                                          err_msg=f"{where}: {k}")
        for k in ("betas", "acum", "eps"):
            rtol, atol = self.tol[k]
            np.testing.assert_allclose(got[k][keep], want[k][keep],
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{where}: {k}")
        rtol, atol = self.tol["hyper"]
        # sigmaG of a group is 0.5 (m0 sum beta^2 + V0G S02G) / g: besides
        # rtol, it may move by as much as the betas' differences (held
        # above) move sum beta^2; a group of one small beta carries its
        # float32 noise.
        bw = np.abs(want["betas"].astype(np.float64))
        d = np.abs(got["betas"].astype(np.float64) - want["betas"])
        onehot = self.group_of[:, None] == np.arange(want["sigmag"].shape[1])
        slack = (2.0 * bw * d + d * d) @ onehot             # (T, G)
        sqn = (bw * bw) @ onehot
        m0 = want["m0"].astype(np.float64)
        sg = np.abs(want["sigmag"].astype(np.float64))
        allowed = rtol * sg + sg * m0 * slack / (m0 * sqn + V0G * S02G)
        excess = np.abs(got["sigmag"] - want["sigmag"]) - allowed
        assert (excess[keep] <= 0).all(), (
            f"{where}: sigmag beyond rtol {rtol} and the betas' share: "
            f"got {got['sigmag'][keep]}, want {want['sigmag'][keep]}")
        for k in ("sigmae", "pi_est", "mu"):
            np.testing.assert_allclose(got[k][keep], want[k][keep],
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{where}: {k}")


FIELDS = ("eps", "betas", "comp", "acum", "cass", "sigmag", "sigmae",
          "pi_est", "mu")


def jax_fields(state, aux):
    out = {k: np.asarray(getattr(state, k)) for k in FIELDS}
    out["m0"] = np.asarray(aux.m0)
    return out


def port_fields(states, aux):
    """One state, or a list of per-shard states (marker leaves
    concatenated)."""
    if not isinstance(states, (list, tuple)):
        states = [states]
    first = states[0]
    out = {k: getattr(first, k).detach().cpu().numpy().copy()
           for k in FIELDS}
    for k in ("betas", "comp", "acum"):
        out[k] = torch.cat([getattr(s, k) for s in states],
                           dim=1).cpu().numpy()
    out["m0"] = aux.m0.detach().cpu().numpy().copy()
    return out


def natural_u(script, it, block_mode, m_locals, m_pad):
    """(order, u): the processing order over the global marker axis (shard
    by shard) and each marker's u (T, D * m_pad)."""
    D = script.n_shards
    T = script.T
    orders, u_nat = [], np.zeros((T, D * m_pad))
    for s in range(D):
        o = script.order(it, block_mode, m_locals[s], shard=s)
        u = script.value(it, "u", s)                       # (nb, T, B)
        u_proc = np.moveaxis(u, 1, 0).reshape(T, -1)       # (T, m_pad)
        u_nat[:, s * m_pad + o] = u_proc
        orders.append(s * m_pad + o)
    return np.concatenate(orders), u_nat
