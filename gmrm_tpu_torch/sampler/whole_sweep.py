"""The default iteration (W > 1, the whole-sweep kernel) with its host work
taken off the path.

``gibbs_iteration`` issues some 240 small eager operations around the one
launch of the sweep kernel, and on the card the host, not the device, then
sets the pace.  :class:`WholeSweepIteration` computes the same iteration,
bit for bit, as three host calls after the draws:

1. the draws, eager, from the same ``RngPlan`` generators in the same
   order as ``gibbs_iteration``, written into persistent buffers (the
   gamma variates of the hyperparameter block as their normals, uniforms
   and boost, ``dists.gamma_draws``);
2. one CUDA graph of everything before the sweep: the intercept step, the
   block order and row order from the draws, the group-level scan tables
   and the casts;
3. the sweep kernel, launched eagerly (a cooperative launch, counted as
   every launch of the kernel is), the marker state updated in place;
4. a second CUDA graph of everything after it: the component counts, the
   hyperparameter block's arithmetic, and the new state written in place.

Iteration 1 (whose sigmaE comes from the residual) and every iteration on
the CPU run the same code eagerly; the first eager iteration is the
capture's warm-up.  A capture that fails raises.  The state passed in is
updated in place and returned by every call.
"""

from __future__ import annotations

import torch

from gmrm_tpu_torch import trace
from gmrm_tpu_torch.ops.sweep_kernel import (
    SweepBlocks, build_sweep_tables, stamp_summary,
)
from gmrm_tpu_torch.sampler.dists import RngPlan, gamma_buffers
from gmrm_tpu_torch.sampler.gibbs import (
    IterAux, _natural_cass, hyper_block_from_draws, hyper_draws, hyper_shapes,
)
from gmrm_tpu_torch.sampler.state import SamplerState, StaticInputs


class WholeSweepIteration:
    """``gibbs_iteration(state, static, it, rng, block_size=B, wave=W,
    shuffle=...)`` for W > 1 on the whole-sweep kernel, as a callable
    ``step(it) -> (state, IterAux)`` that owns ``state`` and updates it in
    place.  The ``IterAux`` tensors are overwritten by the next call."""

    def __init__(self, state: SamplerState, static: StaticInputs,
                 rng: RngPlan, *, block_size: int, wave: int,
                 shuffle: bool = True):
        B = block_size
        T, m_pad = state.betas.shape
        if (wave < 2 or B % wave or m_pad % B
                or static.gram_cache is None):
            raise ValueError(
                f"the whole-sweep iteration needs wave {wave} > 1 dividing "
                f"B={B}, m_pad={m_pad} a multiple of B and a Gram cache")
        if state.comp.dtype != torch.int32 or state.cass.dtype != torch.int32:
            raise ValueError("state.comp and state.cass must be int32")
        dev = state.eps.device
        f32 = torch.float32
        G, K = static.cva.shape
        self.state, self.static, self.rng = state, static, rng
        self.B, self.wave, self.shuffle = B, wave, shuffle
        self.nblocks = nblocks = m_pad // B
        self.graphed = dev.type == "cuda"
        self.graphs = None
        self.warm = False
        # Operands of the sweep that do not change along the chain.
        nt = static.gram_cache.shape[1]
        self.na_in = (static.na[:1] if nt == 1 else static.na).contiguous()
        self.grp = static.group_of.to(torch.int32)
        self.nonas = static.nonas.to(f32)
        self.n_total = torch.tensor(static.n_total, dtype=f32, device=dev)
        self.sweep = SweepBlocks()
        # The draws' persistent buffers.
        self.z_mu = torch.empty((T,), dtype=f32, device=dev)
        self.pi_b = torch.empty((nblocks,), dtype=torch.int64, device=dev)
        self.r = torch.empty((nblocks, B), dtype=f32, device=dev)
        self.u = torch.empty((nblocks, T, B), dtype=f32, device=dev)
        self.z = torch.empty((nblocks, T, B), dtype=f32, device=dev)
        self.hyper = {name: gamma_buffers(shape, dev)
                      for name, shape in hyper_shapes(T, G, K).items()}

    def _draw(self, it):
        """Every random number of iteration ``it``, eagerly, in the order
        and from the generators of ``gibbs_iteration``."""
        rng, T = self.rng, self.z_mu.shape[0]
        torch.randn((T,), generator=rng.gen(it, "mu"), out=self.z_mu)
        if self.shuffle:
            torch.randperm(self.nblocks,
                           generator=rng.gen(it, "block_order"),
                           out=self.pi_b)
            torch.rand(self.r.shape, generator=rng.gen(it, "row_order"),
                       out=self.r)
        torch.rand(self.u.shape, generator=rng.gen(it, "u"), out=self.u)
        torch.randn(self.z.shape, generator=rng.gen(it, "z"), out=self.z)
        G, K = self.static.cva.shape
        hyper_draws(lambda name: rng.gen(it, name), T, G, K,
                    self.z_mu.device, out=self.hyper)

    def _pre(self, first):
        """Everything before the sweep (``_intercept_step``,
        ``block_order`` and ``marker_sweep``'s tables and casts).  Returns
        the sweep's per-iteration operands."""
        st, static = self.state, self.static
        na, nonas, B = static.na, static.nonas, self.B
        eps = st.eps
        eps += st.mu[:, None, None] * na
        if first:
            sigmae = 0.5 * (eps * eps).sum(dim=(1, 2)) / nonas
        else:
            sigmae = st.sigmae
        mu_new = st.epssum / nonas + torch.sqrt(sigmae / nonas) * self.z_mu
        eps -= mu_new[:, None, None] * na
        st.mu.copy_(mu_new)
        if self.shuffle:
            blocks = self.pi_b[:, None] * B + torch.argsort(self.r, dim=1)
        else:
            blocks = torch.arange(self.nblocks * B,
                                  device=eps.device).reshape(-1, B)
        blk_idx = blocks[:, 0] // B
        win = blocks - blk_idx[:, None] * B
        tables = build_sweep_tables(st.sigmag, sigmae, st.pi_est, static.cva,
                                    static.cvai, nonas, self.n_total)
        i2se = (1.0 / (2.0 * sigmae.to(torch.float32))).contiguous()
        return (blk_idx.to(torch.int32), win.to(torch.int32).contiguous(),
                tables, i2se)

    def _sweep(self, ops):
        """The sweep kernel, the marker state updated in place; stamped
        while a profiler records."""
        st, static = self.state, self.static
        blk_idx, win, (lc, rd, sqb), i2se = ops
        self.sweep(static.bed, blk_idx, win, static.m_local,
                   static.gram_cache, st.eps, self.na_in, static.mave,
                   static.msig, st.betas, st.comp, st.acum, self.grp, self.u,
                   self.z, st.sigmag, lc, rd, sqb, i2se, self.nonas,
                   wave=self.wave, out=(st.betas, st.comp, st.acum),
                   stamps=self._stamps() if trace.recording() else None)

    def _stamps(self):
        """Kernel 7/8's stamp buffer for this sweep (``trace.sweep_stamps``),
        where the sweep is one launch on the card; else None."""
        if not self.graphed:
            return None
        T, B = self.u.shape[1:]
        shape = self.sweep.stamp_shape(
            T, B, self.static.bed.shape[1], self.na_in.shape[0],
            self.static.cva.shape[1], self.wave, self.nblocks)
        return (None if shape is None else trace.sweep_stamps(
            "sweep_blocks", shape, self.u.device, stamp_summary))

    def _post(self):
        """Everything after the sweep (``_natural_cass``, ``hyper_block``),
        the new state written in place.  Returns (m0, e_sqn)."""
        st, static = self.state, self.static
        K = static.cva.shape[1]
        cass = _natural_cass(st.comp, static.group_of, st.sigmag,
                             static.m_local, K)
        sigmag, sigmae, pi_est, m0, e_sqn = hyper_block_from_draws(
            st.betas, cass, st.eps, st.sigmag, st.pi_est, static, self.hyper)
        st.cass.copy_(cass)
        st.sigmag.copy_(sigmag)
        st.sigmae.copy_(sigmae)
        st.pi_est.copy_(pi_est)
        return m0, e_sqn

    def _capture(self):
        """The two CUDA graphs, around the eager sweep launch."""
        pre, post = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(pre):
            ops = self._pre(first=False)
        with torch.cuda.graph(post, pool=pre.pool()):
            aux = self._post()
        self.graphs = (pre, post, ops, aux)

    def __call__(self, it: int):
        with trace.span("iteration"):
            with trace.span("draws"):
                self._draw(it)
            if it == 1 or not self.graphed or not self.warm:
                with trace.span("pre"):
                    ops = self._pre(first=it == 1)
                with trace.span("sweep"):
                    self._sweep(ops)
                with trace.span("post"):
                    aux = self._post()
                self.warm = True
            else:
                if self.graphs is None:
                    self._capture()
                pre, post, ops, aux = self.graphs
                with trace.span("pre"):
                    pre.replay()
                with trace.span("sweep"):
                    self._sweep(ops)
                with trace.span("post"):
                    post.replay()
        return self.state, IterAux(m0=aux[0], e_sqn=aux[1])
