"""The plain reference of one BayesR Gibbs iteration, in PyTorch.

Written from the sampler's equations (gmrm's bayes.cpp outer loop: the
intercept, the shuffled marker sweep over Gram blocks, the hyperparameter
block) with no kernel, no cache and no batching trick of the program.  It
imports nothing of the program: what it needs of the program's conventions
is frozen here, each named where it is defined:

- the draw scheme: one ``torch.Generator`` per (seed, iteration, purpose),
  seeded from ``numpy.random.SeedSequence``, and the calls that draw each
  purpose's numbers (:func:`draws`); on a marker-sharded run the shuffle
  and the sweep's draws (``SHARD_KEYED``) also keyed by the global shard
  id plus one;
- the storage order of the markers, a stride interleave across blocks at
  W > 1 (:func:`interleave_order`);
- the 2-bit PLINK decode and the phase-plane layout of individuals
  (:func:`decode`, :func:`to_planes`);
- the wave relaxation at W > 1: markers of one wave of a block are drawn
  against the residual as the wave found it (:func:`scan`);
- the sharded block step: at each step every shard draws its block
  against the residual as the step found it, and the residual then takes
  the sum of all shards' updates.

It runs in float64 to judge the program, and in a lower precision in the
program's place as the control.  :func:`iterate` either follows the
program (it takes the program's component where the two differ by a tie
and the program's residual updates, and reports by how much each marker's
draw differs) or produces an iteration of its own.  On a sharded run each
process computes its own shard's part, and ``allsum``, a plain sum over
the processes, gives the residual and the hyperparameters' sums.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

PURPOSES = ("init", "mu", "block_order", "row_order", "u", "z", "sigmag",
            "pi", "sigmae", "marker_order")
ROUNDS = 32                     # Marsaglia-Tsang candidates drawn at once
V0E = S02E = V0G = S02G = 1.0e-4
GUARD = 700.0                   # log-likelihood gap past which a share is 0
MISSING = 0x55                  # a byte of four missing genotypes
# The draws that differ from shard to shard on a marker-sharded run.
SHARD_KEYED = ("block_order", "row_order", "marker_order", "u", "z")


def generator(seed: int, it: int, purpose: str, device,
              shard: Optional[int] = None) -> torch.Generator:
    """The generator of draw ``purpose`` at iteration ``it``, of global
    shard ``shard`` on a sharded run."""
    key = [int(seed), int(it), PURPOSES.index(purpose)]
    if shard is not None and purpose in SHARD_KEYED:
        key.append(int(shard) + 1)
    state = np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(state))
    return g


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def interleave_order(m: int, nblocks: int):
    """Storage row i holds original marker order[i]: consecutive markers
    go to consecutive blocks.  Returns (order, inverse)."""
    order = np.argsort(np.arange(m) % max(nblocks, 1), kind="stable")
    return order, np.argsort(order, kind="stable")


def decode(bed: torch.Tensor, dtype):
    """(rows, mb) packed bytes -> (a, b) (rows, 4 * mb): a the dosage of
    the first allele (00 -> 2, 10 -> 1, 11 -> 0, 01 missing -> 0) and b
    whether the genotype is present, individual 4j + k at column k*mb + j
    (phase planes)."""
    c = bed.to(torch.int32)
    codes = torch.stack([(c >> (2 * k)) & 3 for k in range(4)], dim=1)
    present = codes != 1
    a = torch.where(codes == 0, 2, torch.where(codes == 2, 1, 0)) * present
    return (a.reshape(bed.shape[0], -1).to(dtype),
            present.reshape(bed.shape[0], -1).to(dtype))


def to_planes(v: torch.Tensor, mb_pad: int) -> torch.Tensor:
    """(..., N) per individual -> (..., 4 * mb_pad) phase planes, zero
    past N."""
    out = torch.zeros(v.shape[:-1] + (4 * mb_pad,), dtype=v.dtype,
                      device=v.device)
    n = v.shape[-1]
    out[..., :n] = v
    return out.reshape(*v.shape[:-1], mb_pad, 4).transpose(-1, -2).reshape(
        *v.shape[:-1], 4 * mb_pad)


@dataclass
class Inputs:
    """What the reference knows of a run: the raw inputs in storage order,
    in its own dtype."""
    bed: torch.Tensor        # (m_pad, mb_pad) uint8, pad rows all missing
    na: torch.Tensor         # (T, 4 * mb_pad) 0/1 observed masks
    nonas: torch.Tensor      # (T,)
    group_of: torch.Tensor   # (m_pad,) int64
    mtotgrp: torch.Tensor    # (G,) int64
    cva: torch.Tensor        # (G, K)
    n_total: int
    m_local: int
    block_size: int
    wave: int
    mave: Optional[torch.Tensor] = None   # (T, m_pad), by marker_stats
    msig: Optional[torch.Tensor] = None


def marker_stats(inp: Inputs, dtype, chunk: int = 256):
    """Mean and inverse standard deviation of every marker per trait over
    its observed individuals (the reference's two passes,
    phenotype.cpp:466-556); pad rows 0."""
    m_pad = inp.bed.shape[0]
    na = inp.na.to(dtype)
    T = na.shape[0]
    mave = torch.zeros((T, m_pad), dtype=dtype, device=na.device)
    msig = torch.zeros_like(mave)
    for s in range(0, inp.m_local, chunk):
        e = min(inp.m_local, s + chunk)
        a, b = decode(inp.bed[s:e], dtype)
        sa, sb, saa = na @ a.T, na @ b.T, na @ (a * a).T
        mu = sa / sb
        var = (saa - 2.0 * mu * sa + mu * mu * sb) / (inp.nonas.to(dtype)[:, None] - 1.0)
        mave[:, s:e] = mu
        msig[:, s:e] = 1.0 / torch.sqrt(var)
    inp.mave, inp.msig = mave, msig
    return mave, msig


def raw_gram(bed_rows: torch.Tensor, na: torch.Tensor) -> torch.Tensor:
    """Counts (NT, 2B, 2B) of [A; B] diag(na) [A; B]^T of one block, exact
    in float64."""
    a, b = decode(bed_rows, torch.float64)
    p = torch.cat([a, b])
    return (p[None] * na.to(torch.float64)[:, None, :]) @ p.T


def draws(seed: int, it: int, T: int, G: int, K: int, nblocks: int, B: int,
          m_local: int, block_mode: bool, dtype, device,
          shard: Optional[int] = None) -> dict:
    """Every random number of iteration ``it`` in the program's draw
    scheme; ``dtype`` is the program's run dtype, in which the intercept's
    and the sweep's numbers are drawn; ``shard`` the global shard id on a
    sharded run."""
    m_pad = nblocks * B

    def gen(purpose):
        return generator(seed, it, purpose, device, shard)
    z_mu = torch.randn((T,), generator=gen("mu"), device=device, dtype=dtype)
    if block_mode:
        pi_b = torch.empty((nblocks,), dtype=torch.int64, device=device)
        torch.randperm(nblocks, generator=gen("block_order"), out=pi_b)
        r = torch.rand((nblocks, B), device=device, generator=gen("row_order"))
        blocks = pi_b[:, None] * B + torch.argsort(r, dim=1)
    else:
        r = torch.rand((m_pad,), device=device, generator=gen("marker_order"))
        r = torch.where(torch.arange(m_pad, device=device) < m_local, r, 2.0)
        blocks = torch.argsort(r, stable=True).reshape(nblocks, B)
    u = torch.rand((nblocks, T, B), device=device, dtype=dtype,
                   generator=gen("u"))
    z = torch.randn((nblocks, T, B), device=device, dtype=dtype,
                    generator=gen("z"))
    hyper = {}
    for name, shape in (("sigmag", (T, G)), ("pi", (T, G, K)),
                        ("sigmae", (T,))):
        g = gen(name)
        f64 = torch.float64
        hyper[name] = (
            torch.randn((ROUNDS,) + shape, generator=g, device=device, dtype=f64),
            torch.rand((ROUNDS,) + shape, generator=g, device=device, dtype=f64),
            torch.rand(shape, generator=g, device=device, dtype=f64))
    return dict(z_mu=z_mu, blocks=blocks, u=u, z=z, hyper=hyper)


def gamma(a: torch.Tensor, d3) -> torch.Tensor:
    """Gamma(a, 1) by Marsaglia-Tsang on the candidates ``d3`` (normals,
    uniforms, the boost uniform for a < 1), float64."""
    x, uu, boost = d3
    a = a.to(torch.float64)
    small = a < 1.0
    ab = torch.where(small, a + 1.0, a)
    d = ab - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(uu) < 0.5 * x * x + d - d * v
                    + d * torch.log(torch.where(v > 0, v, 1.0)))
    first = ok.to(torch.int32).argmax(0, keepdim=True)
    g = (d * v).gather(0, first)[0]
    return torch.where(small, g * boost ** (1.0 / a), g)


def inv_scaled_chisq(a, b, d3):
    return (0.5 * a * b) / gamma(0.5 * a, d3)


def tables(sigmag, sigmae, pi_est, cva, nonas, n_total, dtype):
    """Per (trait, group, component) log prior-and-evidence constant lc,
    posterior mean factor rd and posterior sd sqb of the slab."""
    sg = sigmag.to(dtype)
    se = sigmae.to(dtype)[:, None, None]
    cv = cva.to(dtype)[None, :, 1:]
    sgs = torch.where(sg == 0, torch.ones_like(sg), sg)[:, :, None]
    denom = (n_total - 1.0) + (se / sgs) / cv
    zero = torch.zeros(sg.shape + (1,), dtype=dtype, device=sg.device)
    rd = torch.cat([zero, 1.0 / denom], dim=2)
    sqb = torch.cat([zero, torch.sqrt(se / denom)], dim=2)
    nm1 = (nonas.to(dtype) - 1.0)[:, None, None]
    lp = torch.log(pi_est.to(dtype))
    lc = torch.cat([lp[:, :, :1],
                    lp[:, :, 1:] - 0.5 * torch.log((sgs / se) * nm1 * cv + 1.0)],
                   dim=2)
    return lc, rd, sqb


def scan(base, lc, rd, sqb, gram, beta_old, comp_old, acum_old, u, z, live,
         zerob, i2se, wave, follow_comp=None, follow_db=None,
         follow_acum=None, mm=None):
    """The sweep of a batch of blocks, each on its own residual.

    base, beta_old, comp_old, acum_old, u, z, live, zerob: (nb, T, B);
    lc, rd, sqb: (nb, K, T, B); gram (nb, T, B, B); i2se (T,).  A wave of
    ``wave`` markers is drawn against base plus the Gram corrections of
    the waves before it.  With ``follow_comp`` the program's component is
    taken where the reference draws another, and ``follow_db`` (the
    program's beta_old - beta_new of live markers) moves the corrections.
    Returns beta_new, comp_new, acum_new, dbeta and, per marker, the
    distance of u from the reference's CDF edge where the components
    differ (0 elsewhere) and the posterior sd of the drawn component."""
    nb, T, B = base.shape
    K = lc.shape[1]
    mm = mm or products(False)
    corr = torch.zeros_like(base)
    beta_new = torch.empty_like(base)
    acum_new = torch.empty_like(base)
    dbeta = torch.empty_like(base)
    sd = torch.empty_like(base)
    cdf_gap = torch.zeros_like(base)
    flipped = torch.zeros(base.shape, dtype=torch.bool, device=base.device)
    comp_new = torch.empty_like(comp_old)
    for w0 in range(0, B, wave):
        s = slice(w0, w0 + wave)
        num = base[..., s] + corr[..., s]
        q = num * num * i2se[None, :, None]
        L = lc[..., s] + q[:, None] * rd[..., s]
        e = torch.exp(L - L.max(dim=1, keepdim=True).values)
        share = e / e.sum(dim=1, keepdim=True)
        smax = torch.flip(torch.cummax(torch.flip(L, [1]), 1).values, [1])
        smin = torch.flip(torch.cummin(torch.flip(L, [1]), 1).values, [1])
        over = ((smax - L) > GUARD) | ((L - smin) > GUARD)
        cdf = torch.cumsum(torch.where(over, 0.0, share), dim=1)
        hit = u[:, None, :, s] <= cdf
        comp = torch.where(hit.any(1), hit.to(torch.int32).argmax(1),
                           K - 1).to(torch.int32)
        lv, zb, bo = live[..., s], zerob[..., s], beta_old[..., s]
        if follow_comp is not None:
            fc = follow_comp[..., s].to(torch.int32)
            bad = (fc < 0) | (fc >= K)
            fcc = fc.clamp(0, K - 1)
            edge = cdf.gather(1, torch.minimum(fcc, comp).long()[:, None])[:, 0]
            gap = torch.where(bad, torch.inf, (u[..., s] - edge).abs())
            flipped[..., s] = lv & (fc != comp)
            margin = torch.where(flipped[..., s], gap, 0.0)
            comp = torch.where(lv, fcc, comp)
        sel = comp.long()[:, None]
        rd_s = rd[..., s].gather(1, sel)[:, 0]
        sqb_s = sqb[..., s].gather(1, sel)[:, 0]
        samp = torch.where(comp == 0, 0.0, num * rd_s + sqb_s * z[..., s])
        sd[..., s] = torch.where(comp == 0, sqb[:, 1, :, s], sqb_s)
        db = torch.where(lv, bo - samp, 0.0)
        dbeta[..., s] = db
        beta_new[..., s] = torch.where(lv, samp, torch.where(zb, 0.0, bo))
        comp_new[..., s] = torch.where(lv, comp, comp_old[..., s])
        acum_new[..., s] = torch.where(
            lv, cdf.gather(1, sel)[:, 0],
            torch.where(zb, 1.0, acum_old[..., s]))
        if follow_comp is not None:
            cdf_gap[..., s] = torch.maximum(
                margin, (follow_acum[..., s] - acum_new[..., s]).abs())
        if follow_db is not None:
            db = follow_db[..., s]
        corr = corr + mm(db[..., None, :], gram[:, :, s, :])[..., 0, :]
    return dict(beta_new=beta_new, comp_new=comp_new, acum_new=acum_new,
                dbeta=dbeta, cdf_gap=cdf_gap, flipped=flipped, sd=sd)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to TF32's 10 mantissa bits, to nearest:
    the operands of a TF32 product, on any device."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def products(lowp: bool):
    """The matrix product of the reference (``lowp`` False) or of the
    control, whose operands are rounded to TF32 as the card's tensor cores
    round them with TF32 on."""
    if lowp:
        return lambda x, y: tf32(x) @ tf32(y)
    return lambda x, y: x @ y


def iterate(inp: Inputs, state: dict, dr: dict, *, dtype, follow=None,
            check=None, lowp=False, allsum=None) -> dict:
    """One iteration (it > 1) from ``state`` (eps (T, 4 mb_pad), betas,
    comp, acum (T, m_pad), sigmag (T, G), sigmae, mu (T,), pi_est
    (T, G, K)) on the draws ``dr``, in ``dtype``; ``lowp`` rounds the
    operands of every product to TF32 (the control).

    ``follow``, the program's state after the same iteration, makes this
    a judgement: the residual moves by the program's updates, the batch
    scan runs on the blocks ``check`` (processing positions; None: all)
    with the program's components taken at ties, and the result holds the
    reference's numbers beside the program's.  Without it the iteration
    is produced block after block on its own updates.

    ``allsum``, on a sharded run, sums a tensor over the processes, each
    of which holds its own shard in ``inp`` and ``state`` and the same
    replicated leaves: the shards' updates of every block step, and the
    per-group sums of the hyperparameter block.  Judging, the residual
    takes the sum only before each step checked and at the end, since the
    program's updates do not depend on it."""
    return _iterate(inp, state, dr, dtype, follow, check, products(lowp),
                    allsum)


def _iterate(inp, state, dr, dtype, follow, check, mm, allsum=None):
    dev = inp.bed.device
    f = {k: (v.to(dtype) if v.is_floating_point() else v)
         for k, v in state.items()}
    B, W = inp.block_size, inp.wave
    na = inp.na.to(dtype)
    nonas = inp.nonas.to(dtype)
    mave, msig = inp.mave.to(dtype), inp.msig.to(dtype)
    T = na.shape[0]
    G, K = inp.cva.shape
    nblocks = inp.bed.shape[0] // B

    # The intercept.
    eps = f["eps"] + f["mu"][:, None] * na
    sigmae = f["sigmae"]
    mu = torch.sqrt(sigmae / nonas) * dr["z_mu"].to(dtype)
    eps = eps - mu[:, None] * na

    lc, rd, sqb = tables(f["sigmag"], sigmae, f["pi_est"], inp.cva, nonas,
                         float(inp.n_total), dtype)
    i2se = 1.0 / (2.0 * sigmae)
    blocks = dr["blocks"]
    valid = torch.arange(blocks.numel(), device=dev) < inp.m_local
    grp = inp.group_of
    adav = f["sigmag"][:, grp] == 0.0                        # (T, m_pad)
    live_all = valid[None] & ~adav
    zerob_all = valid[None] & adav
    u = dr["u"].to(dtype)
    z = dr["z"].to(dtype)
    nm1 = nonas[:, None] - 1.0

    def per_block(rows):           # operands of the scan, rows (nb, B)
        g = grp[rows]

        def tab(x):                  # (T, G, K) -> (nb, K, T, B)
            return x[:, g].permute(1, 3, 0, 2)

        def mk(x):                   # (T, m_pad) -> (nb, T, B)
            return x[:, rows].transpose(0, 1)
        return dict(lc=tab(lc), rd=tab(rd), sqb=tab(sqb),
                    beta_old=mk(f["betas"]), comp_old=mk(f["comp"]),
                    acum_old=mk(f["acum"]), live=mk(live_all),
                    zerob=mk(zerob_all))

    def xmats(rows):
        a, b = decode(inp.bed[rows], dtype)
        return a, b

    def cdot(a, b, rows):
        ae, be = mm(eps, a.T), mm(eps, b.T)                    # (T, B)
        return msig[:, rows] * (ae - mave[:, rows] * be)

    def update(a, b, rows, db):
        d = msig[:, rows] * db
        return na * (mm(d, a) - mm(mave[:, rows] * d, b))

    def gram(a, b, rows):
        x = (a[None] - mave[:, rows, None] * b[None]) * msig[:, rows, None]
        return mm(x * na[:, None, :], x.transpose(1, 2))       # (T, B, B)

    new = {k: f[k].clone() for k in ("betas", "comp", "acum")}
    if follow is None:
        for k in range(nblocks):
            rows = blocks[k]
            a, b = xmats(rows)
            c = cdot(a, b, rows)
            op = per_block(rows[None])
            res = scan(c[None] + op["beta_old"] * nm1, op["lc"], op["rd"],
                       op["sqb"], gram(a, b, rows)[None], op["beta_old"],
                       op["comp_old"], op["acum_old"], u[k][None], z[k][None],
                       op["live"], op["zerob"], i2se, W, mm=mm)
            upd = update(a, b, rows, res["dbeta"][0])
            eps = eps + (upd if allsum is None else allsum(upd))
            new["betas"][:, rows] = res["beta_new"][0]
            new["comp"][:, rows] = res["comp_new"][0]
            new["acum"][:, rows] = res["acum_new"][0]
        out = dict(eps=eps, betas=new["betas"], comp=new["comp"],
                   acum=new["acum"], mu=mu)
    else:
        fb = follow["betas"].to(dtype)
        fcomp = follow["comp"]
        db_prog = torch.where(live_all, f["betas"] - fb, 0.0)
        check = list(range(nblocks)) if check is None else sorted(check)
        want = set(check)
        cs, gs = [], []
        pend = None if allsum is None else torch.zeros_like(eps)
        for k in range(nblocks):
            rows = blocks[k]
            a, b = xmats(rows)
            if k in want:
                if pend is not None:        # every shard's steps before k
                    eps = eps + allsum(pend)
                    pend.zero_()
                cs.append(cdot(a, b, rows))
                gs.append(gram(a, b, rows))
            if pend is None:
                eps = eps + update(a, b, rows, db_prog[:, rows])
            else:
                pend += update(a, b, rows, db_prog[:, rows])
        if pend is not None:
            eps = eps + allsum(pend)
        rows = blocks[check]                                   # (nc, B)
        op = per_block(rows)
        base = torch.stack(cs) + op["beta_old"] * nm1
        res = scan(base, op["lc"], op["rd"], op["sqb"], torch.stack(gs),
                   op["beta_old"], op["comp_old"], op["acum_old"], u[check],
                   z[check], op["live"], op["zerob"], i2se, W,
                   follow_comp=fcomp[:, rows].transpose(0, 1),
                   follow_db=db_prog[:, rows].transpose(0, 1),
                   follow_acum=follow["acum"].to(dtype)[:, rows].transpose(0, 1),
                   mm=mm)
        fb_c = fb[:, rows].transpose(0, 1)
        fcomp_c = fcomp[:, rows].transpose(0, 1)
        live_c = op["live"]
        stay = (~live_c) & (fcomp_c != op["comp_old"])
        out = dict(eps=eps, betas=fb, comp=fcomp, mu=mu,
                   beta_gap=((fb_c - res["beta_new"]).abs() / res["sd"])
                   .masked_fill(stay, torch.inf),
                   cdf_gap=res["cdf_gap"],
                   flips=int(res["flipped"].sum()))
    # The hyperparameters, from the new state.
    betas, comp = out["betas"], out["comp"]
    live_n = valid[None] & (f["sigmag"][:, grp] != 0.0)
    idx = grp[None] * K + comp.long()
    cass = torch.zeros((T, G * K), dtype=torch.int64, device=dev)
    cass.scatter_add_(1, idx, live_n.to(torch.int64))
    cass = cass.reshape(T, G, K)
    onehot = (grp[:, None] == torch.arange(G, device=dev)[None]).to(dtype)
    beta_sqn = mm(betas * betas, onehot).to(dtype)
    if allsum is not None:
        cass, beta_sqn = allsum(cass), allsum(beta_sqn)
    mtot = inp.mtotgrp
    m0 = torch.where(mtot > 0, mtot - cass[:, :, 0], 0)
    m0f = m0.to(dtype)
    active = (mtot[None] > 0) & (m0 > 0) & (cass.sum(2) > 0)
    a_g = V0G + m0f
    b_g = (beta_sqn * m0f + V0G * S02G) / torch.clamp(a_g, min=1e-30)
    sg = inv_scaled_chisq(a_g, torch.clamp(b_g, min=1e-30),
                          dr["hyper"]["sigmag"]).to(dtype)
    out["sigmag"] = torch.where(mtot[None] > 0, torch.where(active, sg, 0.0),
                                f["sigmag"])
    gp = gamma(cass.to(torch.float64) + 1.0, dr["hyper"]["pi"]).to(dtype)
    out["pi_est"] = torch.where(active[:, :, None],
                                gp / gp.sum(-1, keepdim=True), f["pi_est"])
    # Judging, the block works from the program's residual, as its sweep
    # left it (``eps_gap`` judges that residual apart).
    res_eps = follow["eps"].to(dtype) if follow is not None else out["eps"]
    e_sqn = mm(res_eps[:, None, :], res_eps[:, :, None])[:, 0, 0].to(dtype)
    n = float(inp.n_total)
    out["sigmae"] = inv_scaled_chisq(
        torch.full_like(e_sqn, V0E + n), (e_sqn + V0E * S02E) / (V0E + n),
        dr["hyper"]["sigmae"]).to(dtype)
    out["cass"] = cass
    return out
