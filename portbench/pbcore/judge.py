"""What decides ``correct``: the program's check iteration and its outputs
against the plain reference (pbcore/reference.py).

The reference follows the program from the program's own state at the
end of the window (``before``) through one more iteration on the same
draws, and sets its answer beside the program's (``after``):

- ``beta_gap``: the largest gap between a marker's new effect in the
  program and in the reference, in posterior standard deviations of the
  component drawn, over the blocks checked;
- ``cdf_gap``: the largest gap between the program's CDF value at a
  marker's component and the reference's, or, where the two draw
  different components, how far the uniform lay from the reference's CDF
  edge between them (a tie is a rounding apart), whichever is larger;
- ``eps_gap``: the largest gap between the program's residual and the
  reference's (the start plus every marker's update), over the residual's
  root mean square;
- ``hyper_gap``: the hyperparameter block on the program's own new
  effects, components and residual: the largest relative gap of sigmaG
  and sigmaE, absolute gap of pi, and gap of the intercept in its
  posterior sd;
- ``gram_mismatch`` (cells with a Gram cache): entries of the cache's
  sampled blocks that differ from the exact counts;
- ``record_mismatch``: fields of the thinned records on disk that differ
  from what the run wrote (counts, iterations, and the last record
  against the program's state after the check iteration).

On a cell of several cards (:func:`judge_shard`) every process judges its
own shard, the reference following the sharded block step with its sums
over the processes; the parent takes each number's largest over them.
There ``record_mismatch`` covers each process's marker range of the
``.bet``/``.cpn`` records, and process 0's ``.csv``, and one more number
is compared:

- ``replica_mismatch``: elements of the replicated state (residual,
  sigmaG, sigmaE, pi, intercept, component counts) after the check
  iteration that differ, bit for bit, from process 0's.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from pbcore import data as data_mod
from pbcore import reference as ref

F64 = torch.float64


def block_mode(traffic: dict) -> bool:
    """The block-preserving shuffle: float32 wave mode, which keeps a Gram
    cache; every other plan shuffles markers uniformly."""
    return int(traffic["wave"]) > 1 and traffic["dtype"] == "float32"


def check_blocks(nblocks: int, count: int, seed: int):
    """Processing positions of the blocks whose scan is replayed: all, or
    ``count`` drawn from the seed."""
    if count <= 0 or count >= nblocks:
        return None
    g = torch.Generator().manual_seed(int(seed) % (1 << 62) + 1)
    return sorted(torch.randperm(nblocks, generator=g)[:count].tolist())


def reference_state(before: dict) -> dict:
    st = dict(before)
    st["eps"] = before["eps"].reshape(before["eps"].shape[0], -1)
    return st


def numbers(inp: ref.Inputs, before: dict, after: dict, prog_dtype, seed: int,
            it: int, traffic: dict, shard=None, allsum=None) -> dict:
    """The four gaps of ``after`` (one iteration from ``before``) against
    the reference in float64, and the number of ties at which the two
    drew different components; ``shard`` and ``allsum`` on a sharded run
    (``reference.iterate``)."""
    T = inp.na.shape[0]
    G, K = inp.cva.shape
    B = inp.block_size
    nblocks = inp.bed.shape[0] // B
    dr = ref.draws(seed, it, T, G, K, nblocks, B, inp.m_local,
                   block_mode(traffic), prog_dtype, inp.bed.device, shard)
    check = check_blocks(nblocks, int(traffic["check_blocks"]), seed)
    out = ref.iterate(inp, reference_state(before), dr, dtype=F64,
                      follow=dict({k: after[k] for k in ("betas", "comp", "acum")},
                                  eps=after["eps"].reshape(T, -1)),
                      check=check, allsum=allsum)
    eps_p = after["eps"].reshape(T, -1).to(F64)
    obs = inp.na > 0
    rms = torch.sqrt((out["eps"][obs] ** 2).mean())
    eps_gap = float((eps_p - out["eps"]).abs().max() / rms)

    def rel(p, r):
        p, r = p.to(F64), r.to(F64)
        gap = (p - r).abs() / r.abs().clamp_min(1e-300)
        return float(torch.where((r == 0) & (p == 0), 0.0, gap).max())

    se0 = before["sigmae"].to(F64)
    mu_sd = torch.sqrt(se0 / inp.nonas.to(F64))
    hyper = max(rel(after["sigmag"], out["sigmag"]),
                rel(after["sigmae"], out["sigmae"]),
                float((after["pi_est"].to(F64) - out["pi_est"]).abs().max()),
                float(((after["mu"].to(F64) - out["mu"]).abs() / mu_sd).max()))
    vals = dict(beta_gap=float(out["beta_gap"].max()),
                cdf_gap=float(out["cdf_gap"].max()),
                eps_gap=eps_gap, hyper_gap=hyper)
    bad = [k for k, v in vals.items() if not np.isfinite(v)]
    for k in bad:
        vals[k] = float("inf")
    vals["flips"] = out["flips"]
    return vals


def gram_mismatch(inp: ref.Inputs, program: dict, shared: bool) -> int:
    """Entries of the program's Gram cache, on its sampled natural blocks,
    that differ from the exact counts of the blocks' genotypes."""
    B = inp.block_size
    na = inp.na[:1] if shared else inp.na
    bad = 0
    for i, blk in enumerate(program["gram_blocks"]):
        want = ref.raw_gram(inp.bed[blk * B:(blk + 1) * B], na)
        got = program["gram"][i].to(F64)
        bad += (want.numel() if got.shape != want.shape
                else int((got != want).sum()))
    return bad


def _history(path: str, m: int, kind):
    """(iterations, last record) of a .bet/.cpn history file, or None."""
    item = np.dtype(kind).itemsize
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        if struct.unpack("<I", fh.read(4))[0] != m:
            return None
        rec = 4 + m * item
        if (size - 4) % rec:
            return None
        n = (size - 4) // rec
        its = []
        for r in range(n):
            fh.seek(4 + r * rec)
            its.append(struct.unpack("<I", fh.read(4))[0])
        last = np.fromfile(fh, dtype=kind, count=m) if n else None
    return its, last


def record_mismatch(cell, program: dict) -> int:
    """Fields of the thinned records on disk that differ from what was
    written: record counts and iterations, and the last record (the check
    iteration's) against the program's state, marker by marker in the
    original order."""
    return _records(program, program["after"], cell.m, 0, cell.m,
                    np.argsort(cell.order, kind="stable"), csv=True)


def _records(program, after, m, start, ln, inv, csv) -> int:
    """:func:`record_mismatch` over markers ``start`` .. ``start + ln`` of
    the ``m`` in the records, held in ``after`` in storage order (``inv``
    back to the original), and with ``csv`` over the ``.csv`` rows."""
    files, its_want = program["files"], program["records"]
    bad = 0
    for t, base in enumerate(files["bases"]):
        b = os.path.join(files["dir"], base)
        beta = after["betas"][t, :ln].to(F64).cpu().numpy()[inv]
        comp = after["comp"][t, :ln].cpu().numpy().astype(np.int32)[inv]
        for suffix, kind, want in ((".bet", "<f8", beta), (".cpn", "<i4", comp)):
            got = _history(b + suffix, m, kind)
            if got is None or got[0] != its_want:
                bad += 1 + len(its_want)
                continue
            bad += int((got[1][start:start + ln] != want).sum())
        if not csv:
            continue
        with open(b + ".csv") as fh:
            rows = [r for r in fh.read().splitlines() if r.strip()]
        if len(rows) != len(its_want):
            bad += 1
            continue
        fields = [x.strip() for x in rows[-1].split(",")]
        G = after["sigmag"].shape[1]
        bad += int(int(fields[0]) != its_want[-1])
        vals = np.array([float(x) for x in fields[2:2 + G + 1]])
        prog = np.concatenate([after["sigmag"][t].to(F64).cpu().numpy(),
                               [float(after["sigmae"][t])]])
        bad += int((np.abs(vals - prog) > 1e-15 * np.maximum(1, np.abs(prog))
                    + 5e-16).sum())
    return bad


def judge(spec, cell, program: dict, seed: int) -> dict:
    """The compared numbers, each with its limit."""
    tr = spec.traffic
    inp = data_mod.reference_inputs(cell, tr)
    ref.marker_stats(inp, F64)
    vals = numbers(inp, program["before"], program["after"],
                   program["dtype"], seed, program["records"][-1], tr)
    info = {"flips": vals.pop("flips")}
    if program["gram"] is not None:
        shared = bool(cell.mask.all())
        vals["gram_mismatch"] = gram_mismatch(inp, program, shared)
    vals["record_mismatch"] = record_mismatch(cell, program)
    out = {k: {"value": v, "limit": spec.limits[k]} for k, v in vals.items()}
    out["_info"] = info
    return out


def control(spec, cell, program: dict, seed: int) -> dict:
    """The control: the reference in the program's place, its products
    rounded to TF32 (the precision below the float32 with TF32 off that
    the configuration states), one iteration from the program's state at
    the end of the window; judged as the program is."""
    tr = spec.traffic
    inp = data_mod.reference_inputs(cell, tr)
    ref.marker_stats(inp, F64)
    before, it = program["before"], program["records"][-1]
    T = inp.na.shape[0]
    G, K = inp.cva.shape
    nblocks = inp.bed.shape[0] // inp.block_size
    dr = ref.draws(seed, it, T, G, K, nblocks, inp.block_size, inp.m_local,
                   block_mode(tr), torch.float32, inp.bed.device)
    out = ref.iterate(inp, reference_state(before), dr, dtype=torch.float32,
                      lowp=True)
    return numbers(inp, before, out, torch.float32, seed, it, tr)


REPLICATED = ("eps", "sigmag", "sigmae", "pi_est", "mu", "cass")


def replica_mismatch(after: dict, gather) -> int:
    """Elements of the replicated state that differ, bit for bit, from
    process 0's (``gather(x)``: every process's ``x`` in rank order)."""
    bad = 0
    for k in REPLICATED:
        x = after[k].contiguous()
        bits = x.view(torch.int64 if x.element_size() == 8 else torch.int32)
        every = gather(bits)
        bad += sum(int((y != every[0]).sum()) for y in every[1:])
    return bad


def judge_shard(spec, cell, program: dict, seed: int, ranks) -> dict:
    """The compared numbers of this process's shard of a sharded run
    (``cell`` a ``data.ShardData`` of one shard, ``program`` with one
    entry a shard in ``before``, ``after`` and ``gram``), each with its
    limit; ``ranks`` gives ``allsum`` and ``gather`` over the processes
    and ``rank``."""
    tr = spec.traffic
    inp = data_mod.shard_reference_inputs(cell, tr, 0)
    ref.marker_stats(inp, F64)
    vals = numbers(inp, program["before"][0], program["after"][0],
                   program["dtype"], seed, program["records"][-1], tr,
                   shard=cell.shards[0], allsum=ranks.allsum)
    info = {"flips": vals.pop("flips")}
    if program["gram"][0] is not None:
        shared = bool(cell.mask.all())
        vals["gram_mismatch"] = gram_mismatch(
            inp, dict(program, gram=program["gram"][0]), shared)
    vals["record_mismatch"] = _records(
        program, program["after"][0], cell.m, cell.starts[0],
        cell.m_locals[0], np.argsort(cell.orders[0], kind="stable"),
        csv=ranks.rank == 0)
    vals["replica_mismatch"] = program["replica_mismatch"]
    out = {k: {"value": v, "limit": spec.limits[k]} for k, v in vals.items()}
    out["_info"] = info
    return out


def control_shard(spec, cell, program: dict, seed: int, ranks) -> dict:
    """:func:`control` on a sharded run: the reference in the program's
    place block step after block step, its residual summed over the
    processes at every step, each process judging its own shard."""
    tr = spec.traffic
    inp = data_mod.shard_reference_inputs(cell, tr, 0)
    ref.marker_stats(inp, F64)
    before, it = program["before"][0], program["records"][-1]
    T = inp.na.shape[0]
    G, K = inp.cva.shape
    nblocks = inp.bed.shape[0] // inp.block_size
    dr = ref.draws(seed, it, T, G, K, nblocks, inp.block_size, inp.m_local,
                   block_mode(tr), torch.float32, inp.bed.device,
                   cell.shards[0])
    out = ref.iterate(inp, reference_state(before), dr, dtype=torch.float32,
                      lowp=True, allsum=ranks.allsum)
    return numbers(inp, before, out, torch.float32, seed, it, tr,
                   shard=cell.shards[0], allsum=ranks.allsum)


def merge(per_rank: list) -> dict:
    """Each compared number's largest over the processes, with its limit;
    the ties summed."""
    out = {}
    for checks in per_rank:
        for k, c in checks.items():
            if k.startswith("_"):
                continue
            if k not in out or c["value"] > out[k]["value"]:
                out[k] = dict(c)
    out["_info"] = {"flips": sum(c["_info"]["flips"] for c in per_rank)}
    return out


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for k, c in checks.items()
               if not k.startswith("_"))
