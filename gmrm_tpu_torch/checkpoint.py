"""Chain checkpoint/resume of the port (counterpart of gmrm_tpu/checkpoint.py
and of the sharded format v2 of gmrm_tpu/parallel/runner.py:417-558).

A checkpoint holds the ``SamplerState`` fields as NumPy arrays, the last
iteration run (``it``), the count of thinned records written (``n_rec``),
the posterior-mean accumulator ``beta_acc`` (float64, natural marker order),
the seed and a format tag naming the port.  No generator state is saved:
``RngPlan`` keys every draw by (seed, iteration, purpose[, global shard]),
so a chain resumed under the same seed is byte-equal to an uninterrupted
one.  A resume under another seed is refused, and so is a file of
gmrm_tpu (it carries a JAX PRNG key and no tag).

Two layouts, as in the JAX package, each refusing the other:

- one device: ``checkpoint.npz``, the marker state in STORAGE order
  (block-interleaved in wave mode, pad rows included), stamped with the
  layout it was stored in (``layout_of``); a resume under another layout
  is refused (``check_layout``);
- marker-sharded, format v2: one file per process
  (``checkpoint.p{pid}.npz``, ``checkpoint.npz`` with one process) holding
  that process's shards' marker state in NATURAL order with their global
  (start, len) ranges in ``starts``, and the replicated leaves once.  The
  previous save is kept as ``*.prev.npz``; the loader takes the newest
  iteration whose files cover every marker and re-shards it into the
  current layout, so any shard or process count may resume.

Every file is written to a temporary name and then moved into place.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from gmrm_tpu_torch.sampler.state import SamplerState

FORMAT = "gmrm_tpu_torch checkpoint 1"
STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SamplerState))
# The leaves every shard of a process shares, and the marker-indexed ones.
REPLICATED = ("eps", "cass", "sigmag", "sigmae", "pi_est", "mu", "epssum")
SHARDED = ("betas", "comp", "acum")
_INT32 = ("comp", "cass")
LAYOUT_KEYS = ("block_size", "wave_size", "interleave", "m_total")


def checkpoint_path(out_dir: str) -> str:
    return os.path.join(out_dir, "checkpoint.npz")


def sharded_checkpoint_path(out_dir: str, pid: int, n_processes: int) -> str:
    suffix = f".p{pid}" if n_processes > 1 else ""
    return os.path.join(out_dir, f"checkpoint{suffix}.npz")


def _ckpt_files(out_dir: str) -> List[str]:
    """Every checkpoint file in ``out_dir``: current and ``*.prev`` saves
    of any process layout, temporary files left out."""
    files = sorted(glob.glob(os.path.join(out_dir, "checkpoint*.npz")))
    return [f for f in files if not f.endswith(".tmp.npz")]


def _clear_ckpt_files(out_dir: str) -> None:
    """A fresh run removes the checkpoints of the chain before it: a later
    --resume would otherwise merge state from a dead chain that shares an
    iteration number with the new one."""
    for f in _ckpt_files(out_dir):
        os.remove(f)


def layout_of(opt, m_total: int) -> dict:
    """The marker-storage layout of a run whose plan is resolved: the
    interleave permutation depends on the block count and the marker count,
    so state stored under one (block_size, wave, m_total) misaligns against
    a run resolved with another."""
    wave = int(opt.wave_size or 1)
    return {"block_size": int(opt.block_size), "wave_size": wave,
            "interleave": int(wave > 1), "m_total": int(m_total)}


def _write(path: str, arrays: dict, keep_prev: bool = False) -> None:
    tmp = path[:-len(".npz")] + ".tmp.npz"
    np.savez(tmp, **arrays)
    if keep_prev and os.path.exists(path):
        os.replace(path, path[:-len(".npz")] + ".prev.npz")
    os.replace(tmp, path)


def _common(state: SamplerState, fields, it: int, n_rec: int, seed: int,
            layout: dict, beta_acc: np.ndarray) -> dict:
    arrays = {f: getattr(state, f).cpu().numpy() for f in fields}
    arrays.update(format=np.asarray(FORMAT), seed=np.asarray(int(seed)),
                  it=np.asarray(int(it)), n_rec=np.asarray(int(n_rec)),
                  beta_acc=np.asarray(beta_acc, np.float64))
    for k in LAYOUT_KEYS:
        arrays[f"layout_{k}"] = np.asarray(layout[k])
    return arrays


def check_origin(path: str, z, seed: int) -> None:
    """Refuse a file the port did not write, and a resume under another
    seed than the chain's."""
    if "format" not in z.files:
        if "key" in z.files:
            raise ValueError(
                f"{path}: a gmrm_tpu checkpoint (it carries a JAX PRNG key); "
                f"gmrm_tpu_torch draws from torch generators keyed by the "
                f"seed and cannot continue that chain: resume it with "
                f"gmrm_tpu, or restart it here.")
        raise ValueError(f"{path}: not a gmrm_tpu_torch checkpoint.")
    got = int(z["seed"])
    if got != int(seed):
        raise ValueError(
            f"{path}: the chain was run with --seed {got}, this run has "
            f"--seed {seed}; a resumed chain continues its own seed's "
            f"draws: pass --seed {got}, or drop --resume to restart.")


def check_layout(path: str, z, expect: dict) -> None:
    """Refuse a single-device checkpoint whose marker-storage layout is not
    this run's (gmrm_tpu/checkpoint.py:66-96)."""
    if "layout_block_size" not in z.files:
        raise ValueError(
            f"{path}: checkpoint predates layout stamping — its marker "
            f"storage order cannot be verified against this run's.  "
            f"Restart the chain.")
    keys = [k for k in LAYOUT_KEYS if f"layout_{k}" in z.files]
    got = {k: int(z[f"layout_{k}"]) for k in keys}
    want = {k: expect[k] for k in keys}
    if got != want:
        hint = ("changed --trunc-markers / dataset?"
                if got.get("m_total") != want.get("m_total")
                else "pass matching --block-size/--wave-size")
        raise ValueError(
            f"{path}: checkpoint marker-storage layout {got} does not "
            f"match the current run's {want}; resuming would misalign "
            f"betas/comp/acum against the re-ordered genotype matrix "
            f"({hint}).")


def _tensor(name: str, arr, device) -> torch.Tensor:
    dtype = torch.int32 if name in _INT32 else torch.float32
    return torch.tensor(np.asarray(arr), dtype=dtype,
                        device=device).contiguous()


def save_checkpoint(path: str, state: SamplerState, it: int,
                    beta_acc: np.ndarray, n_rec: int, seed: int,
                    layout: dict) -> None:
    """The single-device checkpoint: ``state`` in storage order."""
    _write(path, _common(state, STATE_FIELDS, it, n_rec, seed, layout,
                         beta_acc))


def load_checkpoint(path: str, device, seed: int, expect_layout: dict
                    ) -> Tuple[SamplerState, int, np.ndarray, int]:
    """(state on ``device``, it, beta_acc, n_rec) of a single-device
    checkpoint."""
    with np.load(path) as z:
        check_origin(path, z, seed)
        if "starts" in z.files:
            raise ValueError(
                f"{path}: this is a topology-portable SHARDED checkpoint "
                f"(v2, written by parallel.runner.run_training_sharded) — "
                f"resume it with the sharded runner (any device/process "
                f"count), not the single-device runner.")
        check_layout(path, z, expect_layout)
        state = SamplerState(**{f: _tensor(f, z[f], device)
                                for f in STATE_FIELDS})
        return state, int(z["it"]), z["beta_acc"], int(z["n_rec"])


def save_sharded_checkpoint(path: str, states: Sequence[SamplerState],
                            it: int, ranges: Sequence[Tuple[int, int]],
                            inv_orders: Sequence, beta_acc: np.ndarray,
                            n_rec: int, seed: int, layout: dict) -> None:
    """This process's part of a v2 checkpoint: ``states`` per local shard,
    ``ranges`` their global (start, len), ``inv_orders`` their storage ->
    natural maps (None: storage is natural)."""
    arrays = _common(states[0], REPLICATED, it, n_rec, seed, layout,
                     beta_acc)
    for k, (st, (_, ln), inv) in enumerate(zip(states, ranges, inv_orders)):
        for f in SHARDED:
            d = getattr(st, f)[:, :ln].cpu().numpy()
            arrays[f"{f}_{k}"] = d if inv is None else d[:, inv]
    arrays["starts"] = np.asarray(ranges, np.int64).reshape(-1, 2)
    _write(path, arrays, keep_prev=True)


def load_sharded_checkpoint(files: Sequence[str], layout, local_ids,
                            inv_orders, device, seed: int):
    """The newest complete save era of ``files`` re-sharded into the
    current ``layout`` (a ``parallel.runner.ShardLayout``) for the shards
    ``local_ids`` with their storage orders (``inv_orders``, as in
    ``save_sharded_checkpoint``).  Returns (states, it, beta_acc, n_rec):
    one state per local shard, all sharing one set of replicated tensors,
    so the process keeps one residual buffer."""
    m_total = layout.m_total
    by_it = {}
    for fp in files:
        with np.load(fp) as z:
            check_origin(fp, z, seed)
            if "starts" not in z.files:
                raise ValueError(
                    f"{fp}: not a topology-portable sharded checkpoint "
                    f"(written by the single-device runner) — resume it "
                    f"with the single-device runner, or restart the chain.")
            if int(z["layout_m_total"]) != m_total:
                raise ValueError(
                    f"{fp}: checkpoint covers {int(z['layout_m_total'])} "
                    f"markers but this run analyzes {m_total} (changed "
                    f"--trunc-markers / dataset?) — marker state cannot be "
                    f"realigned.")
            by_it.setdefault(int(z["it"]), []).append(
                (fp, z["starts"].copy()))

    def covers(saves):
        covered = np.zeros(m_total, bool)
        for _, starts in saves:
            for s, ln in starts:
                covered[s:s + ln] = True
        return covered.all()

    chosen = next((it for it in sorted(by_it, reverse=True)
                   if covers(by_it[it])), None)
    if chosen is None:
        raise ValueError(
            f"no complete checkpoint era among {list(files)} — every "
            f"iteration's save set leaves marker ranges uncovered")

    rep = n_rec = beta_acc = None
    natural = {}
    for fp, starts in by_it[chosen]:
        with np.load(fp) as z:
            if rep is None:
                rep = {f: z[f] for f in REPLICATED}
                n_rec = int(z["n_rec"])
                beta_acc = np.zeros_like(z["beta_acc"])
            for k, (s, ln) in enumerate(starts):
                for f in SHARDED:
                    d = z[f"{f}_{k}"]
                    if f not in natural:
                        natural[f] = np.zeros((d.shape[0], m_total), d.dtype)
                    natural[f][:, s:s + ln] = d
                beta_acc[:, s:s + ln] = z["beta_acc"][:, s:s + ln]

    replicated = {f: _tensor(f, rep[f], device) for f in REPLICATED}
    states = []
    for i, inv in zip(local_ids, inv_orders):
        s, ln = layout.blocks[i]
        marker = {}
        for f in SHARDED:
            d = natural[f][:, s:s + ln]
            if inv is not None:
                d = d[:, np.argsort(inv)]          # natural -> storage
            pad = np.zeros((d.shape[0], layout.m_pad_shard), d.dtype)
            pad[:, :ln] = d
            marker[f] = _tensor(f, pad, device)
        states.append(SamplerState(**replicated, **marker))
    assert all(st.eps is states[0].eps for st in states)
    return states, chosen, beta_acc, n_rec
