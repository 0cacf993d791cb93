"""Faults planted under a sharded run's timed path, to show that the check
which decides ``correct`` fails them: each ``FAULTS[name](chain, warmup,
block_size)`` returns the step that replaces ``sharded.Chain``'s, sound
through the warm-up iterations and broken after.  The benchmark's runs
never plant one; the tests and ``calibrate.py --faults`` do."""

from __future__ import annotations


def unchanged(chain, warmup, block_size):
    """A step that returns the state unchanged."""
    last = {}

    def f(it):
        if it <= warmup or "st" not in last:
            last["st"] = chain(it)
        return last["st"]
    return f


def half_left_out(chain, warmup, block_size):
    """Half of every shard's markers (every other block of its storage
    order) left out of the sweep: their state stays as it was."""
    B = block_size

    def f(it):
        old = [{k: getattr(st, k).clone() for k in ("betas", "comp", "acum")}
               for st in chain.states]
        states, aux = chain(it)
        if it > warmup:
            for st, o in zip(states, old):
                for k, v in o.items():
                    x = getattr(st, k).view(v.shape[0], -1, B)
                    x[:, 1::2] = v.view(v.shape[0], -1, B)[:, 1::2]
        return states, aux
    return f


def exchange_left_out(chain, warmup, block_size):
    """The sums across processes left out: every process sweeps against
    its own shards' updates alone."""
    from gmrm_tpu_torch.parallel.distributed import Communicator

    def f(it):
        if it == warmup + 1:
            chain.comm = Communicator(chain.comm.device, enabled=False)
        return chain(it)
    return f


def altered(chain, warmup, block_size):
    """One marker's new effect, the largest of each shard's first trait,
    altered by 1% where the sweep produces it."""
    def f(it):
        states, aux = chain(it)
        if it > warmup:
            for st in states:
                j = int(st.betas[0].abs().argmax())
                st.betas[0, j] *= 1.01
        return states, aux
    return f


FAULTS = {"unchanged": unchanged, "half_left_out": half_left_out,
          "exchange_left_out": exchange_left_out, "altered": altered}
