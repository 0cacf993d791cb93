"""Multi-process initialization and the collectives of the sharded sweep
(port of gmrm_tpu/parallel/distributed.py, over ``torch.distributed``).

The replacement for MPI_Init and the rank topology (reference
src/main.cpp:10): ``init_distributed`` joins this process into a process
group, NCCL for CUDA tensors and gloo for CPU tensors.  With no arguments
it reads the launcher's environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets them), the analog of
the JAX package's topology discovery on a pod.  Without a process group
every collective here is the identity: one process holds every shard,
which is the single-process mode of
``gmrm_tpu_torch.parallel.runner.run_training_sharded``.

One shard per process on one card each is the production layout; a process
may also own several shards (a contiguous run of shard ids) and runs them
all on its one device.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from gmrm_tpu_torch.parallel.mesh import marker_blocks


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: str = "nccl",
                     timeout_seconds: Optional[float] = None) -> None:
    """Join this process into the global process group.

    ``backend`` "nccl" for runs on CUDA devices (one process per card; the
    process takes card ``LOCAL_RANK``, else ``rank`` modulo the visible
    cards), "gloo" for runs on the CPU.  A sharded run raises when its
    device does not match the group's backend.  ``init_method`` None means
    ``env://`` with rank and world size from the environment.
    """
    kw = {}
    if init_method is not None:
        kw["init_method"] = init_method
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    if timeout_seconds is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_seconds)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs CUDA, which is not "
                               "available (backend='gloo' runs on the CPU)")
        r = rank if rank is not None else int(os.environ.get("RANK", "0"))
        local = int(os.environ.get("LOCAL_RANK",
                                   r % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend=backend, **kw)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_coordinator() -> bool:
    return process_index() == 0


def local_shard_ids(n_shards: int) -> List[int]:
    """The global shard ids this process owns: a contiguous run, the
    remainder to low ranks."""
    world = process_count()
    if n_shards < world:
        raise ValueError(f"{n_shards} shards cannot be spread over {world} "
                         f"processes")
    start, ln = marker_blocks(n_shards, world)[process_index()]
    return list(range(start, start + ln))


class Communicator:
    """The collectives of a sharded run on one device: sums over all
    processes, in place.  The identity when no process group is
    initialised.  ``enabled=False`` skips the sums (the timing-only variant
    of ``measure_sync_seconds``; its results are wrong across processes)."""

    def __init__(self, device, enabled: bool = True):
        self.device = torch.device(device)
        self.enabled = enabled
        if is_initialized():
            want = "nccl" if self.device.type == "cuda" else "gloo"
            have = dist.get_backend()
            if have != want:
                raise RuntimeError(
                    f"the process group runs on {have}, but tensors on "
                    f"{self.device} need {want}; call init_distributed("
                    f"backend={want!r})")

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        if is_initialized() and self.enabled:
            dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return x

    def all_gather_flags(self, flag: bool) -> List[bool]:
        """Every process's flag, in rank order."""
        if not is_initialized():
            return [bool(flag)]
        mine = torch.tensor([int(bool(flag))], dtype=torch.int32,
                            device=self.device)
        out = [torch.zeros_like(mine) for _ in range(process_count())]
        dist.all_gather(out, mine)
        return [bool(int(t)) for t in out]

    def barrier(self, tag: str = "") -> None:
        """Every process reaches ``tag`` before any goes on."""
        if not is_initialized():
            return
        if self.device.type == "cuda":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
