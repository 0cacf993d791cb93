"""One process of a two-process gloo run of the port's sharded trainer
(tests/test_torch_sharded.py).

    python torch_sharded_worker.py RANK WORLD INIT_METHOD DATA_DIR OUT_DIR SHARDS
        [ITERATIONS CHECKPOINT_EVERY RESUME CACHE_DIR]

Trains ITERATIONS iterations (10 without the four optional arguments,
which come together) on the CPU with this process's share of the shards,
then gathers the residual of every rank and checks that all are equal bit
for bit: every process applied the same sums in the same order.
CHECKPOINT_EVERY, RESUME (0 or 1) and CACHE_DIR ("-" for none) are the
options of those names (tests/test_torch_checkpoint_sharded.py).
"""

import os
import sys

import torch
import torch.distributed as dist

from gmrm_tpu_torch.config import Options
from gmrm_tpu_torch.parallel.distributed import (
    Communicator, init_distributed,
)
from gmrm_tpu_torch.parallel.runner import run_training_sharded


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init, data, out, shards = sys.argv[3], sys.argv[4], sys.argv[5], int(
        sys.argv[6])
    iterations, every, resume, cache = sys.argv[7:] or ["10", "0", "0", "-"]
    torch.set_num_threads(2)
    init_distributed(init, world, rank, backend="gloo", timeout_seconds=120)
    phens = sorted(os.path.join(data, f) for f in os.listdir(data)
                   if f.endswith(".phen"))
    opt = Options(bed_file=f"{data}/test.bed", dim_file=f"{data}/test.dim",
                  phen_files=phens, group_index_file=f"{data}/test.gri",
                  group_mixture_file=f"{data}/test.grm",
                  iterations=int(iterations), seed=42, out_dir=out,
                  block_size=16, wave_size=4, output_thin_rate=2,
                  checkpoint_every=int(every), resume=resume == "1",
                  cache_dir="" if cache == "-" else cache)
    res = run_training_sharded(opt, n_devices=shards, device="cpu",
                               verbose=False)
    assert len(res.state) == shards // world
    eps = res.state[0].eps
    gathered = [torch.empty_like(eps) for _ in range(world)]
    dist.all_gather(gathered, eps)
    assert all(torch.equal(g, eps) for g in gathered), "eps differs"
    flags = Communicator("cpu").all_gather_flags(rank == 0)
    assert flags == [r == 0 for r in range(world)], flags
    print("EPS_EQUAL")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
