"""One process of a two-process gloo run of the port's sharded trainer
(tests/test_torch_sharded.py).

    python torch_sharded_worker.py RANK WORLD INIT_METHOD DATA_DIR OUT_DIR SHARDS

Trains 10 iterations on the CPU with this process's share of the shards,
then gathers the residual of every rank and checks that all are equal bit
for bit: every process applied the same sums in the same order.
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
    torch.set_num_threads(2)
    init_distributed(init, world, rank, backend="gloo", timeout_seconds=120)
    phens = sorted(os.path.join(data, f) for f in os.listdir(data)
                   if f.endswith(".phen"))
    opt = Options(bed_file=f"{data}/test.bed", dim_file=f"{data}/test.dim",
                  phen_files=phens, group_index_file=f"{data}/test.gri",
                  group_mixture_file=f"{data}/test.grm", iterations=10,
                  seed=42, out_dir=out, block_size=16, wave_size=4,
                  output_thin_rate=2)
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
