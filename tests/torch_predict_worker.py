"""One process of a two-process gloo run of the port's predict mode
(tests/test_torch_predict.py).

    python torch_predict_worker.py RANK WORLD INIT_METHOD CLI_ARGS...

Joins the process group, then runs the port's command line on the CPU with
CLI_ARGS (``--predict ...``): each process writes its markers' lines of
the one ``.mlma``.
"""

import sys

import torch
import torch.distributed as dist

from gmrm_tpu_torch import cli
from gmrm_tpu_torch.parallel.distributed import init_distributed


def main():
    rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(2)
    init_distributed(init, world, rank, backend="gloo", timeout_seconds=120)
    rc = cli.main(sys.argv[4:], device="cpu")
    dist.destroy_process_group()
    print(f"PREDICT_RC {rc}")
    sys.exit(rc)


if __name__ == "__main__":
    main()
