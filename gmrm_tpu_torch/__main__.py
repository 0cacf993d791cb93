import sys

from gmrm_tpu_torch.cli import main

sys.exit(main())
