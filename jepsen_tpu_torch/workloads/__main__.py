"""`python -m jepsen_tpu_torch.workloads`: the workloads' CLI."""

import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
