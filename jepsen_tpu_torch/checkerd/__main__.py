"""`python -m jepsen_tpu_torch.checkerd` — run the checker daemon."""

import sys

from .server import main

if __name__ == "__main__":
    sys.exit(main())
