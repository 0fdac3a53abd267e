"""``python -m jepsen_tpu_torch.analysis`` — the standalone lint entry.
Same driver as ``jepsen lint``; needs the standard library alone."""

import argparse
import sys

from .core import add_lint_args, main

if __name__ == "__main__":
    p = argparse.ArgumentParser(
        prog="jepsenlint",
        description="AST-based invariant analysis for the PyTorch port "
        "(device hygiene, lock discipline, framework protocols)",
    )
    add_lint_args(p)
    sys.exit(main(p.parse_args()))
