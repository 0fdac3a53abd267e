"""Stock workloads: {generator, checker, model, client} maps, each with
an in-memory reference client so it runs whole-stack with no cluster.

The port's copy of `jepsen_tpu/workloads/__init__.py`, trimmed to the
north-star per-key register (`linearizable_register`) and list-append
(`append`); the other workloads wait for later slices.  `main` runs
either through the CLI:

    python -m jepsen_tpu_torch.workloads test --workload linearizable-register \
        --dummy-ssh --device cpu --key-count 8 --time-limit 10
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from . import append, linearizable_register

__all__ = ["WORKLOADS", "append", "linearizable_register", "main",
           "test_fn"]

#: Workload name -> module.
WORKLOADS = {"linearizable-register": linearizable_register,
             "list-append": append}


def _extra_opts(p: argparse.ArgumentParser) -> None:
    p.add_argument("--workload", choices=sorted(WORKLOADS),
                   default="linearizable-register")
    p.add_argument("--key-count", type=int, default=None)
    p.add_argument("--per-key-limit", type=int, default=None)
    p.add_argument("--threads-per-key", type=int, default=None)
    p.add_argument("--algorithm", default=None,
                   help="linearizability algorithm (default wgl-tpu)")
    p.add_argument("--consistency-model", default=None)
    p.add_argument("--max-txn-length", type=int, default=None)


def test_fn(opts: dict) -> dict:
    """The test map of opts["workload"] under the CLI's options: its
    generator on the client threads for at most opts["time-limit"]
    seconds, the noop nemesis, and the CLI's device for its checkers."""
    from .. import generator as gen

    mod = WORKLOADS[opts.get("workload") or "linearizable-register"]
    wl = mod.workload({k: v for k, v in opts.items() if v is not None})
    return {**wl, "generator": gen.time_limit(
        opts.get("time-limit", 60.0), gen.clients(wl["generator"]))}


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .. import cli

    return cli.run(cli.single_test_cmd(test_fn, name="jepsen-torch",
                                       extra_opts=_extra_opts), argv)


if __name__ == "__main__":
    sys.exit(main())
