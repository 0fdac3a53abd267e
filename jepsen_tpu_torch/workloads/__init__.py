"""Stock workloads: {generator, checker, model, client} maps, each with
an in-memory reference client so it runs whole-stack with no cluster.

The port's copy of `jepsen_tpu/workloads/__init__.py`: the same eleven
modules, and `queue`, which that file does not import.  `cycle` is a
checker factory with no workload of its own; every other module's
workload is in `WORKLOADS` under its test-map name, and `main` runs any of them through the CLI, its checkers on
--device (cuda by default, or cpu):

    python -m jepsen_tpu_torch.workloads test --workload kafka \
        --dummy-ssh --device cuda --time-limit 10
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from . import (
    adya,
    append,
    bank,
    causal,
    causal_reverse,
    cycle,
    kafka,
    linearizable_register,
    long_fork,
    queue,
    register_set,
    wr,
)

__all__ = [
    "WORKLOADS",
    "adya",
    "append",
    "bank",
    "causal",
    "causal_reverse",
    "cycle",
    "kafka",
    "linearizable_register",
    "long_fork",
    "main",
    "queue",
    "register_set",
    "test_fn",
    "wr",
]

#: Workload name (its test map's "name") -> module.
WORKLOADS = {"adya-g2": adya, "bank": bank, "causal": causal,
             "causal-reverse": causal_reverse, "kafka": kafka,
             "linearizable-register": linearizable_register,
             "list-append": append, "long-fork": long_fork,
             "rw-register": wr, "set": register_set, "total-queue": queue}


def _names(s: str) -> set:
    return {x for x in s.split(",") if x}


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
    p.add_argument("--max-writes-per-key", type=int, default=None)
    p.add_argument("--faults", type=_names, default=None,
                   help="kafka: comma-separated log faults (lose-acked, "
                   "duplicate, skip-offset, unseen)")
    p.add_argument("--fault-rate", type=float, default=None)
    p.add_argument("--final-polls", type=int, default=None)
    p.add_argument("--rate", type=float, default=None,
                   help="total-queue: ops per second")
    p.add_argument("--drain-ops", type=int, default=None,
                   help="total-queue: dequeues in the final drain")


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
