"""Long-fork anomaly workload.

The port's copy of `jepsen_tpu/workloads/long_fork.py` (jepsen's
tests/long_fork.clj, spec in its docstring :1-60): writers write each
register key exactly once; readers read a whole group of n keys in one txn.  Under parallel
snapshot isolation, two reads can observe the writes in contradictory
orders — read A sees w1 but not w2 while read B sees w2 but not w1 —
the "long fork" (an instance of G2).  The checker is host code.
"""

from __future__ import annotations

import itertools
import random
import threading
from collections import defaultdict
from typing import Any, Optional

from .. import client as jc
from ..checker.core import Checker
from ..generator.core import PENDING, Generator, fill_in_op
from ..history import OK, History


def read_txn_mops(op_value) -> Optional[dict]:
    """{k: v} for a read txn's mops, or None for a write txn."""
    if not op_value:
        return None
    if any(m[0] != "r" for m in op_value):
        return None
    return {m[1]: m[2] for m in op_value}


class LongForkChecker(Checker):
    """Finds contradictory read pairs (long_fork.clj:62-250 condensed:
    with single-write-per-key groups, two group reads fork iff each
    sees a write the other missed)."""

    def check(self, test: dict, history: History, opts: dict) -> dict:
        reads_by_group: dict[frozenset, list] = defaultdict(list)
        for op in history:
            if not (op.is_ok and op.f == "txn"):
                continue
            r = read_txn_mops(op.value)
            if r is not None and len(r) > 1:
                reads_by_group[frozenset(r.keys())].append((op.index, r))

        forks = []
        for group, reads in reads_by_group.items():
            for i in range(len(reads)):
                for j in range(i + 1, len(reads)):
                    ia, ra = reads[i]
                    ib, rb = reads[j]
                    # a key A saw written that B didn't, and vice versa
                    a_ahead = any(
                        ra[k] is not None and rb[k] is None for k in group
                    )
                    b_ahead = any(
                        rb[k] is not None and ra[k] is None for k in group
                    )
                    if a_ahead and b_ahead:
                        forks.append(
                            {"ops": [ia, ib], "reads": [ra, rb]}
                        )
        return {
            "valid": not forks,
            "early-read-count": sum(len(v) for v in reads_by_group.values()),
            "fork-count": len(forks),
            "forks": forks[:8],
        }


class InMemoryLongForkClient(jc.Client):
    """Atomic txn store over registers."""

    def __init__(self, state=None, lock=None):
        self.state = state if state is not None else {}
        self.lock = lock or threading.Lock()

    def open(self, test, node):
        return InMemoryLongForkClient(self.state, self.lock)

    def invoke(self, test, op):
        with self.lock:
            out = []
            for f, k, v in op.value:
                if f == "w":
                    self.state[k] = v
                    out.append([f, k, v])
                else:
                    out.append(["r", k, self.state.get(k)])
            return op.complete(OK, value=out)

    def reusable(self, test):
        return True


class LongForkGen(Generator):
    """Write each key of the current group once (value 1), read whole
    groups (long_fork.clj:252-332's invariants).

    Emission is tuned for OBSERVABILITY: each group is a burst of
    `reads_per_group` whole-group reads with the group's writes
    injected back-to-back (shuffled order) at a random point in the
    middle.  A fork needs concurrent readers to overlap the short
    interval between the two write commits from both sides — reads
    scattered across fast-churning groups almost never do (measured:
    2 partial sightings in 522 group reads), while a read burst
    around clustered writes crosses the window every group.

    A proper immutable Generator, NOT a stateful fn: the scheduler may
    ask `op` several times (pending polls, races) and discard results,
    so a side-effecting closure silently drops queue entries — a
    measured run lost 2/3 of its emissions, including most writes."""

    __slots__ = ("group_size", "reads_per_group", "seed", "group",
                 "queue")

    def __init__(self, group_size: int = 2, reads_per_group: int = 16,
                 seed: int = 45100, group: int = 0, queue=()):
        if reads_per_group < 1:
            raise ValueError("reads_per_group must be >= 1 (an empty "
                             "group would recurse forever)")
        self.group_size = group_size
        self.reads_per_group = reads_per_group
        self.seed = seed
        self.group = group
        self.queue = tuple(queue)

    def _refilled(self) -> "LongForkGen":
        rng = random.Random(self.seed * 1_000_003 + self.group)
        g = self.group
        keys = list(range(g * self.group_size,
                          (g + 1) * self.group_size))
        read = {"f": "txn", "value": [["r", k, None] for k in keys]}
        order = keys[:]
        rng.shuffle(order)
        # Clamp into the loop's range: a wpos past the end would
        # silently drop the group's writes at small reads_per_group.
        wpos = min(rng.randrange(2, max(3, self.reads_per_group - 2)),
                   self.reads_per_group - 1)
        q: list = []
        for i in range(self.reads_per_group):
            if i == wpos:
                q += [{"f": "txn", "value": [["w", k, 1]]}
                      for k in order]
            q.append(read)
        return LongForkGen(self.group_size, self.reads_per_group,
                           self.seed, g + 1, q)

    def op(self, test, ctx):
        if not self.queue:
            return self._refilled().op(test, ctx)
        op = fill_in_op(self.queue[0], ctx)
        if op is PENDING:
            return (op, self)
        return (op, LongForkGen(self.group_size, self.reads_per_group,
                                self.seed, self.group, self.queue[1:]))


def generator(group_size: int = 2, rng: Optional[random.Random] = None,
              reads_per_group: int = 16):
    rng = rng or random.Random()
    return LongForkGen(group_size, reads_per_group,
                       seed=rng.randrange(2**32))


def workload(opts: Optional[dict] = None) -> dict:
    opts = opts or {}
    n = opts.get("group-size", 2)
    return {
        "name": "long-fork",
        "generator": generator(n, random.Random(opts.get("seed"))),
        "checker": LongForkChecker(),
        "client": InMemoryLongForkClient(),
    }
