"""Grow-only set workload: unique adds, then a final read.

The port's copy of `jepsen_tpu/workloads/register_set.py`; its checkers
are the port's SetChecker / SetFull (checker/core.py), host code.

The client/generator side for the reference's set checkers
(checker.clj:257-287 set, :487-612 set-full); jepsen uses this shape in
most DB suites' "set" workloads.
"""

from __future__ import annotations

import itertools
import threading
from typing import Optional

from .. import client as jc
from ..checker.core import SetChecker, SetFull
from ..generator.core import FnGen, phases, repeat, until_ok
from ..history import OK


class InMemorySetClient(jc.Client):
    def __init__(self, state=None, lock=None):
        self.state = state if state is not None else set()
        self.lock = lock or threading.Lock()

    def open(self, test, node):
        return InMemorySetClient(self.state, self.lock)

    def invoke(self, test, op):
        with self.lock:
            if op.f == "add":
                self.state.add(op.value)
                return op.complete(OK)
            return op.complete(OK, value=sorted(self.state))

    def reusable(self, test):
        return True


def generator(full: bool = False, read_fraction: float = 0.1,
              rng=None):
    """Unique adds, then a final read retried until it succeeds
    (the zookeeper.clj:120-127 shape).  With full=True, reads are
    interleaved throughout at `read_fraction` for the set-full
    checker — staleness-hunting suites want a dense read stream
    (repkv uses 0.5)."""
    import random as _random

    counter = itertools.count()
    adds = FnGen(lambda: {"f": "add", "value": next(counter)})
    if full:
        r = rng or _random

        def step():
            if r.random() < read_fraction:
                return {"f": "read"}
            return {"f": "add", "value": next(counter)}

        return FnGen(step)
    return adds


def final_generator():
    # repeat: dicts are one-shot, and the read must retry until it lands
    # (until-ok over repeat, the zookeeper.clj:120-127 shape).
    return until_ok(repeat({"f": "read"}))


def workload(opts: Optional[dict] = None) -> dict:
    opts = opts or {}
    full = bool(opts.get("full"))
    return {
        "name": "set-full" if full else "set",
        "generator": generator(full),
        "final-generator": final_generator(),
        "checker": SetFull(
            linearizable=opts.get("linearizable", False)
        )
        if full
        else SetChecker(),
        "client": InMemorySetClient(),
    }
