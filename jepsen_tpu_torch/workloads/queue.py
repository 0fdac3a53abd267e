"""Total-queue workload: every acked enqueue must eventually come out.

The port's copy of `jepsen_tpu/workloads/queue.py`; its checkers
(TotalQueue, Timeline, Stats) are host code, and `core.prepare_test`
phases its drain after the main generator.  The JAX package's workload
names no client (its suites bring theirs); the port's carries
`InMemoryQueueClient`, a FIFO under one lock, so that the workload runs
whole-stack through the CLI as every other stock workload does.

The reference's queue suites (rabbitmq/disque/chronos-shaped) pair a
mixed enqueue/dequeue generator with `checker.total-queue`
(checker.clj:648-708) and a final DRAIN phase that keeps dequeuing
after faults heal, so "still sitting in the queue at test end" is
never mistaken for "lost".  This module reproduces that shape as a
reusable workload map: `{generator, final-generator, checker}` with
unique integer enqueue values.

Semantics the checker enforces (and the drain makes fair):
  lost        acked enqueue that never came out — CONVICTS
  unexpected  dequeue of a value never even attempted — CONVICTS
  duplicated  redelivery (at-least-once) — reported, allowed
  recovered   indeterminate enqueue that surfaced — reported, allowed
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Optional

from .. import client as jc
from ..checker import core as chk
from ..checker.timeline import Timeline
from ..generator.core import FnGen, clients, limit, mix, stagger
from ..history import FAIL, OK


class InMemoryQueueClient(jc.Client):
    """A shared FIFO under one lock: an enqueue appends its value, a
    dequeue takes the head, or fails on an empty queue."""

    def __init__(self, state=None, lock=None):
        self.state = state if state is not None else deque()
        self.lock = lock or threading.Lock()

    def open(self, test, node):
        return InMemoryQueueClient(self.state, self.lock)

    def invoke(self, test, op):
        with self.lock:
            if op.f == "enqueue":
                self.state.append(op.value)
                return op.complete(OK)
            if not self.state:
                return op.complete(FAIL, error="empty")
            return op.complete(OK, value=self.state.popleft())

    def reusable(self, test):
        return True


def workload(opts: Optional[dict] = None) -> dict:
    opts = dict(opts or {})
    counter = itertools.count(1)

    def enqueue():
        return {"f": "enqueue", "value": next(counter)}

    def dequeue():
        return {"f": "dequeue", "value": None}

    # 2:1 enqueue:dequeue keeps a backlog building, so a crash window
    # usually holds acked-but-undelivered records — the thing the
    # checker exists to catch.
    gen = mix([FnGen(enqueue), FnGen(enqueue), FnGen(dequeue)])
    rate = opts.get("rate", 150.0)
    if rate:
        gen = stagger(1.0 / rate, gen)

    # Drain budget: every record in the post-heal log needs one
    # successful single-record dequeue, plus EMPTY misses.  Bounded
    # well above any log this workload's op budget can produce
    # (duplicates included: each restart rewinds the shared cursor
    # once, and the log never exceeds total enqueue attempts).
    drain_ops = opts.get("drain-ops", 8000)

    return {
        "name": "total-queue",
        "generator": gen,
        "final-generator": clients(
            limit(drain_ops, FnGen(dequeue))
        ),
        "checker": chk.compose({
            "total-queue": chk.TotalQueue(),
            "timeline": Timeline(),
            "stats": chk.Stats(),
        }),
        "client": InMemoryQueueClient(),
    }
