"""Adya G2 (anti-dependency cycle) predicate probe.

The port's copy of `jepsen_tpu/workloads/adya.py` (jepsen's
tests/adya.clj): for
each unique key, two concurrent transactions each read a *predicate*
over two tables (any row for this key), and insert into their own
table only if both reads came back empty.  Under serializability at
most one insert can commit per key; two commits form a G2 cycle via
predicate anti-dependencies (:10-56).

Op values are independent tuples (key, [a_id, b_id]) where exactly one
id is set — which one picks the table the txn would insert into.
The per-key checker runs under IndependentChecker on opts["device"]
("cuda" by default, or "cpu"), and the workload names `revive_kv` as
its "history-reviver" for a stored run's [key, value] lists.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Optional

from .. import client as jc
from ..checker.core import Checker
from ..generator.core import once
from ..generator.independent import concurrent_generator
from ..history import FAIL, OK, History
from ..parallel.independent import KV, independent_checker
from .linearizable_register import revive_kv


class G2Checker(Checker):
    """At most one :ok insert per key (adya.clj:58-86)."""

    def check(self, test: dict, history: History, opts: dict) -> dict:
        ok = 0
        for op in history:
            if op.f == "insert" and op.is_ok:
                ok += 1
        return {"valid": ok <= 1, "ok-inserts": ok}


def g2_generator():
    """Two one-shot inserts per key: [nil b-id] and [a-id nil], two
    workers per key (adya.clj:12-56)."""
    ids = itertools.count(1)

    def fgen(k):
        return [
            once({"f": "insert", "value": [None, next(ids)]}),
            once({"f": "insert", "value": [next(ids), None]}),
        ]

    return concurrent_generator(2, range(1_000_000), fgen)


class InMemoryG2Client(jc.Client):
    """Reference client over two in-memory "tables".  `racy=True`
    makes the read-check-insert non-atomic (predicate read outside the
    lock), producing real G2 anomalies for the checker to catch."""

    def __init__(self, state=None, lock=None, racy: bool = False,
                 barrier=None):
        self.state = state if state is not None else {"a": {}, "b": {}}
        self.lock = lock or threading.Lock()
        self.racy = racy
        self.barrier = barrier

    def open(self, test, node):
        return InMemoryG2Client(self.state, self.lock, self.racy,
                                self.barrier)

    def _empty(self, k) -> bool:
        return not (self.state["a"].get(k) or self.state["b"].get(k))

    def invoke(self, test, op):
        k, (a_id, b_id) = op.value.key, op.value.value
        table = "a" if a_id is not None else "b"
        row_id = a_id if a_id is not None else b_id
        if self.racy:
            # Predicate read outside the critical section: both txns
            # can see empty tables and both insert — G2.
            empty = self._empty(k)
            if self.barrier is not None:
                try:
                    self.barrier.wait(timeout=1.0)
                except threading.BrokenBarrierError:
                    pass
            if not empty:
                return op.complete(FAIL)
            with self.lock:
                self.state[table][k] = row_id
            return op.complete(OK)
        with self.lock:
            if not self._empty(k):
                return op.complete(FAIL)
            self.state[table][k] = row_id
            return op.complete(OK)

    def reusable(self, test):
        return True


def workload(opts: Optional[dict] = None) -> dict:
    opts = opts or {}
    return {
        "name": "adya-g2",
        "generator": g2_generator(),
        "checker": independent_checker(
            G2Checker(), device=opts.get("device", "cuda")),
        "client": InMemoryG2Client(racy=opts.get("racy", False)),
        "history-reviver": revive_kv,
    }
