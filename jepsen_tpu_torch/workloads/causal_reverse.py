"""Causal-reverse probe: strict-serializability anomaly where T2 is
visible without an earlier T1.

The port's copy of `jepsen_tpu/workloads/causal_reverse.py` (jepsen's
tests/causal_reverse.clj):
concurrent blind writes of distinct integers per key, with transactional
reads of the key's full set.  Replaying the history, every write w_i
records the set of writes already acknowledged before w_i was invoked;
any read that observes w_i must also observe that set (:20-74).  The
per-key checker runs under IndependentChecker on opts["device"]
("cuda" by default, or "cpu"), and the workload names `revive_kv` as
its "history-reviver" for a stored run's [key, value] lists.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from .. import client as jc
from ..checker.core import Checker
from ..generator.core import limit, mix, stagger
from ..generator.independent import concurrent_generator
from ..history import OK, History
from ..parallel.independent import KV, independent_checker
from .linearizable_register import revive_kv


def precedence_graph(history: History) -> dict:
    """{written-value: frozenset(values acked before its invocation)}
    (causal_reverse.clj:21-48)."""
    completed: set = set()
    expected: dict[Any, frozenset] = {}
    for op in history:
        if op.f != "write":
            continue
        if op.is_invoke:
            expected[op.value] = frozenset(completed)
        elif op.is_ok:
            completed.add(op.value)
    return expected


def errors(history: History, expected: dict) -> list[dict]:
    """Reads that observe a write without its predecessors
    (causal_reverse.clj:50-74)."""
    out = []
    for op in history:
        if not (op.is_ok and op.f == "read"):
            continue
        seen = set(op.value or [])
        must: set = set()
        for v in seen:
            must |= expected.get(v, frozenset())
        missing = must - seen
        if missing:
            out.append({
                "op-index": op.index,
                "process": op.process,
                "missing": sorted(missing),
                "expected-count": len(must),
            })
    return out


class CausalReverseChecker(Checker):
    def check(self, test: dict, history: History, opts: dict) -> dict:
        expected = precedence_graph(history)
        errs = errors(history, expected)
        return {"valid": not errs, "errors": errs[:32],
                "error-count": len(errs)}


class InMemoryListClient(jc.Client):
    """Per-key insert-only list with atomic snapshot reads."""

    def __init__(self, state=None, lock=None):
        self.state = state if state is not None else {}
        self.lock = lock or threading.Lock()

    def open(self, test, node):
        return InMemoryListClient(self.state, self.lock)

    def invoke(self, test, op):
        k, v = op.value.key, op.value.value
        with self.lock:
            lst = self.state.setdefault(k, [])
            if op.f == "write":
                lst.append(v)
                return op.complete(OK)
            return op.complete(OK, value=KV(k, list(lst)))

    def reusable(self, test):
        return True


def generator(opts: dict):
    """Mixed reads + unique-value writes per key, n workers per key
    (causal_reverse.clj:76-114)."""
    n = max(1, len(opts.get("nodes") or ["n1"]))
    per_key = opts.get("per-key-limit", 500)

    def fgen(k):
        counter = iter(range(10**9))

        def write():
            return {"f": "write", "value": next(counter)}

        return limit(
            per_key,
            stagger(0.01, mix([{"f": "read", "value": None},
                               write])),
        )

    return concurrent_generator(n, range(1_000_000), fgen)


def workload(opts: Optional[dict] = None) -> dict:
    opts = opts or {}
    return {
        "name": "causal-reverse",
        "generator": generator(opts),
        "checker": independent_checker(
            CausalReverseChecker(), device=opts.get("device", "cuda")),
        "client": InMemoryListClient(),
        "history-reviver": revive_kv,
    }
