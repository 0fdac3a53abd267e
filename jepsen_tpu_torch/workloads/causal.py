"""Causal-consistency register probe.

The port's copy of `jepsen_tpu/workloads/causal.py` (jepsen's
tests/causal.clj): a
causal order of five ops (read-init, write 1, read, write 2, read) is
issued per key through one worker; the checker replays completions
through a `CausalRegister` model that tracks the register value, a
write counter, and the last-seen position — writes must arrive in
counter order and every op must link to the previously-observed
position (:10-82).

Ops carry two ext fields: "position" (a unique id assigned by the
store for this op) and "link" (the position this op causally follows,
or "init").  The per-key checker runs under IndependentChecker on
opts["device"] ("cuda" by default, or "cpu"), and the workload names
`revive_kv` as its "history-reviver" for a stored run's [key, value]
lists.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from .. import client as jc
from ..checker.core import Checker
from ..generator.independent import concurrent_generator
from ..history import OK, History
from ..parallel.independent import independent_checker
from .linearizable_register import revive_kv


class CausalRegister:
    """causal.clj:32-81, one key's model."""

    __slots__ = ("value", "counter", "last_pos")

    def __init__(self, value: int = 0, counter: int = 0,
                 last_pos: Any = None):
        self.value = value
        self.counter = counter
        self.last_pos = last_pos

    def step(self, op) -> "CausalRegister | str":
        """Next model, or an error string."""
        link = op.ext.get("link")
        pos = op.ext.get("position")
        v = op.value
        if link != "init" and link != self.last_pos:
            return f"cannot link {link!r} to last-seen position {self.last_pos!r}"
        if op.f == "write":
            expect = self.counter + 1
            if v != expect:
                return f"expected value {expect}, attempting to write {v}"
            return CausalRegister(v, expect, pos)
        if op.f == "read-init":
            if self.counter == 0 and v not in (None, 0):
                return f"expected init value 0, read {v}"
            if v is None or v == self.value or (self.counter == 0 and v == 0):
                return CausalRegister(self.value, self.counter, pos)
            return f"can't read {v} from register {self.value}"
        if op.f == "read":
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return f"can't read {v} from register {self.value}"
        return f"unknown f {op.f!r}"


class CausalChecker(Checker):
    """Replays :ok ops through the model (causal.clj:86-108)."""

    def check(self, test: dict, history: History, opts: dict) -> dict:
        s: CausalRegister | str = CausalRegister()
        for op in history:
            if not op.is_ok:
                continue
            nxt = s.step(op)
            if isinstance(nxt, str):
                return {"valid": False, "error": nxt,
                        "op-index": op.index}
            s = nxt
        return {"valid": True,
                "model": {"value": s.value, "counter": s.counter}}


class InMemoryCausalClient(jc.Client):
    """A causally-consistent in-memory store: per-key state with
    positions assigned at apply time; each session op links to the
    session's previously returned position."""

    def __init__(self, state=None, lock=None):
        self.state = state if state is not None else {}
        self.lock = lock or threading.Lock()
        # Causal order is per key here (each 5-op causal order runs
        # against one key): first op on a key links to "init".
        self.last_pos: dict = {}

    def open(self, test, node):
        return InMemoryCausalClient(self.state, self.lock)

    def invoke(self, test, op):
        from ..parallel.independent import KV

        k, payload = op.value.key, op.value.value
        with self.lock:
            st = self.state.setdefault(k, {"value": 0, "pos": 0})
            st["pos"] += 1
            pos = (k, st["pos"])
            link = self.last_pos.get(k, "init")
            if op.f == "write":
                st["value"] = payload
                out = payload
            else:
                out = st["value"]
            self.last_pos[k] = pos
            return op.complete(
                OK, value=KV(k, out), position=pos, link=link,
            )

    def reusable(self, test):
        return True


def generator(keys=None):
    """Five-op causal order per key, one worker per key
    (causal.clj:111-131)."""
    def fgen(k):
        return [
            {"f": "read-init", "value": None},
            {"f": "write", "value": 1},
            {"f": "read", "value": None},
            {"f": "write", "value": 2},
            {"f": "read", "value": None},
        ]

    return concurrent_generator(1, keys or range(1_000_000), fgen)


def workload(opts: Optional[dict] = None) -> dict:
    opts = opts or {}
    return {
        "name": "causal",
        "generator": generator(opts.get("keys")),
        "checker": independent_checker(
            CausalChecker(), device=opts.get("device", "cuda")),
        "client": InMemoryCausalClient(),
        "history-reviver": revive_kv,
    }
