"""Read-write register workload (tests/cycle/wr.clj:10-43 equivalent).

The port's copy of `jepsen_tpu/workloads/wr.py`: transactions of
["w", k, v] / ["r", k, v] micro-ops, checked by the Elle-equivalent
rw-register analysis, whose cycle screen runs on opts["device"]
("cuda" by default, "cpu", or "off" for the host search alone).
"""

from __future__ import annotations

import random
import threading
from typing import Optional

from .. import client as jc
from ..checker.elle import WrChecker, WrGen
from ..generator.core import FnGen
from ..history import OK


class InMemoryWrClient(jc.Client):
    """Atomic multi-register store: whole transactions under one lock."""

    def __init__(self, state=None, lock=None):
        self.state = state if state is not None else {}
        self.lock = lock or threading.Lock()

    def open(self, test, node):
        return InMemoryWrClient(self.state, self.lock)

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


def workload(opts: Optional[dict] = None) -> dict:
    opts = opts or {}
    gen = WrGen(
        key_count=opts.get("key-count", 10),
        min_txn_length=opts.get("min-txn-length", 1),
        max_txn_length=opts.get("max-txn-length", 4),
        rng=random.Random(opts.get("seed")),
    )
    return {
        "name": "rw-register",
        "generator": FnGen(gen),
        "checker": WrChecker(
            opts.get("consistency-model", "serializable"),
            device=opts.get("device", "cuda"),
        ),
        "client": InMemoryWrClient(),
    }
