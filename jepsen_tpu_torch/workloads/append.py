"""List-append workload (tests/cycle/append.clj:11-46 equivalent).

The port's copy of `jepsen_tpu/workloads/append.py`: transactions of
["append", k, v] / ["r", k, list] micro-ops, checked by the
Elle-equivalent list-append analysis, whose cycle screen runs on
opts["device"] ("cuda" by default, "cpu", or "off" for the host search
alone).
"""

from __future__ import annotations

import random
import threading
from collections import defaultdict
from typing import Any, Optional

from .. import client as jc
from ..checker.elle import AppendChecker, AppendGen
from ..generator.core import FnGen
from ..history import OK, Op


class InMemoryAppendClient(jc.Client):
    """Serializable in-memory store of lists: applies whole transactions
    atomically under one lock (the trivially-correct reference client)."""

    def __init__(self, state=None, lock=None):
        self.state = state if state is not None else defaultdict(list)
        self.lock = lock or threading.Lock()

    def open(self, test, node):
        return InMemoryAppendClient(self.state, self.lock)

    def invoke(self, test, op):
        with self.lock:
            out = []
            for f, k, v in op.value:
                if f == "append":
                    self.state[k].append(v)
                    out.append([f, k, v])
                else:
                    out.append(["r", k, list(self.state[k])])
            return op.complete(OK, value=out)

    def reusable(self, test):
        return True


def workload(opts: Optional[dict] = None) -> dict:
    opts = opts or {}
    gen = AppendGen(
        key_count=opts.get("key-count", 10),
        min_txn_length=opts.get("min-txn-length", 1),
        max_txn_length=opts.get("max-txn-length", 4),
        max_writes_per_key=opts.get("max-writes-per-key", 32),
        rng=random.Random(opts.get("seed")),
    )
    return {
        "name": "list-append",
        "generator": FnGen(gen),
        "checker": AppendChecker(
            opts.get("consistency-model", "serializable"),
            device=opts.get("device", "cuda"),
        ),
        "client": InMemoryAppendClient(),
    }
