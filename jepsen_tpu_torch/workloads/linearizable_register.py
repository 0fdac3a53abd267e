"""Per-key linearizable register workload — the north-star workload.

The port's copy of `jepsen_tpu/workloads/linearizable_register.py`
(jepsen/tests/linearizable_register.clj:22-53): independent per-key
registers driven by concurrent thread groups, checked by the many-key
linearizability checker (parallel/independent.py), which runs the
witness sweep kernel on the card — its stream instantiation across
keys, its register one in each key's witness.  Caps per-key ops
(`per-key-limit`) because crashed ops blow up search width.

The checkers run on opts["device"] ("cuda" by default, or "cpu").  The
workload also names its "history-reviver", `revive_kv`: a stored
history keeps each KV value as the list [key, value], and
`core.rerun_analysis` turns it back before the checker splits keys.
"""

from __future__ import annotations

import random
import threading
from collections import defaultdict
from typing import Optional

from .. import client as jc
from ..checker.linearizable import linearizable
from ..generator.core import FnGen, limit
from ..generator.independent import concurrent_generator
from ..history import FAIL, OK
from ..models import cas_register
from ..history import History
from ..parallel.independent import KV, independent_checker


class InMemoryKVRegisterClient(jc.Client):
    """Per-key CAS registers; op values are KV tuples."""

    def __init__(self, state=None, lock=None):
        self.state = state if state is not None else {}
        self.lock = lock or threading.Lock()

    def open(self, test, node):
        return InMemoryKVRegisterClient(self.state, self.lock)

    def invoke(self, test, op):
        k, v = op.value.key, op.value.value
        with self.lock:
            if op.f == "write":
                self.state[k] = v
                return op.complete(OK)
            if op.f == "read":
                return op.complete(OK, value=KV(k, self.state.get(k)))
            old, new = v
            if self.state.get(k) == old:
                self.state[k] = new
                return op.complete(OK)
            return op.complete(FAIL)

    def reusable(self, test):
        return True


def _key_gen(per_key_limit: int, rng: random.Random):
    def fgen(key):
        def step():
            r = rng.random()
            if r < 0.4:
                return {"f": "read", "value": KV(key, None)}
            if r < 0.8:
                return {"f": "write", "value": KV(key, rng.randrange(5))}
            return {
                "f": "cas",
                "value": KV(key, (rng.randrange(5), rng.randrange(5))),
            }

        return limit(per_key_limit, FnGen(step))

    return fgen


def _revive_value(f, v):
    """A stored [key, payload] back to KV(key, payload), a cas payload
    [old, new] back to a tuple; any other value as it is."""
    if isinstance(v, list) and len(v) == 2:
        payload = v[1]
        if f == "cas" and isinstance(payload, list):
            payload = tuple(payload)
        return KV(v[0], payload)
    return v


def revive_kv(history: History) -> History:
    """The history with the KV values its stored form flattened to
    lists restored, ops and indices otherwise unchanged."""
    return History([o.replace(value=_revive_value(o.f, o.value))
                    if o.is_client_op and not isinstance(o.value, KV)
                    else o for o in history], reindex=False)


def workload(opts: Optional[dict] = None) -> dict:
    opts = opts or {}
    device = opts.get("device", "cuda")
    rng = random.Random(opts.get("seed"))
    n_keys = opts.get("key-count", 8)
    per_key = opts.get("per-key-limit", 128)
    group = opts.get("threads-per-key", 4)
    algorithm = opts.get("algorithm", "wgl-tpu")
    return {
        "name": "linearizable-register",
        "model": cas_register(),
        "generator": concurrent_generator(
            group, list(range(n_keys)), _key_gen(per_key, rng)
        ),
        "checker": independent_checker(
            linearizable(model=cas_register(), algorithm=algorithm,
                         device=device),
            device=device,
        ),
        "client": InMemoryKVRegisterClient(),
        "history-reviver": revive_kv,
    }
