"""Shared workload plumbing for the demo suites.

The port's copy of `jepsen_tpu/suites/_common.py`.

The register suites (repkv, electd) drive the same op mix: unique
monotonically increasing write values (a stale read of an old value is
then unambiguous — with a small value space a re-write of the same
value could legitimately explain it) and CAS expected-old values drawn
from the recent write window so a fraction of CAS ops actually succeed
and constrain the history (an old value the register never held would
make every CAS a no-signal FAIL, and the composed stats checker would
flag the starved op class).
"""

from __future__ import annotations

import itertools
import random
from typing import Callable

from ..generator.core import mix

#: CAS expected-old values come from the last this-many writes.
CAS_WINDOW = 10


def register_workload_gen(
    rng: random.Random,
    *,
    with_cas: bool = True,
) -> Callable[[], object]:
    """() -> generator for the read/write[/cas] register mix.  Returns
    a zero-arg factory because a bare map is one-shot
    (generator.clj:566-570) — every element must be a fn-generator."""
    counter = itertools.count(1)
    last_write = {"v": 1}

    def write():
        v = next(counter)
        last_write["v"] = v
        return {"f": "write", "value": v}

    def cas():
        hi = last_write["v"]
        return {"f": "cas",
                "value": (rng.randrange(max(1, hi - CAS_WINDOW),
                                        hi + 1),
                          next(counter))}

    gens: list = [lambda: {"f": "read", "value": None}, write]
    if with_cas:
        gens.append(cas)

    def factory():
        return mix(gens)

    return factory


def live_register_mix(
    rng: random.Random,
    *,
    with_cas: bool = True,
    lo: int = 0,
    hi: int = 5,
) -> Callable[[], tuple]:
    """() -> (f, value) for the monitor's standing register workload.

    Unlike `register_workload_gen`, the value space is a small *bounded*
    range [lo, hi): a standing run is open-ended, and the rolling
    checker's packed-model interner grows with every distinct value it
    sees — unique monotonically increasing writes would leak memory
    over a week.  The verdict cost is acceptable here because the
    monitor checks online against a live implementation (a stale read
    still has to linearize against the pending writes), mirroring the
    in-process `_OpSource`'s rng.randrange(5) value space."""

    def next_op() -> tuple:
        f = rng.choice(("read", "write", "cas") if with_cas
                       else ("read", "write"))
        if f == "read":
            return "read", None
        if f == "write":
            return "write", rng.randrange(lo, hi)
        return "cas", (rng.randrange(lo, hi), rng.randrange(lo, hi))

    return next_op
