"""Synthetic concurrent histories for benchmarks and tests.

The port's copy of `jepsen_tpu/utils/histgen.py random_register_history`,
kept line for line: it draws from Python's `random`, so one seed gives
one history in both packages, which the parity tests rely on.
"""

from __future__ import annotations

import random
from typing import Optional

from ..history.core import History, Op, history


def random_register_history(
    n_ops: int,
    *,
    procs: int = 16,
    info_rate: float = 0.02,
    cas: bool = True,
    n_values: int = 5,
    seed: int = 45100,
    bad: bool = False,
    bad_at: Optional[float] = None,
) -> History:
    """A concurrent cas-register history of ~n_ops operations.

    Each op's effect is applied atomically at completion time, so the
    history is linearizable unless `bad` injects a read of a
    never-written value (at the end) or `bad_at` does so at that
    fraction of the way through.  `info_rate` of ops complete as :info
    (indeterminate) — these stay concurrent with everything after them,
    the width driver for the WGL search."""
    rng = random.Random(seed)
    value: Optional[int] = None
    ops: list[Op] = []
    # process -> (f, payload, as_info) for in-flight ops
    pending: dict[int, tuple] = {}
    started = 0

    def complete(p: int) -> None:
        nonlocal value
        f, payload, as_info = pending.pop(p)
        if as_info:
            # Indeterminate: maybe the effect happened.
            if f == "write" and rng.random() < 0.5:
                value = payload
            elif f == "cas" and rng.random() < 0.5 and value == payload[0]:
                value = payload[1]
            ops.append(Op(type="info", f=f, value=payload, process=p))
            return
        if f == "read":
            ops.append(Op(type="ok", f="read", value=value, process=p))
        elif f == "write":
            value = payload
            ops.append(Op(type="ok", f="write", value=payload, process=p))
        else:  # cas
            if value == payload[0]:
                value = payload[1]
                ops.append(Op(type="ok", f="cas", value=payload, process=p))
            else:
                ops.append(Op(type="fail", f="cas", value=payload, process=p))

    while started < n_ops or pending:
        p = rng.randrange(procs)
        if p in pending:
            complete(p)
        elif started < n_ops:
            fs = ["read", "write", "cas"] if cas else ["read", "write"]
            f = rng.choice(fs)
            if f == "read":
                payload = None
            elif f == "write":
                payload = rng.randrange(n_values)
            else:
                payload = (rng.randrange(n_values), rng.randrange(n_values))
            as_info = f != "read" and rng.random() < info_rate
            pending[p] = (f, payload, as_info)
            ops.append(Op(type="invoke", f=f, value=payload, process=p))
            started += 1
        # else: only pending ops remain; loop drains them.

    if bad:
        ops.append(Op(type="invoke", f="read", value=None, process=0))
        ops.append(Op(type="ok", f="read", value=n_values + 94, process=0))
    if bad_at is not None:
        # A mid-history impossible read on a process id outside the
        # worker range, so it can't collide with an in-flight op.
        at = max(0, min(len(ops), int(bad_at * len(ops))))
        ops[at:at] = [
            Op(type="invoke", f="read", value=None, process=procs),
            Op(type="ok", f="read", value=n_values + 73, process=procs),
        ]
    return history(ops)
