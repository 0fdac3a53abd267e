"""CPU reference Wing–Gong–Lowe linearizability search.

The port's copy of `jepsen_tpu/checker/wgl_cpu.py` (`WGLResult` and
`check_wgl_cpu`; the host-model search waits for a later slice).  It
reimplements the core of `knossos.wgl/analysis`, which Jepsen's
checker.clj:214-233 consumes, from the Wing–Gong / Lowe papers.

Formulation (shared with the TPU search in ops/wgl.py): a *configuration*
is (S, state) where S is the set of linearized operations (a bitmask) and
`state` the model state after applying them in some order.  From (S,
state), operation a ∉ S may be linearized next iff no other non-member
must precede it, i.e.  inv(a) < min{ret(y) : y ∉ S, y ≠ a}.  Certain
failures are dropped before the search; indeterminate (:info) ops have
ret = ∞, so they never block anyone and may stay un-linearized forever.
The history is linearizable iff some reachable configuration covers every
:ok op.

This is an exact, memoized depth-first search over configurations — the
ground truth the TPU beam search is validated against, and the fallback
when a device search overflows its beam (returns :unknown).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from ..history.packed import ST_OK, PackedOps
from ..models.base import PackedModel

VALID = "valid"
INVALID = "invalid"
UNKNOWN = "unknown"


@dataclass
class WGLResult:
    valid: Any  # True | False | "unknown" (merge semantics: checker.clj:34-55)
    configs_explored: int = 0
    #: why unknown: "config-limit" | "time-limit" | None
    reason: Optional[str] = None
    #: on invalid (and budget-blown unknown): deepest configurations
    #: reached, as dicts for reporting — the WGL death state forensics
    #: dossiers ship
    final_configs: list[dict] = field(default_factory=list)
    #: on invalid: index (packed row) of the op that could not be linearized
    crashed_at: Optional[int] = None
    elapsed_s: float = 0.0

    @property
    def is_valid(self):
        return self.valid is True


def _report_configs(
    deepest: list[tuple[int, tuple[int, ...]]],
    report_configs: int,
    ok_mask: int,
    n: int,
) -> list[dict]:
    """Deepest configurations as reporting dicts (truncation to 10
    mirrors checker.clj:230-233) — shared by the invalid return and the
    budget-blown unknown returns, so forensics dossiers get a death
    state either way."""
    final = []
    for S, state in deepest[:report_configs]:
        missing = [
            i for i in range(n) if (ok_mask >> i) & 1 and not (S >> i) & 1
        ]
        final.append(
            {
                "linearized": [i for i in range(n) if (S >> i) & 1],
                "state": list(state),
                "missing_ok_ops": missing[:10],
            }
        )
    return final


def check_wgl_cpu(
    packed: PackedOps,
    pm: PackedModel,
    *,
    max_configs: int = 5_000_000,
    time_limit_s: Optional[float] = None,
    report_configs: int = 10,
) -> WGLResult:
    """Exact WGL search.  `max_configs`/`time_limit_s` bound the search;
    exceeding either yields valid="unknown" (knossos behaves the same via
    its timeout; result truncation to 10 configs mirrors
    checker.clj:230-233)."""
    t0 = time.monotonic()
    n = packed.n
    if n == 0:
        return WGLResult(valid=True, configs_explored=1, elapsed_s=0.0)

    inv = packed.inv.tolist()
    ret = packed.ret.tolist()
    f = packed.f.tolist()
    a0 = packed.a0.tolist()
    a1 = packed.a1.tolist()
    status = packed.status.tolist()

    ok_mask = 0
    for i in range(n):
        if status[i] == ST_OK:
            ok_mask |= 1 << i
    full = (1 << n) - 1

    # Ops ordered by return: the first two non-members of this order give
    # min1/min2 of ret over non-members.
    ret_order = np.argsort(packed.ret, kind="stable").tolist()

    step = pm.py_step
    init = tuple(pm.init_state)

    # Iterative DFS with memoization on (S, state).
    visited: set[tuple[int, tuple[int, ...]]] = set()
    stack: list[tuple[int, tuple[int, ...]]] = [(0, init)]
    visited.add((0, init))
    explored = 0
    deepest: list[tuple[int, tuple[int, ...]]] = []
    deepest_count = -1

    if ok_mask == 0:
        return WGLResult(valid=True, configs_explored=1, elapsed_s=time.monotonic() - t0)

    while stack:
        explored += 1
        if explored > max_configs:
            return WGLResult(
                valid=UNKNOWN,
                configs_explored=explored,
                reason="config-limit",
                final_configs=_report_configs(
                    deepest, report_configs, ok_mask, n),
                elapsed_s=time.monotonic() - t0,
            )
        if time_limit_s is not None and not (explored & 0x3FF):
            if time.monotonic() - t0 > time_limit_s:
                return WGLResult(
                    valid=UNKNOWN,
                    configs_explored=explored,
                    reason="time-limit",
                    final_configs=_report_configs(
                        deepest, report_configs, ok_mask, n),
                    elapsed_s=time.monotonic() - t0,
                )
        S, state = stack.pop()

        # Track deepest configs for failure reporting.
        cnt = S.bit_count()
        if cnt > deepest_count:
            deepest_count = cnt
            deepest = [(S, state)]
        elif cnt == deepest_count and len(deepest) < report_configs:
            deepest.append((S, state))

        # The argmin-ret non-member bounds the candidate rule; min2 is
        # unneeded because m1 itself is always order-legal.
        m1 = -1
        m1_ret = None
        for i in ret_order:
            if not (S >> i) & 1:
                m1 = i
                m1_ret = ret[i]
                break
        if m1 < 0:
            continue  # everything linearized (ok_mask covered earlier)

        # Candidates: the argmin-ret non-member m1 is always order-legal
        # (inv(m1) < ret(m1) = m1_ret <= m2_ret); every other non-member a
        # is order-legal iff inv(a) < m1_ret.  Since inv ascends with the
        # row index, the scan can stop at the first a with inv >= m1_ret.
        candidates = [m1]
        x = (~S) & full
        while x:
            b = x & -x
            a = b.bit_length() - 1
            x ^= b
            if a == m1:
                continue
            if inv[a] >= m1_ret:
                break
            candidates.append(a)

        done = False
        for a in candidates:
            new_state, legal = step(state, f[a], a0[a], a1[a])
            if not legal:
                continue
            S2 = S | (1 << a)
            if (S2 & ok_mask) == ok_mask:
                done = True
                break
            key = (S2, new_state)
            if key not in visited:
                visited.add(key)
                stack.append(key)
        if done:
            return WGLResult(
                valid=True,
                configs_explored=explored,
                elapsed_s=time.monotonic() - t0,
            )

    # Frontier exhausted without covering all ok ops: not linearizable.
    final = _report_configs(deepest, report_configs, ok_mask, n)
    crashed = None
    if final and final[0]["missing_ok_ops"]:
        crashed = final[0]["missing_ok_ops"][0]
    return WGLResult(
        valid=False,
        configs_explored=explored,
        final_configs=final,
        crashed_at=crashed,
        elapsed_s=time.monotonic() - t0,
    )


