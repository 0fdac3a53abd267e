"""Exact event-walk WGL with a domination quotient.

The port's copy of `jepsen_tpu/checker/wgl_event.py`.

The exhaustive counterpart of the device witness search
(ops/wgl_witness.py): same event-walk formulation — :ok operations are
*barriers* processed in completion order; by induction every earlier-
returning :ok op is linearized in all live configs, so the candidate
rule collapses to "invoked before the current barrier's return" — but
instead of a beam it keeps the FULL reachable configuration set, so a
dead frontier proves non-linearizability (knossos's role for invalid
verdicts, consumed by the reference at checker.clj:214-233).

What makes it survive high-:info histories where the memoized DFS
(wgl_cpu.py) and the level-synchronous BFS (ops/wgl.py) explode:

* Indeterminate ops quotient by PAYLOAD CLASS: two info ops with the
  same encoded (f, a0, a1) are interchangeable as helpers — identical
  transition, no deadline, and availability (inv < barrier ret) only
  ever grows — so a configuration needs only the COUNT of consumed
  ops per class, not their identity.  This is exact, and it collapses
  the antichain blowup of identity-based member sets (consuming w3(5)
  vs w7(5) produced incomparable sets whose minimal frontier still
  grew combinatorially).
* Configurations group by (model state, open :ok membership); within a
  group only the ANTICHAIN of pointwise-minimal class-count vectors is
  kept.  Domination is exact: consumed info ops never loosen the
  candidate rule (a non-member info op has ret = ∞ and constrains
  nobody), so a config that consumed pointwise-fewer per class can
  simulate every future of the greater one.
* Between barriers only the *filtered* frontier is carried: configs
  that failed to contain the barrier op die with their whole subtree
  (the closure is recomputed from survivors, which is complete because
  linearization is monotone).

Exact verdicts both ways; `max_configs`/`time_limit_s` degrade to
"unknown" like the reference's timeout.
"""

from __future__ import annotations

import time
from typing import Optional

from ..history.packed import ST_OK, PackedOps
from ..models.base import PackedModel
from .wgl_cpu import WGLResult


def check_wgl_event(
    packed: PackedOps,
    pm: PackedModel,
    *,
    max_configs: int = 5_000_000,
    time_limit_s: Optional[float] = None,
    report_configs: int = 10,
) -> WGLResult:
    t0 = time.monotonic()
    n = packed.n
    if n == 0 or packed.n_ok == 0:
        return WGLResult(valid=True, configs_explored=1,
                         elapsed_s=time.monotonic() - t0)

    inv = packed.inv.tolist()
    ret = packed.ret.tolist()
    f = packed.f.tolist()
    a0 = packed.a0.tolist()
    a1 = packed.a1.tolist()
    status = packed.status.tolist()
    step = pm.py_step
    init = tuple(pm.init_state)

    is_info = [status[i] != ST_OK for i in range(n)]
    ok_rows = [i for i in range(n) if not is_info[i]]
    bars = sorted(ok_rows, key=lambda i: ret[i])

    # Info payload classes: identity never matters, only the count of
    # consumed ops per class vs the count available.
    class_of: dict[tuple, int] = {}
    info_class = [0] * n
    for i in range(n):
        if is_info[i]:
            key = (f[i], a0[i], a1[i])
            info_class[i] = class_of.setdefault(key, len(class_of))
    n_classes = len(class_of)
    class_ops = [None] * n_classes  # one representative (f, a0, a1)
    for key, c in class_of.items():
        class_ops[c] = key
    zero_counts = (0,) * n_classes

    explored = 0
    passed_mask = 0  # barriers already passed: members everywhere
    # Frontier: {(state, ok_members_mask): [count-vector antichain]}
    frontier: dict[tuple, list[tuple]] = {(init, 0): [zero_counts]}
    avail_upto = 0            # rows with index < avail_upto are available
    avail_ok: list[int] = []  # available, un-barriered :ok rows
    avail_counts = [0] * n_classes

    def insert(store: dict, state, okm: int, cnt: tuple) -> bool:
        """Antichain insert over count vectors; True if genuinely new."""
        key = (state, okm)
        chain = store.get(key)
        if chain is None:
            store[key] = [cnt]
            return True
        keep = []
        for other in chain:
            le = ge = True
            for x, y in zip(other, cnt):
                if x > y:
                    le = False
                if x < y:
                    ge = False
            if le:   # other ≤ cnt pointwise: dominated
                return False
            if not ge:
                keep.append(other)
            # other ≥ cnt (strictly somewhere): drop other
        keep.append(cnt)
        store[key] = keep
        return True

    for a in bars:
        r = ret[a]
        # New rows became available before this barrier's return.
        while avail_upto < n and inv[avail_upto] < r:
            h = avail_upto
            if is_info[h]:
                avail_counts[info_class[h]] += 1
            else:
                avail_ok.append(h)
            avail_upto += 1

        # Closure from the frontier over available candidates, pruned
        # by domination, then filtered on membership of `a`.
        seen: dict[tuple, list[tuple]] = {}
        queue: list[tuple] = []
        for (state, okm), chain in frontier.items():
            for cnt in chain:
                if insert(seen, state, okm, cnt):
                    queue.append((state, okm, cnt))
        survivors: dict[tuple, list[tuple]] = {}
        a_bit = 1 << a

        while queue:
            state, okm, cnt = queue.pop()
            explored += 1
            if explored > max_configs:
                return WGLResult(
                    valid="unknown", configs_explored=explored,
                    reason="config-limit",
                    elapsed_s=time.monotonic() - t0,
                )
            if not (explored & 0xFFF) and time_limit_s is not None:
                if time.monotonic() - t0 > time_limit_s:
                    return WGLResult(
                        valid="unknown", configs_explored=explored,
                        reason="time-limit",
                        elapsed_s=time.monotonic() - t0,
                    )
            if okm & a_bit:
                insert(survivors, state, okm, cnt)
                continue
            # :ok candidates (early linearization of open ops + a).
            for h in avail_ok:
                h_bit = 1 << h
                if okm & h_bit:
                    continue
                ns, legal = step(state, f[h], a0[h], a1[h])
                if not legal:
                    continue
                if insert(seen, ns, okm | h_bit, cnt):
                    queue.append((ns, okm | h_bit, cnt))
            # Info candidates, one per class with spare availability.
            for c in range(n_classes):
                if cnt[c] >= avail_counts[c]:
                    continue
                fc, a0c, a1c = class_ops[c]
                ns, legal = step(state, fc, a0c, a1c)
                if not legal:
                    continue
                cnt2 = cnt[:c] + (cnt[c] + 1,) + cnt[c + 1:]
                if insert(seen, ns, okm, cnt2):
                    queue.append((ns, okm, cnt2))

        if not survivors:
            # Dead frontier: `a` cannot be linearized from any
            # reachable configuration — non-linearizable.
            final = []
            for (state, okm), chain in list(frontier.items())[:report_configs]:
                members = okm | passed_mask
                final.append({
                    "linearized": [i for i in range(n)
                                   if members >> i & 1],
                    "info-consumed": {
                        repr(class_ops[c]): k
                        for c, k in enumerate(chain[0]) if k
                    },
                    "state": list(state),
                    "missing_ok_ops": [a],
                })
            return WGLResult(
                valid=False, configs_explored=explored,
                final_configs=final, crashed_at=a,
                elapsed_s=time.monotonic() - t0,
            )

        # `a` is now a guaranteed member everywhere: drop it from the
        # candidate pool and from the ok-membership key (its bit is
        # implied), keeping keys compact.
        avail_ok = [h for h in avail_ok if h != a]
        passed_mask |= a_bit
        frontier = {}
        for (state, okm), chain in survivors.items():
            okm2 = okm & ~a_bit
            for cnt in chain:
                insert(frontier, state, okm2, cnt)

    return WGLResult(
        valid=True, configs_explored=explored,
        elapsed_s=time.monotonic() - t0,
    )
