"""Per-key independent checking — `jepsen.independent` on one card.

The port of `jepsen_tpu/parallel/independent.py`: op values are `(k,
v)` pairs (`KV`), the history splits into per-key subhistories, and each
key is checked on its own (the reference's independent.clj:259-377).
When the base checker is a packed-model `Linearizable`, the keys go
through the reference's hand-wired ladder (its `JEPSEN_PLAN=0` route):

  1. keys that do not pack (or that the model's `validate_packed`
     refuses) run the base checker one by one (the host-model search);
  2. keys an online session (`test["streaming-session"]`, streaming/)
     proved while the run was still going take its verdict, when the
     key's packed digest equals the one the proof covered;
  3. keys over 2,000 ops run `Linearizable("wgl-tpu")` one by one;
  4. the rest ride the stream witness (ops/wgl_stream.py) together;
  5. the keys it leaves undecided settle as a cohort: identical
     subhistories share one verdict (the settle memo), the refutation
     screens refute what they can, the batched BFS (ops/wgl_batched.py)
     runs on the survivors, and the exact CPU engine settles the rest.

Every device tier runs on the checker's `device` (the card by default;
raises when CUDA is asked for but missing).  Unlike the reference, no
tier catches a device fault to fall back: a kernel that does not build
or launch raises out of `check` (see checker/core.py `check_safe`).

Left out: the plan-executor route, mesh sharding, the batched BFS's
packed lanes, per-key artifacts, telemetry.  The result adds "tiers": how many keys each tier
settled.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from collections import Counter, OrderedDict
from typing import Any, NamedTuple, Optional, Union

import numpy as np
import torch

from .. import device as _device
from ..checker.core import Checker, check_safe, merge_valid
from ..checker.linearizable import CPU_ALGORITHMS, Linearizable
from ..history.core import History, Op
from ..history.packed import pack_history
from ..ops import degrade
from ..utils import bounded_pmap

log = logging.getLogger(__name__)

#: Keys longer than this skip the stream and the batched tiers and run
#: the single-history device search (ops/wgl.py) on their own.
LONG_KEY_OPS = 2000


class KV(NamedTuple):
    """A `[key value]` op payload (independent.clj:18-35): a distinct
    type, so a multi-argument payload such as cas `(old, new)` is never
    taken for a keyed value."""

    key: Any
    value: Any

    def __repr__(self) -> str:
        return f"[{self.key!r} {self.value!r}]"


def kv(key: Any, value: Any) -> KV:
    return KV(key, value)


def is_kv(v: Any) -> bool:
    return isinstance(v, KV)


# ---------------------------------------------------------------------------
# Settle-verdict memo
# ---------------------------------------------------------------------------

#: digest -> sanitized settle verdict, a bounded LRU shared by every
#: check in the process: planted-violation and replayed workloads repeat
#: the same bad subhistory across keys and checks.
_SETTLE_MEMO_MAX = 2048
_settle_memo: "OrderedDict[str, dict]" = OrderedDict()
_settle_memo_lock = threading.Lock()

#: Result fields that cite positions in one key's slice of the history;
#: a memo entry is shared by identical subhistories at other positions,
#: so these never ride along.
_POSITIONAL_FIELDS = ("final-configs", "crashed-op", "counterexample-file")


def _settle_digest(p, pm) -> str:
    """The packed history's digest keying the memo: the verdict is a
    function of the (inv, ret, status, f, a0, a1) columns, the model's
    step (named) and its initial state.  src_index is left out, so
    identical subhistories at different offsets collide."""
    h = hashlib.sha256()
    h.update(f"{pm.name}|{tuple(int(v) for v in pm.init_state)}|"
             f"{pm.state_width}".encode())
    for col in (p.inv, p.ret, p.status, p.f, p.a0, p.a1):
        h.update(np.ascontiguousarray(col).tobytes())
    return h.hexdigest()


def _online_digest(sess, pm, sub) -> Optional[str]:
    """The digest of one key's subhistory in the online session's code
    space, for `sess.consume`.  Register encoders intern values in
    first-seen order, so a fresh packed model assigns other codes than
    the session's (which interned in journal order), and the caller's
    own pack could never match the digest the proof recorded.
    Re-packing with the session's encoder instance reuses its interner
    and reproduces the bytes the proof covered.  None (never consume)
    when the session checked another model shape or the re-pack
    fails."""
    spm = sess.pm
    if (spm.name != pm.name
            or tuple(int(v) for v in spm.init_state)
            != tuple(int(v) for v in pm.init_state)
            or spm.state_width != pm.state_width):
        return None
    try:
        return _settle_digest(pack_history(sub, spm.encode), spm)
    except (ValueError, OverflowError):
        return None  # the post-hoc path decides


def _sanitize_settle(res: dict) -> dict:
    """A memo-shareable copy of a settle result: the verdict and its
    metadata without the positional fields."""
    return {k: v for k, v in res.items() if k not in _POSITIONAL_FIELDS}


def _memo_get(digest: str) -> Optional[dict]:
    with _settle_memo_lock:
        r = _settle_memo.get(digest)
        if r is not None:
            _settle_memo.move_to_end(digest)
            return dict(r)
    return None


def _memo_put(digest: str, res: dict) -> None:
    # Only decisive verdicts: an "unknown" is this call's budget, and a
    # later call with more budget must not inherit it.
    if res.get("valid") not in (True, False):
        return
    with _settle_memo_lock:
        _settle_memo[digest] = _sanitize_settle(res)
        _settle_memo.move_to_end(digest)
        while len(_settle_memo) > _SETTLE_MEMO_MAX:
            _settle_memo.popitem(last=False)


def clear_settle_memo() -> None:
    """Empties the settle memo, so the next check runs the cold ladder
    (benchmarks clear it before every repetition)."""
    with _settle_memo_lock:
        _settle_memo.clear()


def invalidate_settle_memo(digest: str) -> None:
    """Evicts one digest's memoized verdict.  The online session
    memoizes a key's proof when the key goes quiet; when the key takes
    more ops later, that entry describes a prefix no finished history
    will equal, so the session drops exactly its own entry."""
    with _settle_memo_lock:
        _settle_memo.pop(digest, None)


# ---------------------------------------------------------------------------
# Splitting
# ---------------------------------------------------------------------------


def history_keys(h: History) -> list:
    """All keys of KV-valued ops, in first-seen order
    (independent.clj:259-269)."""
    seen: dict[Any, None] = {}
    for o in h:
        if is_kv(o.value):
            seen.setdefault(o.value.key, None)
    return list(seen)


def subhistories(h: History) -> dict[Any, History]:
    """Splits a history into per-key histories with the KV values
    unwrapped (independent.clj:271-325).  A completion that lost its KV
    payload (an :info with value None) takes the key of its process's
    pending invocation.  Ops keep their indices in the full history."""
    per_key: dict[Any, list[Op]] = {}
    pending: dict[Any, Any] = {}  # process -> key
    pop = pending.pop
    for o in h:
        val = o.value
        if isinstance(val, KV):
            k = val.key
            if o.is_invoke:
                pending[o.process] = k
            else:
                pop(o.process, None)
            v = val.value
        elif not o.is_invoke and o.process in pending:
            k = pop(o.process)
            v = val
        else:
            continue
        lst = per_key.get(k)
        if lst is None:
            per_key[k] = lst = []
        lst.append(o.replace(value=v))
    return {k: History(ops, reindex=False) for k, ops in per_key.items()}


# ---------------------------------------------------------------------------
# The checker
# ---------------------------------------------------------------------------


class IndependentChecker(Checker):
    """Applies `base` to each key's subhistory and merges validity
    (independent.clj:327-377).  A packed-model `Linearizable` base takes
    the tier ladder of the module docstring on `device`; any other
    checker runs per key under bounded_pmap.  With `streaming` (the
    default), keys proven by the test's online session
    (`test["streaming-session"]`) take its verdict."""

    #: Detail budget for keys the batched BFS already refuted exactly:
    #: the CPU pass there only adds a certificate.
    REFUTED_DETAIL_BUDGET_S = 10.0

    def __init__(self, base: Checker, *, streaming: bool = True,
                 device: Union[str, torch.device, None] = "cuda"):
        self.base = base
        self.streaming = streaming
        self.device = device

    def _per_key(self, checker: Checker, test: dict, subs: dict,
                 keys: list, opts: dict) -> dict:
        rs = bounded_pmap(
            lambda k: check_safe(checker, test, subs[k],
                                 {**opts, "history_key": k}),
            keys)
        return dict(zip(keys, rs))

    def check(self, test: dict, history: History, opts: dict) -> dict:
        dev = _device.resolve(self.device)
        subs = subhistories(history)
        keys = list(subs)
        if not keys:
            return {"valid": True, "results": {}, "key-count": 0}
        tiers: Counter = Counter()
        # The capture collects the degradation steps of the shared tiers
        # (stream, batched BFS) that run outside any key's check.
        with degrade.capture() as steps:
            if isinstance(self.base, Linearizable):
                results = self._check_linearizable(test or {}, subs, opts,
                                                   dev, tiers)
            else:
                results = self._per_key(self.base, test, subs, keys, opts)
        valid = merge_valid(r.get("valid") for r in results.values())
        failures = [k for k, r in results.items() if r.get("valid") is False]
        out = {
            "valid": valid,
            "key-count": len(keys),
            "failures": failures[:32],
            "failure-count": len(failures),
            "results": results,
            "tiers": dict(tiers),
        }
        if steps:
            out["degradations"] = steps
        return out

    def _check_linearizable(self, test: dict, subs: dict, opts: dict,
                            dev: torch.device, tiers: Counter) -> dict:
        from ..ops.wgl_stream import check_wgl_witness_stream

        lin = self.base
        model = lin.model or test.get("model")
        keys = list(subs)
        try:
            pm = model.packed()
        except (NotImplementedError, AttributeError):
            pm = None
        if pm is None or lin.algorithm in CPU_ALGORITHMS + ("settle",):
            tiers["per-key"] += len(keys)
            return self._per_key(lin, test, subs, keys, opts)

        all_packs = {}
        unpackable = []
        for k in keys:
            try:
                p = pack_history(subs[k], pm.encode)
            except ValueError:
                # No packed form for this key (an indeterminate
                # dequeue): the base checker takes the host model.
                unpackable.append(k)
                continue
            if (pm.validate_packed is not None
                    and pm.validate_packed(p) is not None):
                unpackable.append(k)
                continue
            all_packs[k] = p

        results: dict[Any, dict] = {}
        if unpackable:
            tiers["unpackable"] += len(unpackable)
            results.update(self._per_key(lin, test, subs, unpackable, opts))
            keys = [k for k in keys if k in all_packs]

        # Online verdicts: a key whose re-packed digest equals the one
        # its proof recorded; a key that changed since settles here.
        sess = test.get("streaming-session")
        if self.streaming and sess is not None:
            online = {}
            for k in keys:
                d = _online_digest(sess, pm, subs[k])
                r = sess.consume(k, d) if d is not None else None
                if r is not None:
                    online[k] = r
            if online:
                results.update(online)
                tiers["online"] += len(online)
            keys = [k for k in keys if k not in online]

        # Long keys take the single-history device search, built for
        # length; the batched tiers pad every key to the longest.
        long_keys = [k for k in keys if all_packs[k].n > LONG_KEY_OPS]
        keys = [k for k in keys if all_packs[k].n <= LONG_KEY_OPS]
        if long_keys:
            tiers["long"] += len(long_keys)
            long_chk = Linearizable(
                model, "wgl-tpu", beam=lin.beam, max_beam=lin.max_beam,
                time_limit_s=lin.time_limit_s, max_configs=lin.max_configs,
                device=dev)
            results.update(self._per_key(long_chk, test, subs, long_keys,
                                         opts))
        if not keys:
            return results

        # One budget for the tiers below: the stream's time comes out of
        # what the batched BFS and the CPU settle get.
        t_tiers = time.monotonic()

        def budget_left():
            if lin.time_limit_s is None:
                return None
            return max(1.0, lin.time_limit_s - (time.monotonic() - t_tiers))

        stream_v = check_wgl_witness_stream(
            [all_packs[k] for k in keys], pm,
            time_limit_s=lin.time_limit_s, device=dev)
        for k, v in zip(keys, stream_v):
            if v is True:
                results[k] = {
                    "valid": True,
                    "algorithm": "wgl-tpu-stream",
                    "configs-explored": int(all_packs[k].n_ok),
                }
        keys = [k for k, v in zip(keys, stream_v) if v is not True]
        tiers["stream-proven"] += len(stream_v) - len(keys)
        if keys:
            results.update(self._settle_cohort(
                keys, all_packs, subs, model, pm, lin, test, opts,
                budget_left, dev, tiers))
        return results

    def _settle_cohort(self, cohort_keys, all_packs, subs, model, pm, lin,
                       test, opts, budget_left, dev, tiers) -> dict:
        """Decides the keys the stream left undecided, under the shared
        budget, cheapest tier first: the memo (one representative per
        distinct subhistory runs the rest, the others share its
        verdict), the refutation screens, the batched BFS on the screen
        survivors, and the exact CPU settle of the remainder (screen-
        refuted keys for their certificate, BFS-refuted keys for a small
        detail pass, unknowns for the verdict)."""
        from ..checker.refute import check_refute
        from ..ops.wgl_batched import check_wgl_batched

        groups: "OrderedDict[str, list]" = OrderedDict()
        for k in cohort_keys:
            groups.setdefault(_settle_digest(all_packs[k], pm), []).append(k)
        group_result: dict[str, dict] = {}
        reps: list[str] = []
        for d in groups:
            hit = _memo_get(d)
            if hit is not None:
                group_result[d] = hit
            else:
                reps.append(d)
        n_memo = sum(len(groups[d]) for d in group_result)

        def screen_one(d: str):
            b = budget_left()
            try:
                return check_refute(all_packs[groups[d][0]], pm,
                                    time_limit_s=30.0 if b is None
                                    else min(b, 30.0))
            except Exception as e:  # noqa: BLE001 — host numpy, no verdict
                if degrade.is_device_fault(e):
                    raise
                log.warning("refutation screen failed for key %r",
                            groups[d][0], exc_info=True)
                return None  # the search tiers decide

        screened = dict(zip(reps, bounded_pmap(screen_one, reps)))
        survivors = [d for d in reps if screened[d] is None]

        # Batched frontier BFS over the screen survivors, from a small
        # beam: the overflow retries re-batch only the keys that need
        # more (the reference's measured choice).
        device_verdict: dict[str, Any] = {d: None for d in reps}
        device_explored: dict[str, int] = {d: 0 for d in reps}
        if survivors:
            batch = check_wgl_batched(
                [all_packs[groups[d][0]] for d in survivors], pm,
                beam=min(lin.beam, 32), max_beam=max(lin.max_beam, lin.beam),
                time_limit_s=budget_left(), device=dev)
            for i, d in enumerate(survivors):
                device_verdict[d] = batch.valid[i]
                device_explored[d] = int(batch.explored[i])
                if batch.valid[i] is True:
                    group_result[d] = {
                        "valid": True,
                        "algorithm": "wgl-tpu-batched",
                        "configs-explored": int(batch.explored[i]),
                    }
                    _memo_put(d, group_result[d])
                    tiers["batched-proven"] += 1

        todo = [d for d in reps if d not in group_result]

        def settle_one(d: str) -> dict:
            k = groups[d][0]
            dv = device_verdict[d]
            budget = budget_left()
            if dv is False:
                budget = (self.REFUTED_DETAIL_BUDGET_S if budget is None
                          else min(budget, self.REFUTED_DETAIL_BUDGET_S))
            single = Linearizable(model, "settle", time_limit_s=budget,
                                  max_configs=lin.max_configs, device=dev)
            r = check_safe(single, test, subs[k], {**opts, "history_key": k})
            if dv is not None:
                r["device-verdict"] = dv
            if dv is False:
                if r.get("valid") == "unknown":
                    # The detail pass ran out; the BFS's refutation is
                    # exact (no overflow) and stands on its own.
                    r = {
                        "valid": False,
                        "algorithm": "wgl-tpu-batched",
                        "configs-explored": device_explored[d],
                        "device-verdict": False,
                    }
                elif r.get("valid") is True:
                    # Two exact engines disagreeing is a checker bug:
                    # keep the CPU verdict, loudly.
                    log.error("device/CPU verdict mismatch on key %r: "
                              "batched BFS refuted, exact engine proved "
                              "valid; keeping the CPU verdict", k)
            return r

        screen_fired = {d for d in reps if screened[d] is not None}
        for d, r in zip(todo, bounded_pmap(settle_one, todo)):
            group_result[d] = r
            _memo_put(d, r)
            if device_verdict[d] is False:
                tiers["batched-refuted"] += 1
            elif d in screen_fired:
                tiers["screen-refuted"] += 1
            else:
                tiers["cpu-settled"] += 1

        # Fan the verdicts out: a representative keeps its full result
        # (its certificate cites its own slice); the others share the
        # sanitized verdict.
        settled: dict[Any, dict] = {}
        live = set(reps)
        for d, members in groups.items():
            r = group_result[d]
            if d in live:
                settled[members[0]] = r
                extra = members[1:]
                n_memo += len(extra)
            else:
                extra = members  # a memo hit from an earlier check
            for k2 in extra:
                shared = _sanitize_settle(r)
                shared["memo-hit"] = True
                settled[k2] = shared
        tiers["memo-hit"] += n_memo
        return settled
