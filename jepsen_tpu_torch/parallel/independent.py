"""Per-key independent checking — `jepsen.independent` on one card.

The port of `jepsen_tpu/parallel/independent.py`: op values are `(k,
v)` pairs (`KV`), the history splits into per-key subhistories, and each
key is checked on its own (the reference's independent.clj:259-377).
When the base checker is a packed-model `Linearizable`, the keys go
through the tier ladder below, compiled as a plan (plan/compiler.py
`run_cohort`: the tiers as pass nodes, knobs from the cost model, the
persistent plan memo when a cache directory is set) and run by the
plan executor (plan/executor.py):

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
tier catches a device fault to fall back, and there is no hand-wired
ladder to fall back to: a kernel that does not build or launch, or a
failure of the plan layer, raises out of `check` (see checker/core.py
`check_safe`).

With a store directory (`opts["dir"]`) each key's verdict and
subhistory go to `independent/<key>/` there, as the reference writes
them.  The batched BFS splits the cohort's keys over a mesh
(parallel/mesh.py): the test map's "mesh", else every card when the
process sees more than one (`checker_mesh`, read by plan/compiler.py
`run_cohort`); a test map's "search-mesh" instead splits the frontier
of each key that runs alone (over 2,000 ops).  The result adds "tiers":
how many keys each tier settled.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
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
from ..utils import bounded_pmap, sanitize_path_part

log = logging.getLogger(__name__)


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
        self._write_key_artifacts(opts, subs, results)
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

    #: Per-key artifact budget: failed and undecided keys always write;
    #: passing keys only up to this many (per-key workloads can carry
    #: tens of thousands of keys).
    MAX_OK_KEY_DIRS = 256

    def _write_key_artifacts(self, opts: dict, subs: dict,
                             results: dict) -> None:
        """store/<test>/independent/<key>/{results.json,history.txt} per
        key, as the reference writes them (independent.clj:355-364).
        Failures never raise: a side output must not change the
        verdict."""
        directory = (opts or {}).get("dir")
        if not directory:
            return

        def jsonable_keys(x):
            # json.dump coerces dict values via default=, never keys.
            if isinstance(x, dict):
                return {k if isinstance(k, str) else repr(k):
                        jsonable_keys(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return [jsonable_keys(v) for v in x]
            return x

        ok_written = 0
        used: set = set()
        for k, res in results.items():
            # Only passing keys count against the budget: False and
            # "unknown" verdicts are the ones to inspect.
            budgeted = res.get("valid") is True
            if budgeted and ok_written >= self.MAX_OK_KEY_DIRS:
                continue
            safe = sanitize_path_part(k)[:80]
            if safe in used:
                # A truncation collision: a stable digest of the full
                # key keeps the names apart and bounded.
                digest = hashlib.sha1(repr(k).encode()).hexdigest()[:10]
                safe = f"{safe[:69]}-{digest}"
            used.add(safe)
            # One key's write failure neither skips later keys nor
            # replaces the computed verdict.
            try:
                d = os.path.join(directory, "independent", safe)
                os.makedirs(d, exist_ok=True)
                with open(os.path.join(d, "results.json"), "w") as f:
                    json.dump(jsonable_keys(res), f, indent=2,
                              default=repr)
                with open(os.path.join(d, "history.txt"), "w",
                          errors="replace") as f:
                    for o in subs.get(k, ()):
                        f.write(str(o) + "\n")
                if budgeted:
                    ok_written += 1
            except Exception as e:  # noqa: BLE001 — side output only
                log.warning("could not write artifacts for key %r: %r",
                            k, e)

    def _check_linearizable(self, test: dict, subs: dict, opts: dict,
                            dev: torch.device, tiers: Counter) -> dict:
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

        from ..plan.compiler import run_cohort

        return run_cohort(self, test, subs,
                          [k for k in keys if k in all_packs], unpackable,
                          all_packs, model, pm, lin, opts, dev, tiers)


def independent_checker(base: Checker, **kw: Any) -> IndependentChecker:
    return IndependentChecker(base, **kw)
