"""The checker protocol, validity merging, `check_safe` and the stock
checkers.

The port's copy of `jepsen_tpu/checker/core.py` (the reference's
checker.clj): the `Checker` protocol, `check_safe`, `compose`,
`concurrency_limit`, and the stock history checkers — stats,
unhandled exceptions, unique ids, queue, total queue, set, set-full,
counter and log-file pattern.  Results are plain dicts with a "valid"
key: True, False or "unknown", merged with false > unknown > true.

`check_safe` differs from the reference in one way: a device fault (a
kernel that did not build or launch, CUDA asked for and missing, a CUDA
error; `ops.degrade.is_device_fault`) propagates instead of becoming an
"unknown" verdict, so a run meant for the card cannot hide a failing
card or kernel (a `Compose` of checkers raises it too).  Each call is a
`checker.<Name>` telemetry span, as in the reference, and its
wall-clock budget (`budget_s`, or the test's "checker_budget") turns a
checker that runs past it into "unknown", noted in the flight
recorder, which dumps a postmortem.
"""

from __future__ import annotations

import os
import re
import threading
import traceback
from collections import Counter as MultiSet
from collections import defaultdict
from typing import Any, Callable, Iterable, Optional

from .. import telemetry
from ..history.core import INFO, INVOKE, OK, History, Op
from ..ops import degrade
from ..telemetry import flight
from ..utils import bounded_pmap, fraction

UNKNOWN = "unknown"


def valid_rank(v: Any) -> int:
    """false > unknown > true when merging (checker.clj:34-55)."""
    if v is False:
        return 0
    if v is True:
        return 2
    return 1


def merge_valid(vs: Iterable[Any]) -> Any:
    out = True
    for v in vs:
        if valid_rank(v) < valid_rank(out):
            out = v
    return out


class Checker:
    """Analyzes a history and returns {"valid": ...} plus details
    (checker.clj:57-72).  `opts` carries context such as
    "history_key"."""

    def check(self, test: dict, history: History, opts: dict) -> dict:
        raise NotImplementedError

    def __call__(self, test: dict, history: History,
                 opts: Optional[dict] = None) -> dict:
        return check_safe(self, test, history, opts or {})


class FnChecker(Checker):
    def __init__(self, fn: Callable[[dict, History, dict], dict],
                 name: str = "fn"):
        self.fn = fn
        self.name = name

    def check(self, test, history, opts):
        return self.fn(test, history, opts)


def checker(fn: Callable[[dict, History, dict], dict],
            name: str = "fn") -> Checker:
    return FnChecker(fn, name)


def checker_name(c: Any) -> str:
    """A checker's span label: its `name` attribute or its class name."""
    n = getattr(c, "name", None)
    return n if isinstance(n, str) and n else type(c).__name__


#: Sentinel distinguishing "budget expired" from any checker result.
_BUDGET_BLOWN = object()


def check_safe(c: Checker, test: dict, history: History,
               opts: Optional[dict] = None, *,
               budget_s: Optional[float] = None) -> dict:
    """`c.check`, with any exception but a device fault turned into a
    {"valid": "unknown"} result (checker.clj:79-90).  With a budget
    (`budget_s`, by default `test["checker_budget"]` in seconds) the
    check runs in a watchdog thread (`utils.timeout`) and is abandoned
    when it expires: the verdict is "unknown", never a guess.  A checker
    that supervises its own children (`supervises_children`, e.g. the
    checker daemon's client) is exempt, as in the reference."""
    if budget_s is None:
        budget_s = (test or {}).get("checker_budget")
    if budget_s is not None and getattr(c, "supervises_children", False):
        budget_s = None

    def go() -> dict:
        if telemetry.enabled():
            with telemetry.span(f"checker.{checker_name(c)}"):
                return c.check(test, history, opts or {})
        return c.check(test, history, opts or {})

    try:
        if budget_s is None:
            return go()
        from ..utils import timeout as _timeout

        res = _timeout(budget_s * 1000.0, go, default=_BUDGET_BLOWN)
        if res is _BUDGET_BLOWN:
            telemetry.count("checker.budget-exceeded")
            flight.note("checker-budget-exceeded",
                        checker=type(c).__name__, budget_s=budget_s)
            flight.dump("checker-budget-exceeded")
            return {
                "valid": UNKNOWN,
                "error": f"checker {checker_name(c)} exceeded its "
                         f"{budget_s} s wall-clock budget "
                         f"(checker_budget); thread abandoned",
            }
        return res
    except Exception as e:  # noqa: BLE001
        if degrade.is_device_fault(e):
            raise
        return {
            "valid": UNKNOWN,
            "error": repr(e),
            "traceback": traceback.format_exc(),
        }


class Compose(Checker):
    """Runs named sub-checkers in parallel and merges their validity
    (checker.clj:92-104).  Every child goes through check_safe, so a
    crashing child — and, when the test sets a `checker_budget`, a
    hanging one — degrades to its own {"valid": "unknown"} entry while
    the other children's results are still reported and merged.  Without
    a budget a hung child hangs the compose (slow and hung are
    indistinguishable without a clock)."""

    #: check_safe must not wrap the compose itself in the budget: the
    #: children each get it, and an outer budget of the same size would
    #: expire exactly when a hung child does — discarding the siblings'
    #: partial results.
    supervises_children = True

    def __init__(self, checkers: dict[str, Checker]):
        self.checkers = dict(checkers)

    def check(self, test, history, opts):
        names = list(self.checkers)
        results = bounded_pmap(
            lambda name: check_safe(self.checkers[name], test, history, opts),
            names,
        )
        out = dict(zip(names, results))
        out["valid"] = merge_valid(r.get("valid") for r in results)
        return out


def compose(checkers: dict[str, Checker]) -> Checker:
    return Compose(checkers)


class ConcurrencyLimit(Checker):
    """Limits how many instances of a heavy checker run at once
    (checker.clj:106-121).  With host threads the semaphore is shared
    per-instance."""

    def __init__(self, limit: int, inner: Checker):
        self.inner = inner
        self.sem = threading.Semaphore(limit)

    def check(self, test, history, opts):
        with self.sem:
            return self.inner.check(test, history, opts)


def concurrency_limit(limit: int, inner: Checker) -> Checker:
    return ConcurrencyLimit(limit, inner)


# ---------------------------------------------------------------------------
# Trivial checkers
# ---------------------------------------------------------------------------


class NoOp(Checker):
    def check(self, test, history, opts):
        return {"valid": True}


noop = NoOp


class UnbridledOptimism(Checker):
    """It's just fine! (checker.clj:123-127)"""

    def check(self, test, history, opts):
        return {"valid": True}


# ---------------------------------------------------------------------------
# Stats and exceptions
# ---------------------------------------------------------------------------


class Stats(Checker):
    """Ok/info/fail counts per :f; valid iff every f has at least one ok op
    (checker.clj:159-200)."""

    def check(self, test, history, opts):
        by_f: dict[Any, MultiSet] = defaultdict(MultiSet)
        for o in history:
            if not o.is_invoke and o.is_client_op:
                by_f[o.f][o.type] += 1
        stats = {}
        for f, counts in by_f.items():
            n = sum(counts.values())
            stats[f] = {
                "count": n,
                "ok-count": counts[OK],
                "fail-count": counts["fail"],
                "info-count": counts[INFO],
                "ok-fraction": fraction(counts[OK], n),
                "valid": counts[OK] > 0,
            }
        return {
            "valid": merge_valid(s["valid"] for s in stats.values()),
            "count": sum(s["count"] for s in stats.values()),
            "by-f": stats,
        }


class UnhandledExceptions(Checker):
    """Returns exceptional completions grouped by error class so tests can
    surface unexpected client crashes (checker.clj:129-157).  Always
    valid — informational."""

    def check(self, test, history, opts):
        by_class: dict[str, list] = defaultdict(list)
        for o in history:
            if o.is_invoke:
                continue
            err = o.ext.get("exception") or o.ext.get("error")
            if err is None:
                continue
            cls = o.ext.get("exception_class") or (
                type(err).__name__ if not isinstance(err, str) else "error"
            )
            by_class[cls].append(o.to_dict())
        return {
            "valid": True,
            "exceptions": {
                k: {"count": len(v), "example": v[0]} for k, v in by_class.items()
            },
        }


class UniqueIds(Checker):
    """Checks that all added (ok) values are distinct (checker.clj:710-747)."""

    def check(self, test, history, opts):
        seen = MultiSet()
        attempted = 0
        for o in history:
            if o.is_ok and o.is_client_op:
                seen[_hashable(o.value)] += 1
                attempted += 1
        dups = {k: c for k, c in seen.items() if c > 1}
        return {
            "valid": not dups,
            "attempted-count": attempted,
            "acknowledged-count": len(seen),
            "duplicated-count": len(dups),
            "duplicated": dict(list(dups.items())[:10]),
        }


def _hashable(v: Any) -> Any:
    if isinstance(v, list):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, set):
        return frozenset(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    return v


# ---------------------------------------------------------------------------
# Queue / set / counter invariants
# ---------------------------------------------------------------------------


class Queue(Checker):
    """Applies enqueue/dequeue completions through a model in completion
    order: every ok dequeue must be legal; indeterminate enqueues count as
    possible (checker.clj:235-255)."""

    def __init__(self, model):
        self.model = model

    def check(self, test, history, opts):
        m = self.model
        final = None
        for o in history:
            if not o.is_client_op:
                continue
            if o.f == "enqueue" and (o.is_ok or o.is_info):
                m2 = m.step(o)
            elif o.f == "dequeue" and o.is_ok:
                m2 = m.step(o)
            else:
                continue
            if m2.is_inconsistent:
                final = {"valid": False, "error": m2.msg, "op": o.to_dict()}
                break
            m = m2
        return final or {"valid": True, "final-queue-size": _model_size(m)}


def _model_size(m) -> Optional[int]:
    for attr in ("pending", "items"):
        if hasattr(m, attr):
            return len(getattr(m, attr))
    return None


class TotalQueue(Checker):
    """Every enqueued element is dequeued exactly once
    (checker.clj:648-708): reports lost (acknowledged enqueue never
    dequeued), unexpected (dequeued but never enqueued), duplicated
    (dequeued more than enqueued), and recovered (indeterminate enqueue
    that showed up)."""

    def check(self, test, history, opts):
        attempts = MultiSet()  # all enqueue attempts (ok or info)
        enqueues = MultiSet()  # acknowledged enqueues
        dequeues = MultiSet()
        for o in history:
            if not o.is_client_op:
                continue
            v = _hashable(o.value)
            if o.f == "enqueue":
                if o.is_invoke:
                    attempts[v] += 1
                elif o.is_ok:
                    enqueues[v] += 1
            elif o.f == "dequeue" and o.is_ok:
                dequeues[v] += 1
        # ok: dequeues we attempted; unexpected: dequeues never attempted
        # at all; duplicated: attempted values dequeued more times than
        # attempted; lost: acknowledged enqueues never dequeued; recovered:
        # indeterminate enqueues that came out (checker.clj:671-695).
        ok = dequeues & attempts
        unexpected = MultiSet(
            {k: c for k, c in dequeues.items() if k not in attempts}
        )
        duplicated = (dequeues - attempts) - unexpected
        lost = enqueues - dequeues
        recovered = ok - enqueues
        total = sum(attempts.values())
        return {
            "valid": not lost and not unexpected,
            "attempt-count": total,
            "acknowledged-count": sum(enqueues.values()),
            "ok-count": sum(ok.values()),
            "lost": set(lost),
            "lost-count": sum(lost.values()),
            "unexpected": set(unexpected),
            "unexpected-count": sum(unexpected.values()),
            "duplicated": set(duplicated),
            "duplicated-count": sum(duplicated.values()),
            "recovered": set(recovered),
            "recovered-count": sum(recovered.values()),
            "ok-frac": fraction(sum(ok.values()), total),
            "lost-frac": fraction(sum(lost.values()), total),
        }


class SetChecker(Checker):
    """Grow-only set via a final read: everything acknowledged must be
    present; nothing unexpected (checker.clj:257-287).  `add_f`/`read_f`
    let wire protocols with different op names (e.g. kvdb's "members")
    reuse it."""

    def __init__(self, add_f: Any = "add", read_f: Any = "read"):
        self.add_f = add_f
        self.read_f = read_f

    def check(self, test, history, opts):
        attempts: set = set()
        adds: set = set()
        final_read = None
        for o in history:
            if not o.is_client_op:
                continue
            if o.f == self.add_f:
                if o.is_invoke:
                    attempts.add(_hashable(o.value))
                elif o.is_ok:
                    adds.add(_hashable(o.value))
            elif o.f == self.read_f and o.is_ok:
                final_read = set(_hashable(x) for x in (o.value or []))
        if final_read is None:
            return {"valid": UNKNOWN, "error": "no read completed"}
        lost = adds - final_read
        unexpected = final_read - attempts
        recovered = (final_read & attempts) - adds
        return {
            "valid": not lost and not unexpected,
            # ok = attempted values the read confirmed (the reference
            # counts recovered indeterminate/failed attempts here too,
            # checker_test.clj:141-152).
            "ok-count": len(final_read & attempts),
            "lost-count": len(lost),
            "lost": _sorted_sample(lost),
            "unexpected-count": len(unexpected),
            "unexpected": _sorted_sample(unexpected),
            "recovered-count": len(recovered),
            "recovered": _sorted_sample(recovered),
            "attempt-count": len(attempts),
            "acknowledged-count": len(adds),
        }


def _sorted_sample(s: set, limit: int = 32) -> list:
    try:
        return sorted(s)[:limit]
    except TypeError:
        return sorted(s, key=repr)[:limit]


class SetFull(Checker):
    """Full set analysis (checker.clj:487-612): tracks every element's
    lifecycle across *all* reads, not just a final one.  An element
    acknowledged at completion time t is `lost` if every read invoked
    after its visibility point omits it; read instability (present, then
    absent, then present) is flagged per element.  With
    linearizable=True, any read invoked after the add completed that
    omits the element fails it (stale reads are violations);
    otherwise stale reads are tolerated (reports stale-reads count)."""

    def __init__(self, linearizable: bool = False):
        self.linearizable = linearizable

    def check(self, test, history, opts):
        # Element -> completion index of its ok add.
        add_done: dict[Any, int] = {}
        attempts: set = set()
        reads: list[tuple[int, int, set]] = []  # (invoke idx, complete idx, values)
        pending_reads: dict[Any, int] = {}
        invoke_count: MultiSet = MultiSet()
        fail_count: MultiSet = MultiSet()
        for o in history:
            if not o.is_client_op:
                continue
            if o.f == "add":
                v = _hashable(o.value)
                if o.is_invoke:
                    attempts.add(v)
                    invoke_count[v] += 1
                elif o.is_ok:
                    add_done[v] = o.index
                elif o.is_fail:
                    fail_count[v] += 1
            elif o.f == "read":
                if o.is_invoke:
                    pending_reads[o.process] = o.index
                elif o.is_ok:
                    inv = pending_reads.pop(o.process, o.index)
                    reads.append(
                        (inv, o.index, set(_hashable(x) for x in (o.value or [])))
                    )
        if not reads:
            return {"valid": UNKNOWN, "error": "no read completed"}

        # A value whose EVERY attempt failed definitely never entered
        # the set: it neither needs a witnessing read nor legitimizes
        # one — a sighting of it is a phantom.  A value that failed
        # once but was acked (or left indeterminate) on another
        # attempt is still tracked normally.
        attempts -= {
            v for v, n in fail_count.items()
            if n >= invoke_count[v] and v not in add_done
        }

        # Index the reads once (the naive per-element rescans were
        # O(attempts x reads) and dominated large checks): sort by
        # invoke index, then record for each value the sorted read
        # positions that contained it, plus its first sighting's
        # completion index.
        import bisect

        reads_sorted = sorted(reads, key=lambda r: r[0])
        invs = [r[0] for r in reads_sorted]
        n_reads = len(reads_sorted)
        pos_of: dict[Any, list[int]] = {}
        first_seen: dict[Any, int] = {}
        for pos, (_, c, vals) in enumerate(reads_sorted):
            for v in vals:
                pos_of.setdefault(v, []).append(pos)
                if v not in first_seen or c < first_seen[v]:
                    first_seen[v] = c

        lost, stale, never_read, ok_els = [], [], [], []
        unexpected: set = set()
        for _, _, vals in reads:
            unexpected |= vals - attempts
        for v in attempts:
            done_idx = add_done.get(v)
            # Visibility point: the earliest moment the element
            # provably exists — its ack, or the completion of the
            # first read that SAW it (a sighting proves even an
            # unacked add happened).  Reads invoked after that point
            # must keep showing it.
            seen = first_seen.get(v)
            points = [p for p in (done_idx, seen) if p is not None]
            if not points:
                never_read.append(v)
                continue
            vis = min(points)
            i0 = bisect.bisect_right(invs, vis)  # first read invoked after vis
            n_later = n_reads - i0
            if n_later == 0:
                if seen is not None:
                    ok_els.append(v)  # witnessed, never contradicted
                else:
                    never_read.append(v)
                continue
            pos = pos_of.get(v, [])
            n_present = len(pos) - bisect.bisect_left(pos, i0)
            in_last = bool(pos) and pos[-1] == n_reads - 1
            if n_present == 0 or not in_last:
                # never seen, or vanished without reappearing: lost
                lost.append(v)
            elif n_present < n_later:
                # dipped out but recovered: a stale/nonmonotonic read
                stale.append(v)
                ok_els.append(v)
            else:
                ok_els.append(v)
        stale_invalid = self.linearizable and bool(stale)
        # Validity mirrors set-full's three-way verdict
        # (checker_test.clj:631-730): any lost/phantom element is
        # false; elements whose fate no read can witness (concurrent
        # or trailing adds) leave the check "unknown"; true needs
        # every attempt accounted for.
        if lost or unexpected or stale_invalid:
            valid: Any = False
        elif never_read:
            valid = UNKNOWN
        else:
            valid = True
        return {
            "valid": valid,
            "lost": _sorted_sample(set(lost)),
            "lost-count": len(lost),
            "stale": _sorted_sample(set(stale)),
            "stale-count": len(stale),
            "never-read": _sorted_sample(set(never_read)),
            "never-read-count": len(never_read),
            "unexpected": _sorted_sample(unexpected),
            "unexpected-count": len(unexpected),
            "ok-count": len(ok_els),
        }


class CounterChecker(Checker):
    """Reads of a counter must fall within the reachable [lower, upper]
    bounds given definite (ok) and possible (concurrent/indeterminate)
    adds (checker.clj:749-819)."""

    def check(self, test, history, opts):
        # Scan events in order, tracking:
        #   acked: sum of deltas of adds that definitely completed
        #   open: per-process in-flight add deltas
        #   maybe_pos/maybe_neg: sums of indeterminate add deltas
        acked = 0
        maybe_pos = 0
        maybe_neg = 0
        open_adds: dict[Any, int] = {}
        pending_reads: dict[Any, tuple[int, int, int]] = {}
        errors = []
        reads = 0
        for o in history:
            if not o.is_client_op:
                continue
            if o.f == "add":
                d = o.value or 0
                if o.is_invoke:
                    open_adds[o.process] = d
                elif o.is_ok:
                    open_adds.pop(o.process, None)
                    acked += d
                elif o.is_fail:
                    open_adds.pop(o.process, None)
                elif o.is_info:
                    open_adds.pop(o.process, None)
                    if d >= 0:
                        maybe_pos += d
                    else:
                        maybe_neg += d
            elif o.f == "read":
                if o.is_invoke:
                    # Bounds at invocation time.
                    pending_reads[o.process] = (acked, maybe_pos, maybe_neg)
                elif o.is_ok:
                    start = pending_reads.pop(o.process, (acked, maybe_pos, maybe_neg))
                    reads += 1
                    # Anything concurrent with the read may or may not be
                    # included: bound with both snapshots plus open adds.
                    lo = min(start[0], acked) + min(start[2], maybe_neg)
                    hi = max(start[0], acked) + max(start[1], maybe_pos)
                    lo += sum(d for d in open_adds.values() if d < 0)
                    hi += sum(d for d in open_adds.values() if d > 0)
                    if not (lo <= (o.value or 0) <= hi):
                        errors.append(
                            {"op": o.to_dict(), "expected": [lo, hi]}
                        )
        return {
            "valid": not errors,
            "reads": reads,
            "errors": errors[:10],
            "error-count": len(errors),
        }


class LogFilePattern(Checker):
    """Greps downloaded node logs for a pattern; valid iff no matches
    (checker.clj:863-905)."""

    def __init__(self, pattern: str, filename: str):
        self.pattern = pattern
        self.filename = filename

    def check(self, test, history, opts):
        matches = []
        # opts["dir"] is the RUN dir — where snarf_logs puts
        # <node>/<logfile> (core.py analyze / db.py snarf_logs);
        # the explicit keys are unit-test/manual overrides.
        store_dir = (opts.get("store_dir") or opts.get("dir")
                     or test.get("store_dir"))
        if store_dir:
            for node in test.get("nodes", []):
                path = os.path.join(store_dir, str(node), self.filename)
                if not os.path.exists(path):
                    continue
                rx = re.compile(self.pattern)
                with open(path, errors="replace") as fh:
                    for line in fh:
                        if rx.search(line):
                            matches.append({"node": node, "line": line.strip()})
        return {
            "valid": not matches,
            "count": len(matches),
            "matches": matches[:10],
        }
