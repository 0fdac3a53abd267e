"""List-append transactional anomaly checking — the port's copy of
`jepsen_tpu/checker/elle/append.py` (elle.list-append as the Jepsen
suite's tests/cycle/append.clj consumes it, reimplemented from the Elle
paper's list-append inference rules).

Transactions are ops with f="txn" and value = list of micro-ops:
["append", k, v] appends v to the list at key k; ["r", k, vs] observes
the full list vs.  Because appends are unique per key and reads expose
the whole list, the version history of each key is directly recoverable:

  * the version written by an append a = the observed list ending in a;
  * reads of k must be prefix-compatible ("incompatible-order" if not);
  * ww edges chain consecutive elements of the longest observed list;
  * wr edges run from the writer of a read's last element to the reader;
  * rw anti-dependencies run from the reader of a prefix to the writer
    of the next element.

Anomalies reported: G1a (aborted read), G1b (intermediate read),
"dirty-update", internal (txn sees its own writes wrong), duplicates,
incompatible-order, lost-update-ish garbage reads, and the cycle
anomalies G0/G1c/G-single/G2-item from graph.check_cycles (or the
device-screened search a checker passes as `cycle_fn`).
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Any, Iterable, Optional, Sequence

from ...history.core import History, Op
from .graph import DepGraph, check_cycles

#: Cycle anomaly types forbidden per consistency model.
FORBIDDEN = {
    "read-uncommitted": {"G0"},
    "read-committed": {"G0", "G1c"},
    "repeatable-read": {"G0", "G1c"},
    "serializable": {"G0", "G1c", "G-single", "G2-item"},
    # The stronger models forbid the same Adya classes; their extra
    # power comes from the additional EDGES woven into the graph
    # (realtime order for strict-*, per-process session order for
    # strong-session-*), which create cycles the weaker graphs don't
    # have.  A ww+realtime cycle still classifies G0, as in Elle's
    # "-realtime" variants collapsing to the same forbidden class.
    "strict-serializable": {"G0", "G1c", "G-single", "G2-item"},
    "strong-session-serializable": {"G0", "G1c", "G-single",
                                    "G2-item"},
}

#: Models that weave extra edge sources into the dependency graph.
#: (Realtime subsumes session order — a jepsen process completes each
#: op before invoking the next — so strict-* needs no process edges.)
REALTIME_MODELS = {"strict-serializable"}
SESSION_MODELS = {"strong-session-serializable"}

#: Non-cycle anomalies forbidden from read-committed up.
DIRTY = {"G1a", "G1b", "dirty-update"}


def _txn_ok_ops(history: History) -> list[Op]:
    return [o for o in history if o.is_ok and o.f in ("txn", None)]


def analyze(
    history: History,
    *,
    consistency_model: str = "serializable",
    cycle_fn=None,
) -> dict:
    """Full list-append analysis -> {"valid": ..., "anomaly-types": [...],
    "anomalies": {...}}."""
    oks = _txn_ok_ops(history)
    infos = [o for o in history if o.is_info and o.f in ("txn", None)]
    fails = [o for o in history if o.is_fail and o.f in ("txn", None)]

    anomalies: dict[str, list] = defaultdict(list)

    # -- index writes ---------------------------------------------------
    # writer[(k, v)] = op index that appended v to k (committed and
    # indeterminate appends both count: an info append may well have
    # taken effect).
    writer: dict[tuple, int] = {}
    # Appends from known-failed txns.
    failed_appends: set[tuple] = set()
    # (k, v) -> True when v is NOT the final append to k in its txn.
    intermediate: set[tuple] = set()

    def note_appends(op: Op, target: Optional[dict] = None, fate: Optional[set] = None):
        last_per_key: dict = {}
        for mop in op.value or []:
            f, k, v = mop
            if f == "append":
                kv = (k, v)
                if target is not None:
                    if kv in writer:
                        anomalies["duplicate-appends"].append(
                            {"key": k, "value": v, "ops": [writer[kv], op.index]}
                        )
                    else:
                        target[kv] = op.index
                if fate is not None:
                    fate.add(kv)
                if k in last_per_key:
                    intermediate.add(last_per_key[k])
                last_per_key[k] = kv

    for op in oks:
        note_appends(op, target=writer)
    for op in infos:
        note_appends(op, target=writer)
    for op in fails:
        note_appends(op, fate=failed_appends)

    # -- per-key version order from reads -------------------------------
    # Longest observed list per key + prefix compatibility of all reads.
    longest: dict[Any, list] = {}
    for op in oks:
        for mop in op.value or []:
            f, k, vs = mop
            if f != "r" or vs is None:
                continue
            vs = list(vs)
            if len(set(vs)) != len(vs):
                anomalies["duplicate-elements"].append(
                    {"op": op.index, "key": k, "value": vs}
                )
            cur = longest.get(k, [])
            shorter, larger = (vs, cur) if len(vs) <= len(cur) else (cur, vs)
            if larger[: len(shorter)] != shorter:
                anomalies["incompatible-order"].append(
                    {"key": k, "values": [shorter, larger]}
                )
            if len(vs) > len(cur):
                longest[k] = vs

    # -- read-level anomalies -------------------------------------------
    for op in oks:
        # Internal: a read after an append in the same txn must end with
        # this txn's own appends, in order.
        my_appends: dict[Any, list] = defaultdict(list)
        for mop in op.value or []:
            f, k, v = mop
            if f == "append":
                my_appends[k].append(v)
            elif f == "r" and v is not None:
                vs = list(v)
                mine = my_appends.get(k, [])
                if mine and vs[-len(mine):] != mine:
                    anomalies["internal"].append(
                        {"op": op.index, "key": k, "expected-suffix": mine,
                         "observed": vs}
                    )
                # A read observes the version named by its LAST element;
                # ending at a non-final append from ANOTHER txn =
                # intermediate state (G1b).  Intermediate elements deeper
                # in the list are normal, and a txn reading its own
                # in-progress state is legal.
                if (
                    vs
                    and (k, vs[-1]) in intermediate
                    and writer.get((k, vs[-1])) != op.index
                ):
                    anomalies["G1b"].append(
                        {"op": op.index, "key": k, "value": vs[-1]}
                    )
                for el in vs:
                    kv = (k, el)
                    if kv in failed_appends:
                        anomalies["G1a"].append(
                            {"op": op.index, "key": k, "value": el}
                        )
                    if (
                        kv not in writer
                        and kv not in failed_appends
                        and el not in mine
                    ):
                        anomalies["unobserved-writer"].append(
                            {"op": op.index, "key": k, "value": el}
                        )

    # Dirty update: a committed append whose predecessor in the version
    # order is a failed append.
    for k, vs in longest.items():
        for el in vs:
            if (k, el) in failed_appends:
                anomalies["dirty-update"].append({"key": k, "value": el})

    # -- dependency graph -----------------------------------------------
    g = DepGraph()
    for op in oks:
        g.add_vertex(op.index)

    def w(kv: tuple) -> Optional[int]:
        return writer.get(kv)

    for k, order in longest.items():
        # ww chain along the version order.
        for a, b in zip(order, order[1:]):
            wa, wb = w((k, a)), w((k, b))
            if wa is not None and wb is not None and wa != wb:
                g.add_edge(wa, wb, "ww")

    for op in oks:
        for mop in op.value or []:
            f, k, vs = mop
            if f != "r" or vs is None:
                continue
            vs = list(vs)
            order = longest.get(k, [])
            if vs:
                last_writer = w((k, vs[-1]))
                if last_writer is not None and last_writer != op.index:
                    g.add_edge(last_writer, op.index, "wr")
            # rw: this read observed version len(vs); the next version's
            # writer overwrote it.
            if len(vs) < len(order):
                nxt = w((k, order[len(vs)]))
                if nxt is not None and nxt != op.index:
                    g.add_edge(op.index, nxt, "rw")

    if consistency_model in REALTIME_MODELS:
        _add_realtime_edges(history, g)
    if consistency_model in SESSION_MODELS:
        _add_process_edges(history, g)

    cycles = (cycle_fn or check_cycles)(g)
    for c in cycles:
        anomalies[c["type"]].append(c)

    # -- verdict ---------------------------------------------------------
    forbidden = set(FORBIDDEN.get(consistency_model, FORBIDDEN["serializable"]))
    forbidden |= {"incompatible-order", "duplicate-elements",
                  "duplicate-appends", "internal"}
    if consistency_model != "read-uncommitted":
        # Reads of elements nobody wrote are data corruption, same as
        # wr.py's unwritten-read.
        forbidden |= DIRTY | {"unobserved-writer"}
    found = {t for t in anomalies if anomalies[t]}
    bad = found & forbidden
    valid: Any = True
    if bad:
        valid = False
    elif found:
        valid = "unknown"  # anomalies present but not forbidden by model
    return {
        "valid": valid,
        "anomaly-types": sorted(found),
        "anomalies": {t: v for t, v in anomalies.items() if v},
        "edges": g.n_edges(),
    }


def _add_realtime_edges(history: History, g: DepGraph) -> None:
    """A -> B when A's completion precedes B's invocation (strict
    serializability's realtime order), transitively reduced.

    Reduction: with S = {A : comp(A) < inv(B)} and M = max inv(C) over
    C in S, any A in S with comp(A) < M is covered transitively
    (comp(A) < inv(C) for the maximizing C, so A -> C -> B), so only
    A with comp(A) >= M need direct edges.  The surviving set is
    bounded by the concurrency, keeping this near-linear.  History
    indices are the time order."""
    inv_of = getattr(history, "invocation", None)
    if not callable(inv_of):
        raise ValueError(
            "realtime edges need a paired History (with .invocation), "
            "not a bare op list — completion order alone cannot "
            "recover realtime intervals"
        )
    pairs = []  # (inv_index, comp_index, op.index) for committed txns
    for o in history:
        if o.is_ok and o.f in ("txn", None):
            inv = inv_of(o)
            if inv is not None:
                pairs.append((inv.index, o.index, o.index))
    pairs.sort()
    # Sweep in invocation order.  `done` holds (comp, inv, op) of
    # completed txns sorted by comp.  Since inv(B) is nondecreasing, S
    # only grows, so any entry with comp < M (the running max-inv over
    # everything that has entered S) is covered transitively for every
    # future B too — prune it once, keeping the sweep near-linear.
    import bisect

    done: list[tuple[int, int, int]] = []  # sorted by comp
    m = -1  # running max inv over pruned-or-current S
    for inv_idx, comp_idx, op_idx in pairs:
        cut = bisect.bisect_left(done, (inv_idx, -1, -1))
        if cut:
            m = max(m, max(e[1] for e in done[:cut]))
            survivors = [e for e in done[:cut] if e[0] >= m]
            for comp, inv2, pred in survivors:
                if pred != op_idx:
                    g.add_edge(pred, op_idx, "realtime")
            # Entries below the max-inv bar are done forever.
            done = survivors + done[cut:]
        bisect.insort(done, (comp_idx, inv_idx, op_idx))


def _add_process_edges(history: History, g: DepGraph) -> None:
    """A -> B when B is the next committed txn of A's process (session
    order; Elle's process graph for the strong-session-* models).
    Consecutive pairs only — session order is total per process, so
    the chain is its own transitive reduction."""
    last_by_process: dict = {}
    for o in history:
        if o.is_ok and o.f in ("txn", None) and o.process is not None:
            # process=None (bare literal ops) carries no session
            # identity; chaining those would invent one shared
            # session and falsely convict valid histories.
            prev = last_by_process.get(o.process)
            if prev is not None and prev != o.index:
                g.add_edge(prev, o.index, "process")
            last_by_process[o.process] = o.index


# ---------------------------------------------------------------------------
# Generator (elle.list-append/gen as used by append.clj:11-27)
# ---------------------------------------------------------------------------


class AppendGen:
    """Generates random list-append transactions: each txn is 1..max_len
    mops over a sliding window of active keys; append values are unique
    and monotonically increasing per key."""

    def __init__(
        self,
        *,
        key_count: int = 10,
        min_txn_length: int = 1,
        max_txn_length: int = 4,
        max_writes_per_key: int = 32,
        rng: Optional[random.Random] = None,
    ):
        self.key_count = key_count
        self.min_len = min_txn_length
        self.max_len = max_txn_length
        self.max_writes = max_writes_per_key
        self.rng = rng or random.Random()
        self.next_value: dict[int, int] = defaultdict(int)
        self.active: list[int] = list(range(key_count))
        self.next_key = key_count

    def __call__(self) -> dict:
        n = self.rng.randint(self.min_len, self.max_len)
        txn = []
        for _ in range(n):
            k = self.rng.choice(self.active)
            if self.rng.random() < 0.5:
                txn.append(["r", k, None])
            else:
                v = self.next_value[k]
                self.next_value[k] = v + 1
                txn.append(["append", k, v])
                if v + 1 >= self.max_writes:
                    # Retire the key, activate a fresh one.
                    self.active.remove(k)
                    self.active.append(self.next_key)
                    self.next_key += 1
        return {"f": "txn", "value": txn}
