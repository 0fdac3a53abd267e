"""Read-write register transactional anomaly checking — the port's copy
of `jepsen_tpu/checker/elle/wr.py` (elle.rw-register as the Jepsen
suite's tests/cycle/wr.clj consumes it, reimplemented from the Elle
paper's write-read register inference).

Transactions are ops with f="txn" and value = micro-ops ["w", k, v]
(writes, globally unique per key) and ["r", k, v] (reads; None = the
unwritten initial state).  Unlike list-append, a register read exposes
only the *latest* value, so version orders are recovered from weaker
evidence.  This implementation infers, per key:

  * initial-state: None precedes every written value;
  * intra-txn sequencing: a txn that reads or writes v and then writes
    v' orders v << v' directly;

and builds wr edges (writer of v -> any txn whose external read of k
saw v), ww edges along inferred v << v' pairs, and rw anti-dependency
edges (external reader of v -> writer of any v' with v << v').
Non-cycle anomalies: G1a (aborted read), G1b (intermediate read),
unwritten reads.  Cycles classify as in graph.classify_cycle.

`sequential_keys=True` is the declared-semantics strengthening Elle
exposes for workloads that promise per-key sequential writes (the
assumptions table of the Elle paper, consumed via wr.clj's workload
options): when write(v)'s completion precedes write(v')'s invocation
in realtime, v << v' joins the version order — recovering e.g.
G-single cycles from stale reads that the base evidence (initial
state + intra-txn sequencing) cannot see, because no transaction ever
observed both values.  Opt in only when the system under test really
applies each key's writes in realtime order.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Any, Optional

from ...history.core import History, Op
from .graph import DepGraph, check_cycles
from .append import (
    DIRTY,
    FORBIDDEN,
    REALTIME_MODELS,
    SESSION_MODELS,
    _add_process_edges,
    _add_realtime_edges,
)


def analyze(
    history: History,
    *,
    consistency_model: str = "serializable",
    cycle_fn=None,
    sequential_keys: bool = False,
) -> dict:
    oks = [o for o in history if o.is_ok and o.f in ("txn", None)]
    infos = [o for o in history if o.is_info and o.f in ("txn", None)]
    fails = [o for o in history if o.is_fail and o.f in ("txn", None)]

    anomalies: dict[str, list] = defaultdict(list)

    # (k, v) -> writer op index; committed or indeterminate writes count.
    writer: dict[tuple, int] = {}
    failed_writes: set = set()
    intermediate: set = set()

    def index_writes(op: Op, failed: bool = False) -> None:
        last: dict = {}
        for f, k, v in op.value or []:
            if f == "w":
                kv = (k, v)
                if failed:
                    failed_writes.add(kv)
                elif kv in writer:
                    anomalies["duplicate-writes"].append(
                        {"key": k, "value": v, "ops": [writer[kv], op.index]}
                    )
                else:
                    writer[kv] = op.index
                if k in last:
                    intermediate.add(last[k])
                last[k] = kv

    for op in oks:
        index_writes(op)
    for op in infos:
        index_writes(op)
    for op in fails:
        index_writes(op, failed=True)

    # Per-key successor constraints v << v' (v may be None = initial),
    # plus Elle's INTERNAL consistency checks (without them the base
    # inference would tolerate a txn contradicting itself):
    #   * "internal": a read that disagrees with this txn's own
    #     still-visible WRITE of the key — illegal under any isolation
    #     above read-uncommitted (your own writes must be visible to
    #     you);
    #   * "nonrepeatable-read": two reads of the key in one txn, no
    #     write between, different values — legal under
    #     read-committed, forbidden from repeatable-read up.
    succ: dict[Any, dict[Any, set]] = defaultdict(lambda: defaultdict(set))
    for op in oks:
        last_seen: dict = {}  # k -> last value this txn read or wrote
        wrote: dict = {}      # k -> value this txn last wrote
        for f, k, v in op.value or []:
            if f == "w":
                if k in last_seen and last_seen[k] != v:
                    succ[k][last_seen[k]].add(v)
                last_seen[k] = v
                wrote[k] = v
            elif f == "r":
                if k in wrote and wrote[k] != v:
                    anomalies["internal"].append({
                        "op": op.index, "key": k,
                        "wrote": wrote[k], "read": v,
                    })
                elif k in last_seen and last_seen[k] != v:
                    anomalies["nonrepeatable-read"].append({
                        "op": op.index, "key": k,
                        "first": last_seen[k], "then": v,
                    })
                last_seen.setdefault(k, v)

    if sequential_keys:
        # Declared per-key sequential writes: completion-before-
        # invocation realtime order joins the version order (see
        # module doc).  Realtime needs real invocation intervals — a
        # bare completion list has none, and degrading to completion
        # order would order CONCURRENT writes (a constraint the
        # system never promised -> false convictions), so the paired
        # History is required.  A completion op with no recorded
        # invocation degrades to a point interval at its own index:
        # it can gain an order only against ops wholly before/after
        # it, never against an overlapping one.
        inv_of = getattr(history, "invocation", None)
        if not callable(inv_of):
            raise ValueError(
                "sequential_keys=True needs a paired History (with "
                ".invocation), not a bare op list — realtime write "
                "order cannot be recovered from completions alone"
            )
        by_key: dict[Any, list[tuple[int, int, Any]]] = defaultdict(list)
        for op in oks:
            inv = inv_of(op)
            inv_idx = inv.index if inv is not None else op.index
            for f, k, v in op.value or []:
                if f == "w":
                    by_key[k].append((inv_idx, op.index, v))
        # Covering pairs only, via the same pruned sweep
        # _add_realtime_edges uses (O(n log n), not the all-pairs
        # O(n^2) that hung multi-minute txnd runs): among writes
        # whose completion precedes B's invocation, only those not
        # already covered transitively get a direct v << v' — which
        # is also Elle's directly-follows semantics for rw edges.
        import bisect

        for k, ws in by_key.items():
            ws.sort()
            done: list[tuple[int, int, Any]] = []  # (comp, inv, v)
            m = -1
            for inv_idx, comp_idx, v2 in ws:
                cut = bisect.bisect_left(done, (inv_idx, -1, None))
                if cut:
                    m = max(m, max(e[1] for e in done[:cut]))
                    survivors = [e for e in done[:cut] if e[0] >= m]
                    for _comp, _inv, v1 in survivors:
                        if v1 != v2:
                            succ[k][v1].add(v2)
                    done = survivors + done[cut:]
                bisect.insort(done, (comp_idx, inv_idx, v2))

    g = DepGraph()
    for op in oks:
        g.add_vertex(op.index)

    # External reads -> wr edges and read anomalies.
    ext_reader: dict[tuple, list[int]] = defaultdict(list)
    for op in oks:
        written: set = set()
        for f, k, v in op.value or []:
            if f == "w":
                written.add(k)
            elif f == "r" and k not in written:
                kv = (k, v)
                ext_reader[kv].append(op.index)
                if v is None:
                    continue
                if kv in failed_writes:
                    anomalies["G1a"].append(
                        {"op": op.index, "key": k, "value": v}
                    )
                # Intermediate reads are anomalous only across txns; a
                # txn may see its own in-progress writes.  (External
                # reads can't see own writes by construction, but keep
                # the guard parallel to append.py.)
                if kv in intermediate and writer.get(kv) != op.index:
                    anomalies["G1b"].append(
                        {"op": op.index, "key": k, "value": v}
                    )
                w = writer.get(kv)
                if w is None:
                    anomalies["unwritten-read"].append(
                        {"op": op.index, "key": k, "value": v}
                    )
                elif w != op.index:
                    g.add_edge(w, op.index, "wr")

    # Initial-state rule (module doc: None precedes every written
    # value): readers of the unwritten initial state anti-depend on
    # every writer of that key.  Without this a stale read of the
    # initial state could never join a cycle — e.g. a committed write
    # followed in realtime by a read of None would pass strict-
    # serializable.
    written_by_key: dict[Any, set] = defaultdict(set)
    for (k, v), _w in writer.items():
        written_by_key[k].add(v)
    for k, vs in written_by_key.items():
        succ[k][None] |= vs

    # ww and rw edges along inferred successor pairs.
    for k, pairs in succ.items():
        for v, nexts in pairs.items():
            wv = writer.get((k, v)) if v is not None else None
            for v2 in nexts:
                wv2 = writer.get((k, v2))
                if wv2 is None:
                    continue
                if wv is not None and wv != wv2:
                    g.add_edge(wv, wv2, "ww")
                for rd in ext_reader.get((k, v), []):
                    if rd != wv2:
                        g.add_edge(rd, wv2, "rw")

    if consistency_model in REALTIME_MODELS:
        # Realtime order edges (strict serializability) — the same
        # reduced sweep the list-append analyzer uses.
        _add_realtime_edges(history, g)
    if consistency_model in SESSION_MODELS:
        _add_process_edges(history, g)

    cycles = (cycle_fn or check_cycles)(g)
    for c in cycles:
        anomalies[c["type"]].append(c)

    forbidden = set(FORBIDDEN.get(consistency_model, FORBIDDEN["serializable"]))
    forbidden |= {"duplicate-writes"}
    if consistency_model != "read-uncommitted":
        forbidden |= DIRTY | {"unwritten-read", "internal"}
    if consistency_model not in ("read-uncommitted", "read-committed"):
        forbidden |= {"nonrepeatable-read"}
    found = {t for t in anomalies if anomalies[t]}
    bad = found & forbidden
    valid: Any = True
    if bad:
        valid = False
    elif found:
        valid = "unknown"
    return {
        "valid": valid,
        "anomaly-types": sorted(found),
        "anomalies": {t: v for t, v in anomalies.items() if v},
        "edges": g.n_edges(),
    }


class WrGen:
    """Random read/write-register transactions with globally unique
    writes per key (elle.rw-register/gen)."""

    def __init__(
        self,
        *,
        key_count: int = 10,
        min_txn_length: int = 1,
        max_txn_length: int = 4,
        rng: Optional[random.Random] = None,
    ):
        self.key_count = key_count
        self.min_len = min_txn_length
        self.max_len = max_txn_length
        self.rng = rng or random.Random()
        self.next_value: dict[int, int] = defaultdict(int)

    def __call__(self) -> dict:
        n = self.rng.randint(self.min_len, self.max_len)
        txn = []
        for _ in range(n):
            k = self.rng.randrange(self.key_count)
            if self.rng.random() < 0.5:
                txn.append(["r", k, None])
            else:
                v = self.next_value[k]
                self.next_value[k] = v + 1
                txn.append(["w", k, v])
        return {"f": "txn", "value": txn}
