"""Kafka-style totally-ordered-log workload and checker.

The port's copy of `jepsen_tpu/workloads/kafka.py` (jepsen's
tests/kafka.clj), the largest and most intricate checker.  The system
under test is a set of append-only partitions ("keys"); producers
*send* values which get durable, theoretically monotonically-increasing
*offsets*; consumers *subscribe* (the system assigns partitions) or *assign*
(manual), and *poll* batches of [offset value] pairs, advancing their
position.

Op grammar (kafka.clj:24-98):

    {"f": "subscribe"|"assign", "value": [k1, k2, ...]}
      (assign may carry ext {"seek-to-beginning?": True})
    {"f": "send"|"poll"|"txn", "value": [mop, ...]}
      mop ["send", k, v]            -> completed ["send", k, [offset v]]
      mop ["poll"]                  -> completed ["poll", {k: [[o v] ...]}]

Analyses (kafka.clj:99-180, functions :725-1300, :1791-1878):

  1. version orders per key from every observed (offset, value) —
     divergence at one offset = inconsistent-offsets.
  2. g1a (aborted read): committed poll observes a failed send.
  3. lost-write: every value whose last log index precedes the highest
     *observed* index of its key must be read by someone (with the
     value->first-index / last-index->values bound construction).
  4. ww/wr dependency graph over version orders + elle cycle search
     (G0/G1c... via checker/elle/graph.py; rw edges like the reference's
     disabled rw-graph are omitted), screened on `device` ("cuda" by
     default, or "cpu") by ops/scc.py: a graph of at most 1,024
     vertices is screened there, a larger one goes to the host search,
     as in the JAX package.
  5. internal poll/send contiguity: skips and nonmonotonic pairs inside
     one transaction.
  6. cross-op per-process poll/send contiguity (resetting on
     assign/subscribe), duplicates, and unseen counts.

The client here is the reference *pattern* (a real Kafka), realized as
an in-memory total-order log with injectable fault modes so the checker
has real anomalies to find in tests.  The workload names a
"history-reviver", `revive_polls`: a stored history keeps each poll's
{key: pairs} map with JSON's string keys, and `core.rerun_analysis`
turns them back into the keys the sends name.
"""

from __future__ import annotations

import random
import threading
from collections import defaultdict
from typing import Any, Iterable, Optional, Union

import torch

from .. import client as jc
from .. import device as _device
from ..checker.core import Checker
from ..generator.core import PENDING, Generator, fill_in_op, gen_op
from ..history import FAIL, INFO, OK, History, Op

TXN_FS = ("txn", "poll", "send")


# ---------------------------------------------------------------------------
# Micro-op readers (kafka.clj:462-535)
# ---------------------------------------------------------------------------


def op_writes(op: Op) -> dict[Any, list]:
    """{key: [value, ...]} sent by this op, in mop order."""
    out: dict[Any, list] = defaultdict(list)
    if op.f in TXN_FS:
        for mop in op.value or []:
            if mop and mop[0] == "send":
                k, v = mop[1], mop[2]
                if isinstance(v, (list, tuple)):
                    v = v[1]
                out[k].append(v)
    return dict(out)


def op_write_offsets(op: Op) -> dict[Any, list]:
    """{key: [offset, ...]} for sends with known offsets."""
    out: dict[Any, list] = defaultdict(list)
    if op.f in TXN_FS:
        for mop in op.value or []:
            if mop and mop[0] == "send":
                v = mop[2]
                if isinstance(v, (list, tuple)) and v[0] is not None:
                    out[mop[1]].append(v[0])
    return dict(out)


def op_reads(op: Op) -> dict[Any, list]:
    """{key: [value, ...]} polled by this op, in offset order."""
    out: dict[Any, list] = defaultdict(list)
    if op.f in ("txn", "poll"):
        for mop in op.value or []:
            if mop and mop[0] == "poll" and len(mop) > 1 and mop[1]:
                for k, pairs in mop[1].items():
                    for off, v in pairs:
                        out[k].append(v)
    return dict(out)


def op_read_offsets(op: Op) -> dict[Any, list]:
    out: dict[Any, list] = defaultdict(list)
    if op.f in ("txn", "poll"):
        for mop in op.value or []:
            if mop and mop[0] == "poll" and len(mop) > 1 and mop[1]:
                for k, pairs in mop[1].items():
                    for off, v in pairs:
                        if off is not None:
                            out[k].append(off)
    return dict(out)


def _observed_pairs(op: Op) -> Iterable[tuple[Any, int, Any]]:
    """Every (key, offset, value) this op fixes in the log."""
    if op.f not in TXN_FS:
        return
    for mop in op.value or []:
        if not mop:
            continue
        if mop[0] == "send":
            v = mop[2]
            if isinstance(v, (list, tuple)) and v[0] is not None:
                yield (mop[1], v[0], v[1])
        elif mop[0] == "poll" and len(mop) > 1 and mop[1]:
            for k, pairs in mop[1].items():
                for off, v in pairs:
                    if off is not None:
                        yield (k, off, v)


# ---------------------------------------------------------------------------
# Version orders (kafka.clj:738-877)
# ---------------------------------------------------------------------------


def writes_by_type(history: Iterable[Op]) -> dict[str, dict]:
    """{"ok"/"info"/"fail": {key: set(values)}}."""
    out = {"ok": defaultdict(set), "info": defaultdict(set),
           "fail": defaultdict(set)}
    for op in history:
        if op.type in ("ok", "info", "fail") and op.f in TXN_FS:
            for k, vs in op_writes(op).items():
                out[op.type][k].update(vs)
    return {t: dict(d) for t, d in out.items()}


def reads_by_type(history: Iterable[Op]) -> dict[str, dict]:
    out = {"ok": defaultdict(set), "info": defaultdict(set),
           "fail": defaultdict(set)}
    for op in history:
        if op.type in ("ok", "info", "fail") and op.f in ("txn", "poll"):
            for k, vs in op_reads(op).items():
                out[op.type][k].update(vs)
    return {t: dict(d) for t, d in out.items()}


def must_have_committed(rbt: dict, op: Op) -> bool:
    """ok, or info with at least one send proven read
    (kafka.clj:725-737)."""
    if op.type == "ok":
        return True
    if op.type != "info":
        return False
    ok = rbt.get("ok", {})
    for k, vs in op_writes(op).items():
        if set(vs) & set(ok.get(k, ())):
            return True
    return False


class VersionOrder:
    """One key's log reconstruction: `log[offset] = set(values)`,
    `by_index` dense (gap-free) single-value order, `by_value` inverse."""

    __slots__ = ("log", "by_index", "by_value")

    def __init__(self, log: list):
        self.log = log
        self.by_index = [sorted(vs, key=repr)[0] for vs in log if vs]
        self.by_value = {}
        for i, v in enumerate(self.by_index):
            self.by_value.setdefault(v, i)

    def value_to_first_index(self) -> dict:
        out: dict = {}
        i = 0
        for vs in self.log:
            if not vs:
                continue
            for v in vs:
                out.setdefault(v, i)
            i += 1
        return out

    def last_index_to_values(self) -> list:
        latest: dict = {}
        i = 0
        for vs in self.log:
            if not vs:
                continue
            for v in vs:
                latest[v] = i
            i += 1
        out: list = [set() for _ in range(i)]
        for v, idx in latest.items():
            out[idx].add(v)
        return out


def version_orders(history: Iterable[Op], rbt: dict) -> tuple[dict, list]:
    """-> ({key: VersionOrder}, [inconsistency error maps])."""
    logs: dict[Any, list] = defaultdict(list)
    for op in history:
        if op.f in TXN_FS and must_have_committed(rbt, op):
            for k, off, v in _observed_pairs(op):
                log = logs[k]
                while len(log) <= off:
                    log.append(None)
                if log[off] is None:
                    log[off] = {v}
                else:
                    log[off].add(v)
    errors = []
    for k, log in logs.items():
        index = 0
        for off, vs in enumerate(log):
            if not vs:
                continue
            if len(vs) > 1:
                errors.append({
                    "key": k, "offset": off, "index": index,
                    "values": sorted(vs, key=repr),
                })
            index += 1
    return {k: VersionOrder(log) for k, log in logs.items()}, errors


# ---------------------------------------------------------------------------
# Anomaly analyses
# ---------------------------------------------------------------------------


def _writer_of(history: Iterable[Op]) -> dict:
    """{key: {value: op}} over non-invoke sends."""
    out: dict[Any, dict] = defaultdict(dict)
    for op in history:
        if op.type in ("ok", "info", "fail") and op.f in TXN_FS:
            for k, vs in op_writes(op).items():
                for v in vs:
                    out[k].setdefault(v, op)
    return dict(out)


def _readers_of(history: Iterable[Op]) -> dict:
    out: dict[Any, dict] = defaultdict(lambda: defaultdict(list))
    for op in history:
        if op.type == "ok" and op.f in ("txn", "poll"):
            for k, vs in op_reads(op).items():
                for v in vs:
                    out[k][v].append(op)
    return {k: dict(d) for k, d in out.items()}


def g1a_cases(history: list[Op], wbt: dict) -> list[dict]:
    """Committed polls observing failed sends (kafka.clj:877-896)."""
    failed = wbt.get("fail", {})
    out = []
    for op in history:
        if op.type != "ok" or op.f not in ("txn", "poll"):
            continue
        for k, vs in op_reads(op).items():
            for v in vs:
                if v in failed.get(k, ()):
                    out.append({"key": k, "value": v,
                                "reader": op.index})
    return out


def lost_write_cases(history: list[Op], orders: dict, rbt: dict,
                     writer_of: dict) -> list[dict]:
    """kafka.clj:896-991: for each key, values whose last appearance
    precedes the highest observed index must all be read."""
    out = []
    for k, vs in rbt.get("ok", {}).items():
        vo = orders.get(k)
        if vo is None:
            continue
        v2fi = vo.value_to_first_index()
        li2v = vo.last_index_to_values()
        bound = max((v2fi[v] for v in vs if v in v2fi), default=-1)
        must_read: list = []
        for idx in range(bound + 1):
            must_read.extend(li2v[idx])
        lost = [v for v in must_read if v not in vs]
        for v in list(lost):
            w = writer_of.get(k, {}).get(v)
            if w is None or not must_have_committed(rbt, w):
                lost.remove(v)
        for v in lost:
            w = writer_of.get(k, {}).get(v)
            out.append({
                "key": k, "value": v,
                "index": v2fi.get(v),
                "max-read-index": bound,
                "writer": w.index if w is not None else None,
            })
    return out


def duplicate_cases(orders: dict) -> list[dict]:
    """A value at more than one offset (kafka.clj:1252-1267)."""
    out = []
    for k, vo in orders.items():
        counts: dict = defaultdict(int)
        for v in vo.by_index:
            counts[v] += 1
        for v, n in counts.items():
            if n > 1:
                out.append({"key": k, "value": v, "count": n})
    return out


def unseen_final(history: list[Op]) -> dict:
    """Final unseen counts: acked sends never polled by anyone
    (kafka.clj:1268-1303, final element)."""
    sent: dict[Any, set] = defaultdict(set)
    polled: dict[Any, set] = defaultdict(set)
    for op in history:
        if op.type != "ok" or op.f not in TXN_FS:
            continue
        for k, vs in op_writes(op).items():
            sent[k].update(vs)
        for k, vs in op_reads(op).items():
            polled[k].update(vs)
    unseen = {k: vs - polled.get(k, set()) for k, vs in sent.items()}
    return {k: sorted(vs, key=repr) for k, vs in unseen.items() if vs}


def _pair_cases(pairs_by_key: dict, orders: dict, op: Op,
                skipped_limit: int = 16):
    """Shared skip/nonmonotonic detection over consecutive (v1, v2)
    pairs (kafka.clj:997-1088)."""
    skips, nonmono = [], []
    for k, vs in pairs_by_key.items():
        vo = orders.get(k)
        if vo is None:
            continue
        for v1, v2 in zip(vs, vs[1:]):
            i1 = vo.by_value.get(v1)
            i2 = vo.by_value.get(v2)
            delta = (i2 - i1) if (i1 is not None and i2 is not None) else 1
            if delta > 1:
                skips.append({
                    "key": k, "values": [v1, v2], "delta": delta,
                    "skipped": vo.by_index[i1 + 1 : i2][:skipped_limit],
                    "op": op.index,
                })
            elif delta < 1:
                nonmono.append({
                    "key": k, "values": [v1, v2], "delta": delta,
                    "op": op.index,
                })
    return skips, nonmono


def int_poll_cases(history: list[Op], orders: dict) -> dict:
    """Internal read contiguity (kafka.clj:997-1050)."""
    skips, nonmono = [], []
    for op in history:
        if op.type not in ("ok", "info") or op.f not in ("txn", "poll"):
            continue
        rebalanced = set()
        for ev in op.ext.get("rebalance-log") or []:
            rebalanced.update(ev.get("keys") or [])
        reads = {k: vs for k, vs in op_reads(op).items()
                 if k not in rebalanced}
        s, n = _pair_cases(reads, orders, op)
        skips.extend(s)
        nonmono.extend(n)
    return {"skip": skips, "nonmonotonic": nonmono}


def int_send_cases(history: list[Op], orders: dict) -> dict:
    """Internal write contiguity (kafka.clj:1051-1088)."""
    skips, nonmono = [], []
    for op in history:
        if op.type == "invoke" or op.f not in TXN_FS:
            continue
        s, n = _pair_cases(op_writes(op), orders, op)
        skips.extend(s)
        nonmono.extend(n)
    return {"skip": skips, "nonmonotonic": nonmono}


def poll_cases(history: list[Op], orders: dict) -> dict:
    """Cross-op per-process poll contiguity; positions reset on
    assign/subscribe (kafka.clj:1088-1180)."""
    skips, nonmono = [], []
    by_process: dict[Any, list] = defaultdict(list)
    for op in history:
        if op.type in ("ok", "info"):
            by_process[op.process].append(op)
    for process, ops in by_process.items():
        last_seen: dict[Any, Any] = {}
        for op in ops:
            if op.f in ("assign", "subscribe"):
                last_seen.clear()
                continue
            if op.f not in ("txn", "poll"):
                continue
            for k, vs in op_reads(op).items():
                if not vs:
                    continue
                vo = orders.get(k)
                if vo is None:
                    continue
                if k in last_seen:
                    i1 = vo.by_value.get(last_seen[k])
                    i2 = vo.by_value.get(vs[0])
                    if i1 is not None and i2 is not None:
                        delta = i2 - i1
                        if delta > 1:
                            skips.append({
                                "key": k, "process": process,
                                "values": [last_seen[k], vs[0]],
                                "delta": delta, "op": op.index,
                                "skipped": vo.by_index[i1 + 1 : i2][:16],
                            })
                        elif delta < 1:
                            nonmono.append({
                                "key": k, "process": process,
                                "values": [last_seen[k], vs[0]],
                                "delta": delta, "op": op.index,
                            })
                last_seen[k] = vs[-1]
    return {"skip": skips, "nonmonotonic": nonmono}


def nonmonotonic_send_cases(history: list[Op], orders: dict) -> list:
    """Cross-op per-process send order (kafka.clj:1180-1252)."""
    out = []
    by_process: dict[Any, list] = defaultdict(list)
    for op in history:
        if op.type in ("ok", "info"):
            by_process[op.process].append(op)
    for process, ops in by_process.items():
        last_sent: dict[Any, Any] = {}
        for op in ops:
            if op.f not in TXN_FS:
                continue
            for k, vs in op_writes(op).items():
                if not vs:
                    continue
                vo = orders.get(k)
                if vo is not None and k in last_sent:
                    i1 = vo.by_value.get(last_sent[k])
                    i2 = vo.by_value.get(vs[0])
                    if i1 is not None and i2 is not None and i2 - i1 < 1:
                        out.append({
                            "key": k, "process": process,
                            "values": [last_sent[k], vs[0]],
                            "delta": i2 - i1, "op": op.index,
                        })
                last_sent[k] = vs[-1]
    return out


def dependency_cycles(history: list[Op], orders: dict,
                      writer_of: dict, readers_of: dict,
                      rw_edges: bool = False,
                      device: Union[str, torch.device] = "cuda"
                      ) -> list[dict]:
    """ww/wr graph over version orders (kafka.clj:1791-1878) run through
    the Elle-equivalent layered cycle search (device-screened).

    `rw_edges=True` also adds
    anti-dependency edges — reader of version i -> writer of version
    i+1 — recovering the G-single/G2 cycles the reference's DISABLED
    rw-graph would have found (kafka.clj keeps the remnants commented
    out because polls make rw edges noisy under rebalances; here the
    flag lets a suite opt in when its client keeps assignments
    stable).  The screen runs on `device`."""
    from ..checker.elle.graph import DepGraph
    from ..ops.scc import check_cycles_device

    g = DepGraph()
    for k, v2w in writer_of.items():
        vo = orders.get(k)
        if vo is None:
            continue
        for v2, op2 in v2w.items():
            i2 = vo.by_value.get(v2)
            if i2 is None or i2 == 0:
                continue
            v1 = vo.by_index[i2 - 1]
            op1 = v2w.get(v1)
            if op1 is not None and op1.index != op2.index:
                g.add_edge(op1.index, op2.index, "ww")
    for k, v2rs in readers_of.items():
        for v, readers in v2rs.items():
            w = writer_of.get(k, {}).get(v)
            if w is not None:
                for r in readers:
                    if r.index != w.index:
                        g.add_edge(w.index, r.index, "wr")
        if rw_edges:
            vo = orders.get(k)
            if vo is None:
                continue
            # Anti-dependency fires only from the LAST version each
            # reader observed of the key (its final position): a
            # reader that also polled the successor saw it, so there
            # is no "unread overwrite" to anti-depend on.
            last_read: dict[int, tuple[int, Any]] = {}
            for v, readers in v2rs.items():
                i = vo.by_value.get(v)
                if i is None:
                    continue
                for r in readers:
                    cur = last_read.get(r.index)
                    if cur is None or i > cur[0]:
                        last_read[r.index] = (i, r)
            for r_idx, (i, r) in last_read.items():
                if i + 1 >= len(vo.by_index):
                    continue
                w2 = writer_of.get(k, {}).get(vo.by_index[i + 1])
                if w2 is not None and r_idx != w2.index:
                    g.add_edge(r_idx, w2.index, "rw")
    return check_cycles_device([g], device=device)[0]


def analyze(history: History | list[Op], *,
            rw_edges: bool = False,
            device: Union[str, torch.device] = "cuda") -> dict:
    """Full kafka analysis -> {"valid", "anomaly-types", "anomalies",
    counts} (kafka.clj:1879-1984).  `rw_edges` opts into
    anti-dependency cycle edges (see dependency_cycles); the cycle
    screen runs on `device`, resolved first, so a missing card raises
    before any analysis."""
    device = _device.resolve(device)
    ops = [o for o in history
           if o.f in TXN_FS + ("assign", "subscribe")]
    wbt = writes_by_type(ops)
    rbt = reads_by_type(ops)
    orders, order_errors = version_orders(ops, rbt)
    writer_of = _writer_of(ops)
    readers_of = _readers_of(ops)

    anomalies: dict[str, Any] = {}
    if order_errors:
        anomalies["inconsistent-offsets"] = order_errors
    g1a = g1a_cases(ops, wbt)
    if g1a:
        anomalies["G1a"] = g1a
    lost = lost_write_cases(ops, orders, rbt, writer_of)
    if lost:
        anomalies["lost-write"] = lost
    dups = duplicate_cases(orders)
    if dups:
        anomalies["duplicate"] = dups
    ip = int_poll_cases(ops, orders)
    if ip["skip"]:
        anomalies["int-poll-skip"] = ip["skip"]
    if ip["nonmonotonic"]:
        anomalies["int-poll-nonmonotonic"] = ip["nonmonotonic"]
    isnd = int_send_cases(ops, orders)
    if isnd["skip"]:
        anomalies["int-send-skip"] = isnd["skip"]
    if isnd["nonmonotonic"]:
        anomalies["int-send-nonmonotonic"] = isnd["nonmonotonic"]
    pc = poll_cases(ops, orders)
    if pc["skip"]:
        anomalies["poll-skip"] = pc["skip"]
    if pc["nonmonotonic"]:
        anomalies["nonmonotonic-poll"] = pc["nonmonotonic"]
    nms = nonmonotonic_send_cases(ops, orders)
    if nms:
        anomalies["nonmonotonic-send"] = nms
    cycles = dependency_cycles(ops, orders, writer_of, readers_of,
                               rw_edges=rw_edges, device=device)
    for c in cycles:
        anomalies.setdefault(c["type"], []).append(c)
    unseen = unseen_final(ops)

    info_types = {"unseen"} if unseen else set()
    bad_types = set(anomalies)
    valid: Any = not bad_types or ("unknown" if bad_types <= info_types
                                   else False)
    if valid is True and unseen:
        valid = True  # unseen alone is informational, like the reference
    return {
        "valid": valid if bad_types else True,
        "anomaly-types": sorted(bad_types),
        "anomalies": anomalies,
        "unseen": unseen,
        "key-count": len(orders),
    }


class KafkaChecker(Checker):
    """`analyze` as a checker, its cycle screen on `device` (the card by
    default, or "cpu")."""

    def __init__(self, *, rw_edges: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        self.rw_edges = rw_edges
        self.device = device

    def check(self, test: dict, history: History, opts: dict) -> dict:
        res = analyze(history.client_ops(), rw_edges=self.rw_edges,
                      device=self.device)
        # Conviction trail into the store dir: unseen/lag plots always,
        # anomalies.json + version orders + cycle DOTs when invalid
        # (tests/kafka.clj:99-180).
        from .kafka_viz import write_artifacts

        write_artifacts(res, opts, history.client_ops())
        return res


# ---------------------------------------------------------------------------
# Generator (kafka.clj:195-443)
# ---------------------------------------------------------------------------

SUBSCRIBE_RATIO = 1 / 8  # kafka.clj:236-241


class KafkaGen(Generator):
    """Rewrites list-append txns into send/poll micro-ops and
    interleaves subscribe/assign ops (txn-generator :195 +
    InterleaveSubscribes :219-241)."""

    __slots__ = ("inner", "rng", "sub_via")

    def __init__(self, inner: Any, rng: Optional[random.Random] = None,
                 sub_via: tuple = ("subscribe", "assign")):
        self.inner = inner
        self.rng = rng or random.Random(45100)
        self.sub_via = sub_via

    def op(self, test, ctx):
        res = gen_op(self.inner, test, ctx)
        if res is None:
            return None
        op, inner2 = res
        nxt = KafkaGen(inner2, self.rng, self.sub_via)
        if op is PENDING:
            return (PENDING, self)
        keys = sorted({m[1] for m in (op.value or [])})
        if self.rng.random() < SUBSCRIBE_RATIO:
            f = self.rng.choice(list(self.sub_via))
            sub = fill_in_op({"f": f, "value": keys}, ctx)
            if sub is PENDING:
                return (PENDING, self)
            return (sub, self)  # txn deferred: re-ask inner next time
        mops = [(["send", m[1], m[2]] if m[0] == "append" else ["poll"])
                for m in (op.value or [])]
        fs = {m[0] for m in mops}
        f = "send" if fs == {"send"} else (
            "poll" if fs == {"poll"} else "txn")
        return (op.replace(f=f, value=mops), nxt)


def final_polls(keys: Iterable[Any], polls: int = 10) -> list:
    """Quiesce-phase generator: assign everything, seek to beginning,
    poll repeatedly (kafka.clj:403-431)."""
    ks = sorted(keys)
    return [{"f": "assign", "value": ks, "seek-to-beginning?": True}] + [
        {"f": "poll", "value": [["poll"]]} for _ in range(polls)
    ]


# ---------------------------------------------------------------------------
# In-memory log client (the checker's test double)
# ---------------------------------------------------------------------------


class LogState:
    """A shared broker: per-key append-only logs with fault knobs.

    faults: set of {"lose-acked"(drop an acked send from the log),
    "duplicate"(append twice), "skip-offset"(leave gaps),
    "unseen"(drop tail reads)} with `fault_rate` probability each."""

    def __init__(self, faults: Optional[set] = None,
                 fault_rate: float = 0.1,
                 rng: Optional[random.Random] = None):
        self.logs: dict[Any, list] = defaultdict(list)
        # Reentrant: a client holds it across a whole transaction.
        self.lock = threading.RLock()
        self.faults = faults or set()
        self.fault_rate = fault_rate
        self.rng = rng or random.Random(45100)

    def _fault(self, name: str) -> bool:
        return name in self.faults and self.rng.random() < self.fault_rate

    def send(self, k, v) -> Optional[int]:
        with self.lock:
            log = self.logs[k]
            if self._fault("skip-offset"):
                log.append(None)  # burn an offset (txn metadata slot)
            off = len(log)
            log.append(v)
            if self._fault("duplicate"):
                log.append(v)
            if self._fault("lose-acked"):
                log[off] = None  # ack then lose it
            return off

    def read_from(self, k, position: int, limit: int = 32):
        with self.lock:
            log = self.logs[k]
            out = []
            pos = position
            while pos < len(log) and len(out) < limit:
                v = log[pos]
                if v is not None:
                    out.append([pos, v])
                pos += 1
            if out and self._fault("unseen"):
                out = out[: max(1, len(out) // 2)]
                pos = out[-1][0] + 1
            return out, pos


class InMemoryKafkaClient(jc.Client):
    """Producer+consumer against a LogState (kafka.clj's combined
    client shape, :24-43)."""

    def __init__(self, state: Optional[LogState] = None):
        self.state = state or LogState()
        self.assigned: list = []
        self.positions: dict[Any, int] = {}

    def open(self, test, node):
        c = InMemoryKafkaClient(self.state)
        return c

    def invoke(self, test, op):
        if op.f in ("subscribe", "assign"):
            self.assigned = list(op.value or [])
            seek = op.ext.get("seek-to-beginning?")
            self.positions = {
                k: 0 if seek else self.positions.get(k, 0)
                for k in self.assigned
            }
            return op.complete(OK)
        out = []
        # One transaction at a time, as a transactional broker commits
        # them: the JAX package's client takes the log's lock per
        # micro-op, so two concurrent transactions can interleave into a
        # real G0 or G1c and fail a fault-free run.
        with self.state.lock:
            for mop in op.value or []:
                if mop[0] == "send":
                    _, k, v = mop
                    off = self.state.send(k, v)
                    out.append(["send", k, [off, v]])
                else:
                    polled: dict = {}
                    for k in self.assigned:
                        pairs, pos = self.state.read_from(
                            k, self.positions.get(k, 0)
                        )
                        self.positions[k] = pos
                        if pairs:
                            polled[k] = pairs
                    out.append(["poll", polled])
        return op.complete(OK, value=out)

    def reusable(self, test):
        return True


def revive_polls(history: History) -> History:
    """The history with each poll's {key: pairs} map keyed by the keys
    the history's sends and assignments name (a stored history has
    JSON's string keys there); ops and indices otherwise unchanged."""
    keys: dict = {}
    for op in history:
        if op.f in ("assign", "subscribe"):
            for k in op.value or []:
                keys.setdefault(str(k), k)
        elif op.f in TXN_FS:
            for mop in op.value or []:
                if mop and mop[0] == "send":
                    keys.setdefault(str(mop[1]), mop[1])

    def mops(value):
        return [["poll", {keys.get(k, k): pairs
                          for k, pairs in mop[1].items()}]
                if mop and mop[0] == "poll" and len(mop) > 1
                and isinstance(mop[1], dict) else mop
                for mop in value]

    return History([o.replace(value=mops(o.value))
                    if o.f in ("txn", "poll") and isinstance(o.value, list)
                    else o for o in history], reindex=False)


def workload(opts: Optional[dict] = None) -> dict:
    """Test-map fragment: generator + client + checker + final reads
    (kafka.clj's `workload`, end of file).  The checker's cycle screen
    runs on opts["device"] ("cuda" by default, or "cpu")."""
    from ..checker.elle import AppendGen
    from ..generator.core import FnGen

    opts = opts or {}
    rng = random.Random(opts.get("seed", 45100))
    la = AppendGen(
        key_count=opts.get("key-count", 4),
        min_txn_length=1,
        max_txn_length=opts.get("max-txn-length", 4),
        max_writes_per_key=opts.get("max-writes-per-key", 128),
        rng=rng,
    )
    keys = list(range(opts.get("key-count", 4)))
    state = LogState(
        faults=opts.get("faults"),
        fault_rate=opts.get("fault-rate", 0.1),
        rng=rng,
    )
    return {
        "name": "kafka",
        "generator": KafkaGen(FnGen(la), rng),
        "final-generator": final_polls(keys,
                                       opts.get("final-polls", 10)),
        "client": InMemoryKafkaClient(state),
        "checker": KafkaChecker(device=opts.get("device", "cuda")),
        "sub-via": ("subscribe", "assign"),
        "history-reviver": revive_polls,
    }
