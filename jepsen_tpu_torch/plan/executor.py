"""The plan executor: one engine that runs any checking plan.

The port's copy of `jepsen_tpu/plan/executor.py`.  `execute(plan, ctx,
seeds)` is a single forward sweep over the plan's nodes (the IR
guarantees edges point forward): each node's pass-family runner decides
keys, routes the rest along the node's typed edges, and the sweep
carries work queues node to node.  The contiguous tail of `group=True`
nodes is the digest-dedup scope — the settle-memo mechanic of the
many-key checker: on entry, keys collapse to one representative per
packed digest (memo hits — the in-memory settle memo first, then the
persistent plan memo — skip the scope); on exit, each representative's
verdict fans out to its group, sanitized of positional certificates.

The runners call the engines (`check_wgl_witness_stream`,
`check_refute`, `check_wgl_batched`, the "settle" `Linearizable`,
`_device_first`, `_memo_get`/`_memo_put`) on the context's `device`,
with the hand formulas' knobs when the cost model is untrained.  They
are the port's only copy of the many-key settle policy: the port keeps
no hand-wired ladder beside the plan.  Plan-level counters land under
`wgl.plan.*`, the settle tiers' under `wgl.settle.*`; the keys each tier
decided also go to `ctx.tiers`, the many-key result's "tiers".

Where the reference swallows a failure, the port narrows it: an error
for which `degrade.is_device_fault` is true (a kernel that did not
build or launch, a missing card, a CUDA error, a card exhausted after
the halved retry) propagates out of every runner.  A resource error in
the stream takes the reference's step (the keys fall through to the
next tier, on the same card); any other exception keeps the
reference's behaviour.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from collections import Counter, OrderedDict
from typing import Any, Callable, Optional

import torch

from .. import telemetry
from ..ops import degrade
from ..telemetry import profile
from . import cache as plan_cache
from .ir import PassFamily, PassNode, Plan, family, register_family

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ExecContext:
    """Everything a runner needs: the cohort's data, the checker
    template whose knobs seed the engines, the device, shared budget
    state, and per-key scratch notes (device verdicts, screen
    outcomes)."""

    test: dict
    subs: dict
    packs: dict
    model: Any
    pm: Any
    lin: Any
    opts: dict
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cuda"))
    bound: Optional[int] = None
    #: The mesh (parallel/mesh.py) the batched tier splits keys over,
    #: or None for `device` alone.
    mesh: Any = None
    checker: Any = None
    #: "cohort" (IndependentChecker), "packs" (wire-packed
    #: submissions), or "single" (one Linearizable history).
    mode: str = "cohort"
    #: packs mode: absolute monotonic deadline.
    deadline: Optional[float] = None
    #: Plan-identity facts for the persistent memo key: model, initial
    #: state, algorithm, budgets.  Changing any of them misses.
    identity: dict = dataclasses.field(default_factory=dict)
    notes: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(default_factory=dict)
    #: Keys decided per tier: the many-key result's "tiers".
    tiers: Counter = dataclasses.field(default_factory=Counter)
    _digests: dict = dataclasses.field(default_factory=dict)
    _t0: Optional[float] = None

    # -- shared tier budget: one clock for the stream and the settle -------

    def start_clock(self) -> None:
        if self._t0 is None:
            self._t0 = time.monotonic()

    def budget_left(self) -> Optional[float]:
        if self.mode == "packs":
            if self.deadline is None:
                return None
            return max(1.0, self.deadline - time.monotonic())
        if self.lin.time_limit_s is None:
            return None
        self.start_clock()
        return max(1.0,
                   self.lin.time_limit_s - (time.monotonic() - self._t0))

    # -- per-key helpers ------------------------------------------------------

    def digest(self, k: Any) -> str:
        d = self._digests.get(k)
        if d is None:
            from ..parallel.independent import _settle_digest

            d = self._digests[k] = _settle_digest(self.packs[k], self.pm)
        return d

    def pmemo_key(self, k: Any) -> str:
        return plan_cache.memo_key(self.digest(k), self.identity)

    def note(self, k: Any) -> dict:
        n = self.notes.get(k)
        if n is None:
            n = self.notes[k] = {}
        return n

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n


# ---------------------------------------------------------------------------
# Family runners — each calls one engine.
# ---------------------------------------------------------------------------


def _run_host_fallback(ctx: ExecContext, node: PassNode, keys: list):
    """Keys with no packed form: the single-key checker per key (the
    host-model search)."""
    from ..checker.core import check_safe
    from ..utils import bounded_pmap

    lin = ctx.lin
    rs = bounded_pmap(
        lambda k: check_safe(lin, ctx.test, ctx.subs[k],
                             {**ctx.opts, "history_key": k}),
        keys, bound=ctx.bound)
    ctx.tiers["unpackable"] += len(keys)
    return dict(zip(keys, rs)), {}


def _run_online(ctx: ExecContext, node: PassNode, keys: list):
    """Digest-gated consumption of a streaming session's online proofs
    (can-prove-valid: a consumed verdict was proven while the run was
    still going)."""
    from ..parallel.independent import _online_digest

    sess = (ctx.test or {}).get("streaming-session")
    decided: dict = {}
    if sess is not None:
        for k in keys:
            d = _online_digest(sess, ctx.pm, ctx.subs[k])
            r = sess.consume(k, d) if d is not None else None
            if r is not None:
                decided[k] = r
    if decided:
        ctx.tiers["online"] += len(decided)
        if telemetry.enabled():
            telemetry.count("wgl.settle.online-proven", len(decided))
    rest = [k for k in keys if k not in decided]
    return decided, ({"unknown": rest} if rest else {})


def _run_pmemo(ctx: ExecContext, node: PassNode, keys: list):
    """Persistent plan-memo lookup (cache.py): a restarted process
    re-checking byte-identical work replays the journaled verdict."""
    pmemo = plan_cache.active_memo()
    if pmemo is None or not keys:
        return {}, ({"unknown": list(keys)} if keys else {})
    decided, rest = {}, []
    for k in keys:
        hit = pmemo.get(ctx.pmemo_key(k))
        if hit is not None:
            hit["memo-hit"] = True
            decided[k] = hit
        else:
            rest.append(k)
    if decided:
        ctx.tiers["plan-memo-hit"] += len(decided)
    return decided, ({"unknown": rest} if rest else {})


def _run_length_router(ctx: ExecContext, node: PassNode, keys: list):
    """Routes long keys (the batched BFS pads every key to the longest)
    to the per-key device ladder; decides nothing."""
    thr = node.knobs.get("threshold", 2000)
    long_keys = [k for k in keys if ctx.packs[k].n > thr]
    short = [k for k in keys if ctx.packs[k].n <= thr]
    routed: dict = {}
    if long_keys:
        routed["long"] = long_keys
    if short:
        routed["unknown"] = short
    return {}, routed


def _run_single_device(ctx: ExecContext, node: PassNode, keys: list):
    """The per-key witness-first device ladder for keys too long for
    the batched BFS."""
    from ..checker.core import check_safe
    from ..checker.linearizable import Linearizable
    from ..utils import bounded_pmap

    lin = ctx.lin
    long_chk = Linearizable(
        ctx.model, "wgl-tpu", beam=lin.beam, max_beam=lin.max_beam,
        time_limit_s=lin.time_limit_s, max_configs=lin.max_configs,
        device=ctx.device)
    rs = bounded_pmap(
        lambda k: check_safe(long_chk, ctx.test, ctx.subs[k],
                             {**ctx.opts, "history_key": k}),
        keys, bound=ctx.bound)
    ctx.tiers["long"] += len(keys)
    return dict(zip(keys, rs)), {}


def _run_stream(ctx: ExecContext, node: PassNode, keys: list):
    """Cohort-wide witness stream (ops/wgl_stream.py): proves keys
    only; everything else falls through the unknown edge."""
    from ..ops.wgl_stream import check_wgl_witness_stream

    ctx.start_clock()
    kw: dict = {}
    if node.knobs.get("segment") is not None:
        kw["segment_keys"] = node.knobs["segment"]
    if node.knobs.get("max_restarts") is not None:
        kw["max_restarts"] = node.knobs["max_restarts"]
    limit = (ctx.lin.time_limit_s if ctx.mode == "cohort"
             else ctx.budget_left())
    try:
        stream_v = check_wgl_witness_stream(
            [ctx.packs[k] for k in keys], ctx.pm, time_limit_s=limit,
            device=ctx.device, **kw)
    except Exception as e:  # noqa: BLE001 — a sound fallback exists
        if degrade.is_device_fault(e):
            raise
        if degrade.is_resource_error(e):
            degrade.record("stream", "fall-through", e)
        log.warning("stream witness failed; falling back to the batched "
                    "search for all keys", exc_info=True)
        stream_v = [None] * len(keys)
    decided: dict = {}
    rest = []
    for k, v in zip(keys, stream_v):
        if v is True:
            decided[k] = {
                "valid": True,
                "algorithm": "wgl-tpu-stream",
                "configs-explored": int(ctx.packs[k].n_ok),
            }
        else:
            rest.append(k)
    if ctx.mode == "cohort":
        ctx.tiers["stream-proven"] += len(decided)
        if telemetry.enabled():
            telemetry.count("wgl.settle.stream-proven", len(decided))
    pmemo = plan_cache.active_memo()
    if pmemo is not None and decided:
        from ..parallel.independent import _sanitize_settle

        for k, r in decided.items():
            pmemo.put(ctx.pmemo_key(k), _sanitize_settle(r))
    return decided, ({"unknown": rest} if rest else {})


def _run_screen(ctx: ExecContext, node: PassNode, keys: list):
    """Refutation screens (checker/refute.py).  "classify" (cohort: a
    firing screen routes the key to the detail pass for a certificate)
    or "decide" (packs: the screen's exact refutation is the verdict)."""
    from ..checker.refute import check_refute
    from ..utils import bounded_pmap

    decide = node.knobs.get("mode") == "decide"

    def screen_one(k):
        b = ctx.budget_left()
        try:
            return check_refute(ctx.packs[k], ctx.pm,
                                time_limit_s=30.0 if b is None
                                else min(b, 30.0))
        except Exception as e:  # noqa: BLE001 — host numpy, no verdict
            if degrade.is_device_fault(e):
                raise
            log.warning("refutation screen failed for key %r", k,
                        exc_info=True)
            return None  # the search tiers decide

    screened = dict(zip(keys, bounded_pmap(screen_one, keys,
                                           bound=ctx.bound)))
    decided: dict = {}
    refuted, unknown = [], []
    for k in keys:
        ref = screened[k]
        if ref is None:
            unknown.append(k)
        elif decide:
            r: dict = {
                "valid": ref.valid,
                "algorithm": "refute-screen",
                "configs-explored": int(ref.configs_explored),
            }
            if ref.valid == "unknown" and ref.reason:
                r["reason"] = ref.reason
            decided[k] = r
        else:
            ctx.note(k)["screen_fired"] = True
            refuted.append(k)
    routed: dict = {}
    if refuted:
        routed["refuted"] = refuted
    if unknown:
        routed["unknown"] = unknown
    return decided, routed


def _run_batched(ctx: ExecContext, node: PassNode, keys: list):
    """Batched frontier BFS (ops/wgl_batched.py) over the screen
    survivors.  True is proven; False is an exact device refutation
    routed to the detail pass; "unknown" falls through."""
    from ..ops.wgl_batched import check_wgl_batched

    if not keys:
        return {}, {}
    lin = ctx.lin
    beam = node.knobs.get("beam") or min(lin.beam, 32)
    batch = check_wgl_batched(
        [ctx.packs[k] for k in keys], ctx.pm, beam=beam,
        max_beam=max(lin.max_beam, lin.beam), mesh=ctx.mesh,
        time_limit_s=ctx.budget_left(), device=ctx.device)
    decided: dict = {}
    refuted, unknown = [], []
    n_proven = 0
    for i, k in enumerate(keys):
        v = batch.valid[i]
        n = ctx.note(k)
        n["device_verdict"] = v
        n["device_explored"] = int(batch.explored[i])
        if v is True:
            decided[k] = {
                "valid": True,
                "algorithm": "wgl-tpu-batched",
                "configs-explored": int(batch.explored[i]),
            }
            n_proven += 1
        elif v is False:
            refuted.append(k)
        else:
            unknown.append(k)
    ctx.count("batched-proven", n_proven)
    routed: dict = {}
    if refuted:
        routed["refuted"] = refuted
    if unknown:
        routed["unknown"] = unknown
    return decided, routed


def _run_settle_exact(ctx: ExecContext, node: PassNode, keys: list):
    """The parallel CPU settle: screen-refuted keys re-derive their
    certificate, device-refuted keys get a small detail slice (the
    exact device verdict stands if it expires), unknowns go to the
    exact engine."""
    from ..checker.core import check_safe
    from ..checker.linearizable import Linearizable
    from ..utils import bounded_pmap

    lin, model = ctx.lin, ctx.model
    detail_budget = getattr(ctx.checker, "REFUTED_DETAIL_BUDGET_S", 10.0)

    def settle_one(k):
        n = ctx.notes.get(k) or {}
        dv = n.get("device_verdict")
        budget = ctx.budget_left()
        if dv is False:
            budget = (detail_budget if budget is None
                      else min(budget, detail_budget))
        single = Linearizable(model, "settle", time_limit_s=budget,
                              max_configs=lin.max_configs,
                              device=ctx.device)
        r = check_safe(single, ctx.test, ctx.subs[k],
                       {**ctx.opts, "history_key": k})
        if dv is not None:
            r["device-verdict"] = dv
        if dv is False:
            if r.get("valid") == "unknown":
                # The detail pass ran out; the BFS's refutation is exact
                # (no overflow) and stands on its own.
                r = {
                    "valid": False,
                    "algorithm": "wgl-tpu-batched",
                    "configs-explored": n.get("device_explored", 0),
                    "device-verdict": False,
                }
            elif r.get("valid") is True:
                # Two exact engines disagreeing is a checker bug: keep
                # the CPU verdict, loudly.
                log.error("device/CPU verdict mismatch on key %r: batched "
                          "BFS refuted, exact engine proved valid; keeping "
                          "the CPU verdict", k)
        return r

    decided = dict(zip(keys, bounded_pmap(settle_one, keys,
                                          bound=ctx.bound)))
    for k in decided:
        n = ctx.notes.get(k) or {}
        if n.get("device_verdict") is False:
            ctx.count("batched-refuted")
        elif n.get("screen_fired"):
            ctx.count("screen-refuted")
        else:
            ctx.count("cpu-settled")
    return decided, {}


def _run_packs_exact(ctx: ExecContext, node: PassNode, keys: list):
    """The exact CPU engine over wire-packed submissions (no subs, no
    batched tier)."""
    decided = {}
    for k in keys:
        res, engine = ctx.lin._cpu_exact(ctx.packs[k], ctx.pm, "auto",
                                         time_limit_s=ctx.budget_left())
        r: dict = {
            "valid": res.valid,
            "algorithm": engine,
            "configs-explored": int(res.configs_explored),
        }
        if res.valid == "unknown" and res.reason:
            r["reason"] = res.reason
        decided[k] = r
    return decided, {}


def _run_device_ladder(ctx: ExecContext, node: PassNode, keys: list):
    """The whole single-history device-first ladder of
    `Linearizable._device_first` (screens, witness, frontier BFS, the
    halved retry, exact settling) as one exact pass; the test map's
    "search-mesh" splits each search's BFS frontier."""
    mesh = (ctx.test or {}).get("search-mesh")
    return {k: ctx.lin._device_first(ctx.packs[k], ctx.pm, ctx.device,
                                     ctx.opts, mesh=mesh)
            for k in keys}, {}


def _run_elle_cycles(ctx: ExecContext, node: PassNode, keys: list):
    """The Elle dependency-cycle pass (checker/elle/graph.py), screened
    by the closure on the card unless the node's device knob is "off".
    `ctx.packs` carries DepGraphs; a found cycle refutes, none proves
    acyclicity."""
    decided = {}
    for k in keys:
        g = ctx.packs[k]
        dev = node.knobs.get("device")
        if dev == "off":
            from ..checker.elle.graph import check_cycles

            decided[k] = {"cycles": check_cycles(g)}
        else:
            from ..ops.scc import check_cycles_device

            decided[k] = {"cycles": check_cycles_device([g], device=dev)[0]}
    return decided, {}


def _register_builtins() -> None:
    for fam in (
        PassFamily("host-fallback", "exact", "host", _run_host_fallback,
                   doc="host-model search for unpackable keys"),
        PassFamily("online-consume", "can-prove-valid", "host",
                   _run_online,
                   doc="digest-gated streaming-session verdicts"),
        PassFamily("persistent-memo", "exact", "host", _run_pmemo,
                   doc="journaled plan-memo replay (cache.py)"),
        PassFamily("length-router", "exact", "host", _run_length_router,
                   knob_spec=("threshold",),
                   doc="routes only; decides nothing"),
        PassFamily("single-device", "exact", "device",
                   _run_single_device,
                   doc="per-key wgl-tpu ladder for long keys"),
        PassFamily("stream-witness", "can-prove-valid", "device",
                   _run_stream, knob_spec=("segment", "max_restarts"),
                   doc="ops/wgl_witness over one barrier stream "
                       "(ops/wgl_stream)"),
        PassFamily("refute-screen", "can-refute", "host", _run_screen,
                   knob_spec=("mode",),
                   doc="checker/refute.py sound screens"),
        PassFamily("batched-bfs", "exact", "device", _run_batched,
                   knob_spec=("beam",),
                   doc="ops/wgl_batched frontier BFS over many keys"),
        PassFamily("settle-exact", "exact", "host", _run_settle_exact,
                   doc="wgl_cpu / wgl_event via the settle algorithm"),
        PassFamily("packs-exact", "exact", "host", _run_packs_exact,
                   doc="exact CPU engine over wire-packed histories"),
        PassFamily("device-ladder", "exact", "device",
                   _run_device_ladder,
                   doc="single-history device-first ladder"),
        PassFamily("elle-cycles", "can-refute", "device",
                   _run_elle_cycles, knob_spec=("device",),
                   doc="elle cycle pass (ops/scc.py closure screen)"),
    ):
        register_family(fam)


_register_builtins()


# ---------------------------------------------------------------------------
# Group scope: the settle-memo mechanic
# ---------------------------------------------------------------------------


class _GroupState:
    def __init__(self) -> None:
        self.groups: "OrderedDict[str, list]" = OrderedDict()
        self.group_result: dict[str, dict] = {}
        self.key_digest: dict[Any, str] = {}
        self.reps: list = []
        self.n_memo = 0


def _enter_group(ctx: ExecContext, keys: list) -> _GroupState:
    """Digest-groups the keys and replays memoized verdicts: the
    in-memory settle memo first, then the persistent plan memo (which
    also warms the in-memory one)."""
    from ..parallel.independent import _memo_get, _memo_put

    gs = _GroupState()
    for k in keys:
        gs.groups.setdefault(ctx.digest(k), []).append(k)
    pmemo = plan_cache.active_memo()
    for d, members in gs.groups.items():
        hit = _memo_get(d)
        if hit is None and pmemo is not None:
            ph = pmemo.get(plan_cache.memo_key(d, ctx.identity))
            if ph is not None:
                hit = ph
                _memo_put(d, ph)
        if hit is not None:
            gs.group_result[d] = hit
        else:
            rep = members[0]
            gs.key_digest[rep] = d
            gs.reps.append(rep)
    gs.n_memo = sum(len(gs.groups[d]) for d in gs.group_result)
    return gs


def _memo_store(ctx: ExecContext, digest: str, r: dict) -> None:
    from ..parallel.independent import _memo_put, _sanitize_settle

    _memo_put(digest, r)
    if r.get("valid") in (True, False):
        pmemo = plan_cache.active_memo()
        if pmemo is not None:
            pmemo.put(plan_cache.memo_key(digest, ctx.identity),
                      _sanitize_settle(r))


def _fanout(ctx: ExecContext, gs: _GroupState) -> dict:
    """Every group's verdict to every member: the representative keeps
    the full result (its positional certificates cite its own history
    slice); the other members share the sanitized verdict."""
    from ..parallel.independent import _sanitize_settle

    live = set(gs.key_digest.values())
    settled: dict = {}
    for d, members in gs.groups.items():
        r = gs.group_result.get(d)
        if r is None:  # defensive: unreachable
            continue
        if d in live:
            settled[members[0]] = r
            extra = members[1:]
            gs.n_memo += len(extra)
        else:
            extra = members  # a memo hit from an earlier check: all share
        for k2 in extra:
            shared = _sanitize_settle(r)
            shared["memo-hit"] = True
            settled[k2] = shared
    return settled


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------


def execute(plan: Plan, ctx: ExecContext,
            seeds: Optional[dict] = None) -> dict:
    """Runs a plan to completion; returns {key: result}."""
    telemetry.count("wgl.plan.execute")
    results: dict = {}
    work: dict[str, list] = {nid: [] for nid in plan.nodes}
    for nid, ks in (seeds or {}).items():
        work[nid].extend(ks)

    nodes = list(plan)
    pre = [n for n in nodes if not n.group]
    grp = [n for n in nodes if n.group]

    def route(node: PassNode, routed: dict) -> None:
        for label, ks in routed.items():
            if not ks:
                continue
            tgt = node.target(label)
            if tgt is None:
                # A plan without a fallback edge leaves keys undecided:
                # sound, but worth recording.
                for k in ks:
                    results[k] = {
                        "valid": "unknown",
                        "error": f"plan: no {label!r} route out of node "
                                 f"{node.id!r}",
                    }
                telemetry.count("wgl.plan.unrouted", len(ks))
            else:
                work[tgt].extend(ks)

    for node in pre:
        keys = work.get(node.id) or []
        if not keys:
            continue
        telemetry.count("wgl.plan.pass-runs")
        decided, routed = family(node.family).runner(ctx, node, keys)
        results.update(decided)
        route(node, routed)

    if grp:
        gkeys = work.get(grp[0].id) or []
        if gkeys:
            results.update(_execute_group(ctx, grp, gkeys, work, route))
    return results


#: The settle tiers' counts, in the order the many-key result lists them.
_SETTLE_TIERS = ("screen-refuted", "batched-proven", "batched-refuted",
                 "cpu-settled")


def _execute_group(ctx: ExecContext, grp: list, gkeys: list,
                   work: dict, route: Callable) -> dict:
    # One cost record for the whole settle pipeline (cohort mode only);
    # the batched BFS's record nests inside it.
    cap = (profile.capture(
               "settle", device=ctx.device, keys=len(gkeys),
               ops=int(sum(ctx.packs[k].n for k in gkeys)))
           if ctx.mode == "cohort" else contextlib.nullcontext(None))
    with cap as _ps:
        gs = _enter_group(ctx, gkeys)
        work[grp[0].id] = list(gs.reps)
        for node in grp:
            keys = work.get(node.id) or []
            if not keys:
                continue
            telemetry.count("wgl.plan.pass-runs")
            decided, routed = family(node.family).runner(ctx, node, keys)
            for k, r in decided.items():
                d = gs.key_digest[k]
                gs.group_result[d] = r
                _memo_store(ctx, d, r)
            route(node, routed)
        settled = _fanout(ctx, gs)
        if ctx.mode == "cohort":
            n = {name: ctx.counts.get(name, 0) for name in _SETTLE_TIERS}
            for name, v in n.items():
                if v:
                    ctx.tiers[name] += v
            ctx.tiers["memo-hit"] += gs.n_memo
            if telemetry.enabled():
                for name, v in n.items():
                    telemetry.count(f"wgl.settle.{name}", v)
                telemetry.count("wgl.settle.memo-hit", gs.n_memo)
            if _ps is not None:
                _ps.outcome = {**n, "memo-hit": gs.n_memo}
    return settled
