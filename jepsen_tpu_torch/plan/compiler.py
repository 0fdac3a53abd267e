"""The plan compiler: packed work + model spec + budget -> Plan.

The port's copy of `jepsen_tpu/plan/compiler.py`.  Entry points, one
per call site that used to wire the tier ladder by hand:

* `run_cohort`  — IndependentChecker's per-key cohort (online consume,
  long-key split, stream witness, the settle pipeline)
* `run_packs`   — wire-packed submissions (stream, memo, decide-mode
  screen, exact CPU; no batched tier)
* `run_single`  — one Linearizable history on the device paths
* `plan_cycle_fn` — a one-node plan for the Elle cycle pass

Each compiles a Plan whose knobs come from the cost model
(plan/costmodel.py) — the hand formulas when untrained or with
`JEPSEN_PLAN=0`, in which case the plan does exactly the reference's
hand-wired ladder's work — and runs it through plan/executor.py on the
checker's device.  The persistent-memo node joins a plan only when a
cache directory is configured (cache.py).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .. import telemetry
from . import cache as plan_cache
from . import costmodel
from .executor import ExecContext, execute
from .ir import PassNode, Plan


def _identity(lin: Any, pm: Any, kind: str) -> dict:
    """The persistent-memo identity: every fact whose change must miss
    the journaled verdicts (the packed digest is the key's other half).
    The reference's, so both packages key one memo alike."""
    return {
        "kind": kind,
        "model": pm.name,
        "init": [int(v) for v in pm.init_state],
        "width": int(pm.state_width),
        "algorithm": lin.algorithm,
        "budget-s": lin.time_limit_s,
        "max-configs": lin.max_configs,
    }


def _knob_counter(*sources: str) -> None:
    telemetry.count("wgl.plan.knobs-model" if "model" in sources
                    else "wgl.plan.knobs-heuristic")


def _brownout_drops() -> tuple:
    """Optional pass ids an overload ladder is dropping.  Always empty:
    the port has no checker daemon yet, and with it no brownout ladder
    (the reference reads checkerd's).  Plans built without the dropped
    tiers would stay sound — those tiers only prove keys early."""
    return ()


# ---------------------------------------------------------------------------
# Cohort plans (IndependentChecker)
# ---------------------------------------------------------------------------


def compile_cohort_plan(
    checker: Any, test: dict, lin: Any, pm: Any,
    n_keys: int, n_ops: int, *,
    has_unpackable: bool,
) -> tuple[Plan, str]:
    """-> (plan, entry-node id for packable keys).  Node order is the
    reference's ladder's; the cost model only turns knobs (and may drop
    the stream tier when trained data says it loses)."""
    sess = ((test or {}).get("streaming-session")
            if getattr(checker, "streaming", True) else None)
    cache_on = plan_cache.cache_dir() is not None
    stream_knobs, s_src = costmodel.choose_stream_knobs(n_keys, n_ops)
    batched_knobs, b_src = costmodel.choose_batched_knobs(
        n_keys, n_ops, lin.beam)
    order = costmodel.choose_tier_order(n_keys, n_ops, stream_knobs)
    _knob_counter(s_src, b_src)

    feats = {"keys": n_keys, "ops": n_ops}
    nodes: list[PassNode] = []
    if has_unpackable:
        nodes.append(PassNode("fallback", "host-fallback"))
    # The main chain: each entry's unknown edge points at the next.
    chain: list[PassNode] = []
    if sess is not None:
        chain.append(PassNode("online", "online-consume", features=feats))
    if cache_on:
        chain.append(PassNode("pmemo", "persistent-memo", features=feats))
    router = PassNode("router", "length-router", knobs={"threshold": 2000})
    chain.append(router)
    longdev = PassNode("longdev", "single-device", features=feats)
    dropped = _brownout_drops()
    stream = None
    if order != "skip-stream" and "stream" not in dropped:
        stream = PassNode("stream", "stream-witness",
                          knobs=dict(stream_knobs), features=feats)
    screen = PassNode("screen", "refute-screen", knobs={"mode": "classify"},
                      features=feats, group=True)
    batched = None
    if "batched" not in dropped:
        batched = PassNode("batched", "batched-bfs",
                           knobs=dict(batched_knobs), features=feats,
                           group=True)
    detail = PassNode("detail", "settle-exact", features=feats, group=True)

    after_router = stream if stream is not None else screen
    for a, b in zip(chain, chain[1:]):
        a.edges["unknown"] = b.id
    router.edges["long"] = longdev.id
    router.edges["unknown"] = after_router.id
    if stream is not None:
        stream.edges["unknown"] = screen.id
    screen.edges["refuted"] = detail.id
    if batched is not None:
        screen.edges["unknown"] = batched.id
        batched.edges["refuted"] = detail.id
        batched.edges["unknown"] = detail.id
    else:
        screen.edges["unknown"] = detail.id

    nodes.extend(chain)
    nodes.append(longdev)
    if stream is not None:
        nodes.append(stream)
    nodes.append(screen)
    if batched is not None:
        nodes.append(batched)
    nodes.append(detail)

    meta = {
        "kind": "cohort",
        "model": pm.name,
        "algorithm": lin.algorithm,
        "budget-s": lin.time_limit_s,
        "keys": n_keys,
        "knobs": "model" if "model" in (s_src, b_src) else "heuristic",
        "order": order,
    }
    if dropped:
        meta["brownout-dropped"] = list(dropped)
    return Plan(nodes, meta=meta), chain[0].id


def run_cohort(
    checker: Any, test: dict, subs: dict, packable: list,
    unpackable: list, packs: dict, model: Any, pm: Any, lin: Any,
    opts: dict, device: torch.device, tiers: Optional[Any] = None,
) -> dict:
    """Compiles and executes the cohort plan on `device`: everything
    after the packing partition of `IndependentChecker`.  The keys each
    tier decided are added to `tiers` (a Counter) when given."""
    n_ops = int(sum(packs[k].n for k in packable))
    plan, entry = compile_cohort_plan(
        checker, test, lin, pm, len(packable), n_ops,
        has_unpackable=bool(unpackable))
    telemetry.count("wgl.plan.compile")
    telemetry.count("wgl.plan.keys", len(packable) + len(unpackable))
    ctx = ExecContext(
        test=test, subs=subs, packs=packs, model=model, pm=pm, lin=lin,
        opts=opts, device=device, bound=getattr(checker, "bound", None),
        checker=checker, mode="cohort",
        identity=_identity(lin, pm, "cohort"))
    if tiers is not None:
        ctx.tiers = tiers
    seeds: dict = {}
    if unpackable:
        seeds["fallback"] = list(unpackable)
    if packable:
        seeds[entry] = list(packable)
    return execute(plan, ctx, seeds)


# ---------------------------------------------------------------------------
# Wire-packed plans
# ---------------------------------------------------------------------------


def compile_packs_plan(lin: Any, pm: Any, n_keys: int,
                       n_ops: int) -> tuple[Plan, str]:
    cache_on = plan_cache.cache_dir() is not None
    stream_knobs, s_src = costmodel.choose_stream_knobs(n_keys, n_ops)
    _knob_counter(s_src)
    feats = {"keys": n_keys, "ops": n_ops}
    chain: list[PassNode] = []
    if cache_on:
        chain.append(PassNode("pmemo", "persistent-memo", features=feats))
    dropped = _brownout_drops()
    if "stream" not in dropped:
        chain.append(PassNode("stream", "stream-witness",
                              knobs=dict(stream_knobs), features=feats))
    screen = PassNode("screen", "refute-screen", knobs={"mode": "decide"},
                      features=feats, group=True)
    exact = PassNode("exact", "packs-exact", features=feats, group=True)
    for a, b in zip(chain, chain[1:]):
        a.edges["unknown"] = b.id
    if chain:
        chain[-1].edges["unknown"] = screen.id
    screen.edges["unknown"] = exact.id
    meta = {
        "kind": "packs",
        "model": pm.name,
        "algorithm": lin.algorithm,
        "budget-s": lin.time_limit_s,
        "keys": n_keys,
    }
    if dropped:
        meta["brownout-dropped"] = list(dropped)
    plan = Plan(chain + [screen, exact], meta=meta)
    return plan, chain[0].id if chain else screen.id


def run_packs(packs: dict, model: Any, lin: Any,
              deadline: Optional[float],
              device: Optional[torch.device] = None) -> dict:
    """Decides wire-packed submissions {key: PackedOps} under an
    absolute monotonic `deadline`, on `device` (the checker's when
    None)."""
    from .. import device as _device

    dev = _device.resolve(lin.device if device is None else device)
    pm = model.packed()
    out: dict = {}
    live = []
    for k, p in packs.items():
        if p.n == 0:
            out[k] = {"valid": True, "algorithm": "empty"}
        else:
            live.append(k)
    if not live:
        return out
    n_ops = int(sum(packs[k].n for k in live))
    plan, entry = compile_packs_plan(lin, pm, len(live), n_ops)
    telemetry.count("wgl.plan.compile")
    telemetry.count("wgl.plan.keys", len(live))
    ctx = ExecContext(
        test={}, subs={}, packs=packs, model=model, pm=pm, lin=lin,
        opts={}, device=dev, mode="packs", deadline=deadline,
        identity=_identity(lin, pm, "packs"))
    out.update(execute(plan, ctx, {entry: live}))
    return out


# ---------------------------------------------------------------------------
# Single-history plans (Linearizable)
# ---------------------------------------------------------------------------

_SINGLE = "_history"


def run_single(lin: Any, packed: Any, pm: Any, model: Any,
               algorithm: str, test: dict, opts: dict,
               device: torch.device) -> dict:
    """One history through the executor on `device`: a persistent-memo
    probe (when a cache dir is configured) in front of the device-first
    ladder.  With no cache the plan is the single device-ladder node,
    whose runner is `Linearizable._device_first`."""
    cache_on = plan_cache.cache_dir() is not None
    nodes: list[PassNode] = []
    feats = {"ops": int(packed.n), "ok": int(packed.n_ok)}
    ladder = PassNode("ladder", "device-ladder", features=feats,
                      knobs={"beam": lin.beam, "max_beam": lin.max_beam,
                             "block": lin.block})
    if cache_on:
        nodes.append(PassNode("pmemo", "persistent-memo", features=feats,
                              edges={"unknown": "ladder"}))
    nodes.append(ladder)
    plan = Plan(nodes, meta={
        "kind": "single",
        "model": pm.name,
        "algorithm": algorithm,
        "budget-s": lin.time_limit_s,
    })
    telemetry.count("wgl.plan.compile")
    identity = _identity(lin, pm, "single")
    # Search-shape knobs join the identity: they cannot flip a verdict,
    # but a memo entry describes the plan that produced it.
    identity["beam"] = lin.beam
    identity["max-beam"] = lin.max_beam
    ctx = ExecContext(
        test=test, subs={}, packs={_SINGLE: packed}, model=model, pm=pm,
        lin=lin, opts=opts, device=device, mode="single",
        identity=identity)
    r = execute(plan, ctx, {nodes[0].id: [_SINGLE]})[_SINGLE]
    if cache_on and not r.get("memo-hit") \
            and r.get("valid") in (True, False):
        from ..parallel.independent import _sanitize_settle

        pmemo = plan_cache.active_memo()
        if pmemo is not None:
            pmemo.put(plan_cache.memo_key(ctx.digest(_SINGLE), identity),
                      _sanitize_settle(r))
    return r


# ---------------------------------------------------------------------------
# Elle plans (dependency-graph cycle pass)
# ---------------------------------------------------------------------------


def plan_cycle_fn(device: Any) -> Any:
    """A `cycle_fn` for the Elle analyses that routes the cycle pass
    through a one-node plan (the `elle-cycles` family) on `device`.
    None for "off", the host default (Tarjan).  Like the reference, no
    checker calls it: the Elle checkers keep their own cycle route."""
    if device == "off":
        return None

    def run(g: Any) -> Any:
        plan = Plan(
            [PassNode("cycles", "elle-cycles", knobs={"device": device},
                      features={"vertices": len(getattr(g, "adj", ()))})],
            meta={"kind": "elle", "device": device})
        telemetry.count("wgl.plan.compile")
        ctx = ExecContext(test={}, subs={}, packs={_SINGLE: g}, model=None,
                          pm=None, lin=None, opts={}, mode="single")
        return execute(plan, ctx, {"cycles": [_SINGLE]})[_SINGLE]["cycles"]

    return run
