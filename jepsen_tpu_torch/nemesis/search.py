"""Coverage-guided nemesis schedule search: the fault matrix as a fuzzer.

`tools/fault_matrix.py` enumerates fault scenarios by hand; this module
*searches* the schedule space the way TVM searches kernel-schedule
space: a **schedule genome** — a timed sequence of fault events — is
compiled into a runnable nemesis + generator pair (through the same
family packages `nemesis_package` composes), executed as a full
`core.run` in its own store dir, and scored by a **coverage map** keyed
on the run's observable behavior:

  * resilience counters (``node.*``, ``net.*``, ``nemesis.*``,
    ``wgl.degrade.*``, ``client.open.*``), log2-bucketed;
  * checker verdict/anomaly signatures per composed checker;
  * fault-ledger outcomes per family (healed-by-run vs healed-by-
    teardown vs healed-by-repair vs left outstanding).

Schedules that surface new feature combinations enter a **corpus**
persisted to the search dir; mutation and crossover operators (perturb
timing, swap families, widen/narrow target overlap, splice two
schedules) breed the next candidates from it.  Any schedule producing
a *hang*, *residue*, *unhealed ledger entry*, or *checker anomaly* is
handed to a **shrinker** that minimizes it to a smallest reproducing
schedule, emitted as a fault-matrix cell JSON under
``<search-dir>/cells/`` (replayable via
``tools/fault_matrix.py --cell <file>``).

Crash-safety contract: every searched event runs through the ordinary
nemeses, so it is born on the fault ledger (intent-before-inject
+ data-described compensator) in its *iteration's own store dir* — a
search process SIGKILLed mid-iteration leaves a normal crashed run
that ``jepsen repair <run-dir>`` heals, and `run_search` begins by
sweeping its runs dir for exactly those leftovers
(`heal_crashed_iterations`).  Targeting is floor-checked against the
``--node-loss-policy`` minimum *before* a schedule runs
(`respects_floor` / `enforce_floor`), and every node-targeting op goes
through `faults._pick_nodes`, which drops quarantined nodes at invoke
time — so the search can never fault the cluster below its survivable
minimum.

Determinism: a schedule carries its own seed, and every event carries
a `salt`; `materialize` draws all randomness (grudge choice, node
picks, netem behaviors, clock deltas) from ``Random(seed ^ salt)`` per
event — so the same genome always compiles to the same op timeline
(replays are deterministic), and the shrinker can drop events without
perturbing how the survivors materialize.

The port's copy of `jepsen_tpu/nemesis/search.py`.  What differs: the
runner's iterations keep the suite's "device" (the card by default), so
every iteration is checked where a plain run of the suite is, and a
device fault (`ops.degrade.is_device_fault`) raises out of `CoreRunner`
and `run_search` where the reference records any exception as a crashed
iteration; other errors stay data.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import random
import time
from typing import Any, Callable, Optional, Sequence

from .. import telemetry
from ..control import health
from ..ops import degrade
from ..generator.core import sleep as gen_sleep, time_limit
from ..utils import JepsenTimeout, timeout as run_timeout
from . import ledger as fault_ledger
from .core import (
    bisect,
    bridge,
    complete_grudge,
    compose,
    split_one,
)

log = logging.getLogger(__name__)

#: File names inside a search dir.
STATE_FILE = "search.json"
CORPUS_DIR = "corpus"
CELLS_DIR = "cells"
RUNS_DIR = "runs"

#: Seconds of workload tail after the last heal op, so the checker sees
#: post-fault recovery behavior too.
TAIL_S = 0.3

#: Families whose active window takes nodes out of service, counted
#: against the --node-loss-policy floor.  Partition/packet/clock degrade
#: links or clocks but leave processes serving; kill/pause (and the
#: unrecoverable file corruptions) take the node down outright.
NODE_DOWN_FAMILIES = frozenset({"kill", "pause", "bitflip", "truncate"})

#: The default search pool: every family whose compensator is
#: data-replayable, so a crashed iteration is always fully healable by
#: `jepsen repair` (bitflip/truncate journal an *unreplayable*
#: "restore from backup" compensator and are opt-in via
#: opts["search-families"]).
DEFAULT_FAMILIES = ("partition", "kill", "pause", "packet", "clock")

#: Grudge kinds the partition family draws from.
PARTITION_KINDS = ("one", "majority", "majorities-ring", "bridge")

#: netem behaviors the packet family draws from (mirrors
#: combined.packet_package's defaults).
PACKET_BEHAVIORS = (
    {"delay": {"time": 100, "jitter": 50}},
    {"loss": {"percent": 20}},
    {"duplicate": {"percent": 20}},
    {"reorder": {"percent": 20}},
)

CLOCK_DELTAS_MS = (100, 1000, 10_000, 60_000)


# ---------------------------------------------------------------------------
# Genome
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Event:
    """One timed fault: inject at `t`, heal at `t + duration`.

    `targets`: None = all nodes, int = that many (materialized to an
    explicit node list, which `_pick_nodes` still filters against the
    quarantine set at invoke time), list = exactly those nodes.
    `salt` isolates this event's randomness from its neighbors'."""

    family: str
    t: float
    duration: float
    targets: Any = None
    params: dict = dataclasses.field(default_factory=dict)
    salt: int = 0

    def to_json(self) -> dict:
        return {
            "family": self.family,
            "t": round(self.t, 4),
            "duration": round(self.duration, 4),
            "targets": list(self.targets)
            if isinstance(self.targets, (list, tuple)) else self.targets,
            "params": self.params,
            "salt": self.salt,
        }

    @staticmethod
    def from_json(d: dict) -> "Event":
        return Event(
            family=d["family"],
            t=float(d["t"]),
            duration=float(d["duration"]),
            targets=d.get("targets"),
            params=dict(d.get("params") or {}),
            salt=int(d.get("salt", 0)),
        )


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A timed sequence of fault events plus the seed that pins every
    random choice made while materializing them."""

    seed: int
    events: tuple = ()

    @property
    def horizon(self) -> float:
        """When the last heal lands."""
        return max((e.t + e.duration for e in self.events), default=0.0)

    @property
    def families(self) -> set:
        return {e.family for e in self.events}

    def to_json(self) -> dict:
        return {
            "seed": self.seed,
            "events": [e.to_json() for e in sorted(
                self.events, key=lambda e: (e.t, e.salt))],
        }

    @staticmethod
    def from_json(d: dict) -> "Schedule":
        return Schedule(
            seed=int(d["seed"]),
            events=tuple(Event.from_json(e) for e in d.get("events") or []),
        )


def _event_rng(sched: Schedule, event: Event) -> random.Random:
    # Independent of event *position*: the shrinker can drop neighbors
    # without changing how this event materializes.
    return random.Random((sched.seed << 17) ^ (event.salt * 2654435761))


# ---------------------------------------------------------------------------
# Materialization: genome -> concrete op timeline
# ---------------------------------------------------------------------------


def _grudge(kind: str, nodes: list, rng: random.Random,
            isolate: Optional[str] = None) -> dict:
    nodes = sorted(str(n) for n in nodes)
    if kind == "one":
        if isolate is not None and isolate in nodes:
            rest = [n for n in nodes if n != isolate]
            comp = ([isolate], rest)
        else:
            comp = split_one(nodes, rng)
        return complete_grudge(comp)
    if kind == "majority":
        shuffled = list(nodes)
        rng.shuffle(shuffled)
        return complete_grudge(bisect(shuffled))
    if kind == "majorities-ring":
        # majorities_ring shuffles via the generator RNG; pre-shuffle
        # here with the event RNG and accept its internal reshuffle —
        # determinism comes from passing the *explicit* grudge into the
        # op, computed once here.
        shuffled = list(nodes)
        rng.shuffle(shuffled)
        n = len(shuffled)
        from ..utils import majority as _maj

        k = _maj(n) // 2
        grudge = {}
        for i, node in enumerate(shuffled):
            visible = {shuffled[(i + d) % n] for d in range(-k, k + 1)}
            grudge[node] = set(shuffled) - visible
        return grudge
    if kind == "bridge":
        shuffled = list(nodes)
        rng.shuffle(shuffled)
        return bridge(shuffled)
    raise ValueError(f"unknown partition kind {kind!r}")


def _target_list(event: Event, nodes: list, rng: random.Random) -> list:
    if isinstance(event.targets, (list, tuple)):
        return [str(n) for n in event.targets]
    if isinstance(event.targets, int):
        picked = sorted(str(n) for n in nodes)
        rng.shuffle(picked)
        return sorted(picked[:max(1, event.targets)])
    return sorted(str(n) for n in nodes)


def target_width(event: Event, n_nodes: int) -> int:
    """How many nodes this event can take down at once."""
    if isinstance(event.targets, (list, tuple)):
        return len(event.targets)
    if isinstance(event.targets, int):
        return min(max(1, event.targets), n_nodes)
    return n_nodes


def materialize(sched: Schedule, nodes: Sequence[Any]) -> list:
    """The concrete op timeline: [(t, op_dict), ...] sorted by time.
    Deterministic in (schedule, nodes): same genome, same ops."""
    nodes = [str(n) for n in nodes]
    timeline: list[tuple[float, dict]] = []
    for e in sorted(sched.events, key=lambda e: (e.t, e.salt)):
        rng = _event_rng(sched, e)
        heal_t = e.t + e.duration
        if e.family == "partition":
            kind = e.params.get("kind") or rng.choice(PARTITION_KINDS)
            g = _grudge(kind, nodes, rng, isolate=e.params.get("isolate"))
            timeline.append((e.t, {
                "type": "info", "f": "start-partition",
                "value": {k: sorted(v) for k, v in g.items()},
            }))
            timeline.append((heal_t, {
                "type": "info", "f": "stop-partition", "value": None,
            }))
        elif e.family in ("kill", "pause"):
            picked = _target_list(e, nodes, rng)
            start_f, stop_f = (
                ("kill", "start") if e.family == "kill"
                else ("pause", "resume")
            )
            timeline.append((e.t, {
                "type": "info", "f": start_f, "value": picked,
            }))
            timeline.append((heal_t, {
                "type": "info", "f": stop_f, "value": None,
            }))
        elif e.family == "packet":
            behavior = e.params.get("behavior") or rng.choice(
                list(PACKET_BEHAVIORS)
            )
            timeline.append((e.t, {
                "type": "info", "f": "start-packet", "value": None,
                "behavior": behavior,
            }))
            timeline.append((heal_t, {
                "type": "info", "f": "stop-packet", "value": None,
            }))
        elif e.family == "clock":
            delta = e.params.get("delta_ms") or int(
                rng.choice([-1, 1]) * rng.choice(list(CLOCK_DELTAS_MS))
            )
            picked = _target_list(e, nodes, rng)
            timeline.append((e.t, {
                "type": "info", "f": "bump",
                "value": {n: delta for n in picked},
            }))
            timeline.append((heal_t, {
                "type": "info", "f": "reset", "value": None,
            }))
        elif e.family == "bitflip":
            spec = {"file": e.params.get("file")}
            timeline.append((e.t, {
                "type": "info", "f": "bitflip", "value": spec,
            }))
        elif e.family == "truncate":
            spec = {"file": e.params.get("file"),
                    "drop": int(e.params.get("drop", 64))}
            timeline.append((e.t, {
                "type": "info", "f": "truncate", "value": spec,
            }))
        elif e.family == "lazyfs":
            timeline.append((e.t, {
                "type": "info", "f": "lose-unfsynced-writes",
                "value": None,
            }))
        elif e.family == "faketime":
            picked = _target_list(e, nodes, rng)
            rate = e.params.get("rate") or round(
                0.5 + rng.random(), 3
            )
            timeline.append((e.t, {
                "type": "info", "f": "start-faketime",
                "value": {"nodes": picked, "rate": rate},
            }))
            timeline.append((heal_t, {
                "type": "info", "f": "stop-faketime", "value": None,
            }))
        else:
            raise ValueError(f"unknown fault family {e.family!r}")
    timeline.sort(key=lambda pair: pair[0])
    return timeline


#: family -> the nemesis_package faults key that provides its nemesis.
_PKG_FAULT = {
    "partition": "partition",
    "kill": "kill",
    "pause": "pause",
    "packet": "packet",
    "clock": "clock",
    "bitflip": "file-corruption",
    "truncate": "file-corruption",
    "lazyfs": "lazyfs",
    "faketime": "faketime",
}

#: family -> idempotent final heal op appended after the horizon.
_FINAL_HEAL = {
    "partition": {"type": "info", "f": "stop-partition", "value": None},
    "kill": {"type": "info", "f": "start", "value": None},
    "pause": {"type": "info", "f": "resume", "value": None},
    "packet": {"type": "info", "f": "stop-packet", "value": None},
    "clock": {"type": "info", "f": "reset", "value": None},
    "faketime": {"type": "info", "f": "stop-faketime", "value": None},
}


def compile_schedule(sched: Schedule, opts: Optional[dict] = None,
                     *, nodes: Sequence[Any]) -> dict:
    """Compiles a genome into a package dict {"nemesis", "generator",
    "timeline", "horizon"}: the nemesis is composed from the same
    family packages `nemesis_package` uses (via the FAMILY_PACKAGES
    registry), and the generator is the schedule's materialized op
    timeline as a sleep-sequenced script, ending with one idempotent
    heal op per family.  Route it with
    ``gen.nemesis(pkg["generator"], client_gen)``."""
    from .combined import registry_packages

    opts = dict(opts or {})
    fams = sched.families
    opts["faults"] = {_PKG_FAULT[f] for f in fams}
    pkgs = [p for p in registry_packages(opts) if p is not None]
    nem = compose([p["nemesis"] for p in pkgs]) if pkgs else None

    timeline = materialize(sched, nodes)
    steps: list = []
    now = 0.0
    for t, op in timeline:
        if t > now:
            steps.append(gen_sleep(t - now))
            now = t
        steps.append(op)
    horizon = sched.horizon
    if horizon > now:
        steps.append(gen_sleep(horizon - now))
    for fam in sorted(fams):
        heal = _FINAL_HEAL.get(fam)
        if heal is not None:
            steps.append(dict(heal))
    return {
        "nemesis": nem,
        "generator": steps or None,
        "timeline": timeline,
        "horizon": horizon,
    }


# ---------------------------------------------------------------------------
# Floor enforcement
# ---------------------------------------------------------------------------


def max_concurrent_down(sched: Schedule, n_nodes: int) -> int:
    """The worst-case number of nodes simultaneously taken down by
    overlapping NODE_DOWN_FAMILIES windows."""
    edges: list[tuple[float, int]] = []
    for e in sched.events:
        if e.family not in NODE_DOWN_FAMILIES:
            continue
        w = target_width(e, n_nodes)
        edges.append((e.t, w))
        edges.append((e.t + e.duration, -w))
    # Heals sort before injections at the same instant: a back-to-back
    # heal/inject pair is sequential, not overlapping.
    edges.sort(key=lambda p: (p[0], p[1]))
    worst = cur = 0
    for _, delta in edges:
        cur += delta
        worst = max(worst, cur)
    return min(worst, n_nodes)


def respects_floor(sched: Schedule, n_nodes: int, min_nodes: int) -> bool:
    """True when the schedule can never fault the cluster below
    `min_nodes` live nodes."""
    return n_nodes - max_concurrent_down(sched, n_nodes) >= min_nodes


def enforce_floor(sched: Schedule, n_nodes: int, min_nodes: int,
                  rng: random.Random) -> Schedule:
    """Repairs a floor-violating schedule by narrowing targets, then by
    dropping node-down events, until it respects the floor."""
    budget = n_nodes - min_nodes
    if budget <= 0:
        # No fault budget at all: strip every node-down event.
        return dataclasses.replace(sched, events=tuple(
            e for e in sched.events if e.family not in NODE_DOWN_FAMILIES
        ))
    for _ in range(8):
        if respects_floor(sched, n_nodes, min_nodes):
            return sched
        events = list(sched.events)
        wide = [
            i for i, e in enumerate(events)
            if e.family in NODE_DOWN_FAMILIES
            and target_width(e, n_nodes) > 1
        ]
        if wide:
            i = rng.choice(wide)
            e = events[i]
            w = target_width(e, n_nodes)
            events[i] = dataclasses.replace(e, targets=max(1, w - 1))
        else:
            down = [
                i for i, e in enumerate(events)
                if e.family in NODE_DOWN_FAMILIES
            ]
            if not down:
                return sched
            events.pop(rng.choice(down))
        sched = dataclasses.replace(sched, events=tuple(events))
    # Last resort: serial faults only.
    return dataclasses.replace(sched, events=tuple(
        e for e in sched.events if e.family not in NODE_DOWN_FAMILIES
    ))


# ---------------------------------------------------------------------------
# Mutation / crossover
# ---------------------------------------------------------------------------

#: Bounds for randomly drawn events.
MAX_T = 1.5
MIN_DURATION = 0.05
MAX_DURATION = 0.8
MAX_EVENTS = 6


def _fresh_event(families: Sequence[str], n_nodes: int,
                 rng: random.Random) -> Event:
    fam = rng.choice(list(families))
    targets: Any = None
    if fam in NODE_DOWN_FAMILIES:
        targets = rng.randint(1, max(1, n_nodes - 1))
    elif rng.random() < 0.5:
        targets = rng.randint(1, n_nodes)
    return Event(
        family=fam,
        t=round(rng.uniform(0.0, MAX_T), 3),
        duration=round(rng.uniform(MIN_DURATION, MAX_DURATION), 3),
        targets=targets,
        params={},
        salt=rng.randrange(1 << 30),
    )


def seed_schedule(family: str, seed: int) -> Schedule:
    """The deterministic single-event schedule the seed round runs for
    each family: one fault at 0.1 s, healed 0.4 s later."""
    targets = 1 if family in NODE_DOWN_FAMILIES else None
    return Schedule(seed=seed, events=(
        Event(family=family, t=0.1, duration=0.4, targets=targets,
              params={}, salt=1),
    ))


def mutate(sched: Schedule, families: Sequence[str], n_nodes: int,
           min_nodes: int, rng: random.Random) -> Schedule:
    """One mutation step: perturb timing, swap family, widen/narrow
    targets, add or drop an event — then floor-repair the result."""
    events = list(sched.events)
    ops = ["perturb_t", "perturb_dur", "retarget", "swap_family", "add",
           "overlap"]
    if len(events) > 1:
        ops.append("drop")
    op = rng.choice(ops)
    if op == "overlap" and events:
        # The composition operator: overlap an event of a DIFFERENT
        # family with an existing one — either the fresh fault fires
        # inside the anchor's window, or the anchor fires inside the
        # fresh one's.  Fault interactions live in exactly these
        # overlaps, and undirected time draws almost never hit them.
        anchor = rng.choice(events)
        others = [f for f in families if f != anchor.family] \
            or list(families)
        fresh = _fresh_event(others, n_nodes, rng)
        if rng.random() < 0.5:
            t = rng.uniform(anchor.t, anchor.t + anchor.duration)
        else:
            t = max(0.0, anchor.t
                    - fresh.duration * rng.uniform(0.05, 0.95))
        events.append(dataclasses.replace(fresh, t=round(t, 3)))
    elif op == "add" or not events:
        # Composition pressure: half the time draw the new event from a
        # family the schedule lacks, and half the time drop it inside an
        # existing event's window — overlapping multi-family schedules
        # are where the interesting bugs live, and unbiased uniform
        # draws almost never produce them.
        missing = [f for f in families
                   if f not in {e.family for e in events}]
        pool = missing if missing and rng.random() < 0.5 else families
        fresh = _fresh_event(pool, n_nodes, rng)
        if events and rng.random() < 0.5:
            anchor = rng.choice(events)
            fresh = dataclasses.replace(fresh, t=round(
                rng.uniform(anchor.t, anchor.t + anchor.duration), 3
            ))
        events.append(fresh)
    elif op == "drop":
        events.pop(rng.randrange(len(events)))
    else:
        i = rng.randrange(len(events))
        e = events[i]
        if op == "perturb_t":
            events[i] = dataclasses.replace(
                e, t=round(max(0.0, e.t + rng.uniform(-0.3, 0.3)), 3)
            )
        elif op == "perturb_dur":
            events[i] = dataclasses.replace(
                e, duration=round(min(MAX_DURATION, max(
                    MIN_DURATION, e.duration * rng.choice([0.5, 2.0])
                )), 3)
            )
        elif op == "retarget":
            w = target_width(e, n_nodes)
            w2 = max(1, min(n_nodes, w + rng.choice([-1, 1])))
            events[i] = dataclasses.replace(e, targets=w2)
        elif op == "swap_family":
            fam = rng.choice(list(families))
            targets = e.targets
            if fam in NODE_DOWN_FAMILIES and targets is None:
                targets = 1
            events[i] = dataclasses.replace(
                e, family=fam, targets=targets, params={},
                salt=rng.randrange(1 << 30),
            )
    events = events[:MAX_EVENTS]
    out = Schedule(seed=rng.randrange(1 << 32), events=tuple(events))
    return enforce_floor(out, n_nodes, min_nodes, rng)


def crossover(a: Schedule, b: Schedule, n_nodes: int, min_nodes: int,
              rng: random.Random) -> Schedule:
    """Splice: a's events before a random cut time + b's events after."""
    cut = rng.uniform(0.0, max(a.horizon, b.horizon, MIN_DURATION))
    events = tuple(e for e in a.events if e.t < cut) + tuple(
        e for e in b.events if e.t >= cut
    )
    if not events:
        events = a.events or b.events
    out = Schedule(seed=rng.randrange(1 << 32),
                   events=tuple(events)[:MAX_EVENTS])
    return enforce_floor(out, n_nodes, min_nodes, rng)


def evolve(
    frontier: Sequence[Schedule],
    families: Sequence[str],
    n_nodes: int,
    min_nodes: int,
    rng: random.Random,
    *,
    window: int = 0,
    seed_duration: float = 0.4,
) -> Schedule:
    """The standing monitor's per-window schedule chooser: the search
    loop of `run_search` unrolled to one step, so a live run can evolve
    between windows instead of between subprocess iterations.

    The first ``len(families)`` windows are the deterministic
    per-family seeds (with ``seed_duration`` substituted — a live run
    wants windows long enough that an op stream actually overlaps the
    fault), after which parents come from the novelty frontier:
    crossover when two parents exist (30%), otherwise mutation of a
    random frontier member, falling back to a mutated fresh seed when
    the frontier is empty (nothing novel yet)."""
    families = list(families)
    if not families:
        raise ValueError("evolve needs at least one fault family")
    if window < len(families):
        s = seed_schedule(families[window], seed=rng.randrange(1 << 32))
        if seed_duration != 0.4:
            s = dataclasses.replace(s, events=tuple(
                dataclasses.replace(e, duration=round(seed_duration, 3))
                for e in s.events
            ))
        return enforce_floor(s, n_nodes, min_nodes, rng)
    pool = list(frontier)
    if len(pool) >= 2 and rng.random() < 0.3:
        a, b = rng.sample(pool, 2)
        return crossover(a, b, n_nodes, min_nodes, rng)
    parent = (rng.choice(pool) if pool
              else seed_schedule(rng.choice(families),
                                 seed=rng.randrange(1 << 32)))
    return mutate(parent, families, n_nodes, min_nodes, rng)


# ---------------------------------------------------------------------------
# Coverage
# ---------------------------------------------------------------------------


def _bucket(v: float) -> int:
    return int(math.log2(v)) if v >= 1 else 0


def signature(outcome: dict) -> frozenset:
    """The feature set a run contributes to the coverage map.  `outcome`
    is what a runner returns: {"resilience": counters, "results":
    checker results, "ledger": ledger records, "hang": bool}."""
    feats: set[str] = set()
    for k, v in (outcome.get("resilience") or {}).items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        if v > 0:
            feats.add(f"c:{k}:{_bucket(v)}")
    results = outcome.get("results") or {}
    if isinstance(results, dict):
        feats.add(f"v:test:{results.get('valid')}")
        for name, sub in results.items():
            if isinstance(sub, dict) and "valid" in sub:
                feats.add(f"v:{name}:{sub.get('valid')}")
                if sub.get("error"):
                    feats.add(f"a:{name}:error")
                for anom in (sub.get("anomaly-types") or []):
                    feats.add(f"a:{name}:{anom}")
        # Anomaly-forensics signatures (forensics.py): each
        # dossier's fingerprint of WHY a verdict went bad is its own
        # fitness dimension, so the search distinguishes schedules that
        # produce *different* anomalies, not just "an anomaly".
        forens = results.get("forensics")
        if isinstance(forens, dict):
            for d in forens.get("dossiers") or []:
                if isinstance(d, dict) and d.get("signature"):
                    feats.add(f"x:{d['signature']}")
    records = outcome.get("ledger") or []
    healed_by = {
        r["id"]: r.get("by", "run")
        for r in records if r.get("rec") == "healed"
    }
    for r in records:
        if r.get("rec") != "intent":
            continue
        by = healed_by.get(r["id"])
        feats.add(
            f"l:{r.get('fault')}:{by if by else 'outstanding'}"
        )
    if outcome.get("hang"):
        feats.add("hang")
    if outcome.get("error"):
        feats.add("e:" + str(outcome["error"]).split(":", 1)[0])
    return frozenset(feats)


class CoverageMap:
    """The set of features ever observed; `add` returns the novel ones."""

    def __init__(self) -> None:
        self.features: set[str] = set()

    def add(self, sig: frozenset) -> frozenset:
        novel = frozenset(sig - self.features)
        self.features |= sig
        return novel

    def __len__(self) -> int:
        return len(self.features)


def reasons(outcome: dict) -> list[str]:
    """Why a run is worth shrinking: hang, residue, unhealed ledger
    entry, or checker anomaly.  Empty = boring."""
    out = []
    if outcome.get("hang"):
        out.append("hang")
    if outcome.get("error"):
        out.append("crash")
    resil = outcome.get("resilience") or {}
    if any(
        k.startswith("nemesis.residue.") and k != "nemesis.residue.outstanding"
        and v for k, v in resil.items()
    ):
        out.append("residue")
    records = outcome.get("ledger") or []
    if fault_ledger.outstanding_entries(list(records)):
        out.append("unhealed")
    valid = (outcome.get("results") or {}).get("valid")
    if valid is False:
        out.append("anomaly")
    elif valid not in (True, None):
        out.append("unknown")
    return out


# ---------------------------------------------------------------------------
# Corpus persistence
# ---------------------------------------------------------------------------


def _write_json_atomic(path: str, obj: Any) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True, default=repr)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class Corpus:
    """Schedules that contributed novel coverage, one JSON file each
    under <search-dir>/corpus/, written atomically so a crash never
    leaves a half-entry."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.entries: list[dict] = []
        for fn in sorted(os.listdir(directory)):
            if not fn.endswith(".json"):
                continue
            try:
                with open(os.path.join(directory, fn)) as f:
                    self.entries.append(json.load(f))
            except (OSError, ValueError):
                log.warning("corpus entry %s unreadable; skipped", fn)

    def add(self, sched: Schedule, sig: frozenset, novel: frozenset,
            iteration: int, valid: Any, interesting: list) -> dict:
        entry = {
            "id": len(self.entries),
            "iteration": iteration,
            "schedule": sched.to_json(),
            "signature": sorted(sig),
            "novel": sorted(novel),
            "valid": valid,
            "interesting": interesting,
        }
        self.entries.append(entry)
        _write_json_atomic(
            os.path.join(self.dir, f"{entry['id']:04d}.json"), entry
        )
        return entry

    def schedules(self) -> list[Schedule]:
        return [Schedule.from_json(e["schedule"]) for e in self.entries]


# ---------------------------------------------------------------------------
# Shrinker
# ---------------------------------------------------------------------------


def greedy_shrink(
    items: Sequence[Any],
    rebuild: Callable[[tuple], Any],
    is_interesting: Callable[[Any], bool],
    *,
    simplify: Optional[Callable[[Any], Any]] = None,
    max_attempts: int = 24,
    min_items: int = 1,
) -> tuple[tuple, int]:
    """The two-pass greedy delta-debugger, generic over the unit being
    minimized.  `items` is the sequence of droppable units; `rebuild`
    turns a kept subsequence back into the candidate object that
    `is_interesting` judges; `simplify` (optional) maps one unit to a
    simpler form tried in pass 2.  Pass 1 drops units largest-index
    first (never below `min_items`); pass 2 swaps each survivor for its
    simplified form; both repeat while anything sticks and the attempt
    budget holds.  Deterministic: same inputs + deterministic oracle =
    same minimum.  Returns (kept units, attempts spent).

    Shared by the nemesis schedule shrinker below and the anomaly
    forensics counterexample minimizer (forensics.py), so
    both shrink with the same discipline."""
    attempts = 0
    cur = tuple(items)
    progressed = True
    while progressed and attempts < max_attempts:
        progressed = False
        # Pass 1: drop whole units.
        i = len(cur) - 1
        while i >= 0 and attempts < max_attempts:
            if len(cur) <= min_items:
                break
            cand = cur[:i] + cur[i + 1:]
            attempts += 1
            if is_interesting(rebuild(cand)):
                cur = cand
                progressed = True
            i -= 1
        if simplify is None:
            continue
        # Pass 2: simplify the survivors.
        for i, it in enumerate(cur):
            if attempts >= max_attempts:
                break
            simpler = simplify(it)
            if simpler is None or simpler == it:
                continue
            cand = cur[:i] + (simpler,) + cur[i + 1:]
            attempts += 1
            if is_interesting(rebuild(cand)):
                cur = cand
                progressed = True
    return cur, attempts


def shrink(sched: Schedule, is_interesting: Callable[[Schedule], bool],
           *, max_attempts: int = 24) -> tuple[Schedule, int]:
    """Greedy minimization: drop events (largest index first), then
    shorten durations and narrow targets, keeping any candidate that
    still reproduces.  Event salts pin each survivor's materialization,
    so dropping a neighbor never changes what the rest do.  Returns
    (smallest reproducer, attempts spent)."""

    def rebuild(events: tuple) -> Schedule:
        return dataclasses.replace(sched, events=events)

    def simplify(e: Event) -> Event:
        simpler = e
        if e.duration > 0.2:
            simpler = dataclasses.replace(simpler, duration=0.2)
        if isinstance(e.targets, int) and e.targets > 1:
            simpler = dataclasses.replace(simpler, targets=1)
        return simpler

    kept, attempts = greedy_shrink(
        sched.events, rebuild, is_interesting,
        simplify=simplify, max_attempts=max_attempts,
    )
    return rebuild(kept), attempts


# ---------------------------------------------------------------------------
# Running one schedule through core.run
# ---------------------------------------------------------------------------


class CoreRunner:
    """Runs a schedule as a full core.run in its own store dir under
    <search-dir>/runs/.  `factory` returns a fresh base test map whose
    "generator" key (if any) is the *client* generator; the runner
    installs the compiled nemesis + scripted nemesis generator around
    it."""

    def __init__(self, factory: Callable[[], dict], search_dir: str,
                 opts: Optional[dict] = None):
        self.factory = factory
        self.runs_dir = os.path.join(search_dir, RUNS_DIR)
        self.opts = dict(opts or {})
        self.deadline_s = float(self.opts.get("iteration-deadline", 60.0))

    def __call__(self, sched: Schedule, name: str) -> dict:
        from .. import core, generator as gen, store

        test = self.factory()
        pkg = compile_schedule(sched, self.opts, nodes=test["nodes"])
        test["name"] = name
        test["store-dir"] = self.runs_dir
        test["nemesis"] = pkg["nemesis"]
        client_gen = test.get("generator")
        test["generator"] = time_limit(
            pkg["horizon"] + TAIL_S,
            gen.nemesis(pkg["generator"], client_gen),
        )
        test.setdefault(
            "node-loss-policy",
            self.opts.get("node-loss-policy") or "tolerate:1",
        )

        was_enabled = telemetry.enabled()
        telemetry.enable(True)
        # The child run resets telemetry (core.run scoped_reset) but
        # re-seeds from this: every iteration's spans share the search
        # process's trace_id, so trace_merge can stitch a whole search
        # into one timeline.
        test["trace-parent"] = telemetry.trace_context()
        hang = False
        error = None
        run_dir = None
        try:
            res = run_timeout(
                self.deadline_s * 1000.0, lambda: core.run(test)
            )
            if res is JepsenTimeout:
                hang = True
            else:
                test = res
        except Exception as e:  # noqa: BLE001 — a crashed iteration is
            # data (its ledger shows what stayed live), not a search
            # abort; a device fault is neither, and raises.
            if degrade.is_device_fault(e):
                raise
            log.warning("search iteration %s crashed: %r", name, e)
            error = f"{type(e).__name__}: {e}"
        finally:
            telemetry.enable(was_enabled)
        resilience = dict(telemetry.resilience_counters())
        results = test.get("results") if not (hang or error) else None
        try:
            run_dir = store.test_dir(test)
        except (KeyError, ValueError):
            run_dir = None
        records: list = []
        if run_dir:
            records = fault_ledger.read_records(
                fault_ledger.ledger_path(run_dir)
            )
        return {
            "resilience": resilience,
            "results": results,
            "ledger": records,
            "hang": hang,
            "error": error,
            "run_dir": run_dir,
        }


def heal_crashed_iterations(search_dir: str,
                            template: Optional[dict] = None) -> dict:
    """Sweeps <search-dir>/runs/ for run dirs whose ledger still holds
    outstanding entries — iterations a crashed/SIGKILLed search process
    left mid-fault — and replays their compensators via `core.repair`.
    Returns {run_dir: repair_report}."""
    from .. import core

    runs_root = os.path.join(search_dir, RUNS_DIR)
    healed: dict[str, dict] = {}
    if not os.path.isdir(runs_root):
        return healed
    for name in sorted(os.listdir(runs_root)):
        name_dir = os.path.join(runs_root, name)
        if not os.path.isdir(name_dir):
            continue
        for ts in sorted(os.listdir(name_dir)):
            d = os.path.join(runs_root, name, ts)
            led = fault_ledger.ledger_path(d)
            if not os.path.exists(led):
                continue
            outstanding = fault_ledger.outstanding_entries(
                fault_ledger.read_records(led)
            )
            if not outstanding:
                continue
            log.info("healing crashed search iteration %s "
                     "(%d outstanding)", d, len(outstanding))
            healed[d] = core.repair(d, dict(template or {}))
            telemetry.count("nemesis.search.healed-iterations")
    return healed


# ---------------------------------------------------------------------------
# The search loop
# ---------------------------------------------------------------------------


def _count_preserving(stats: dict) -> None:
    """Re-emits the search's cumulative counters into the (run-reset)
    telemetry registry so `resilience_counters()` reflects the search
    regardless of how many core.run resets happened since.

    core.run's telemetry.scoped_reset() already preserves
    `nemesis.search.*` counters across iterations (see
    telemetry.FLEET_COUNTER_PREFIXES), so under normal flow this is a
    no-op; it remains as a backstop for externally-driven runners that
    reset telemetry wholesale between iterations."""
    if not telemetry.enabled():
        return
    current = telemetry.resilience_counters()
    for k, v in stats.items():
        name = f"nemesis.search.{k}"
        have = current.get(name, 0)
        if v > have:
            telemetry.count(name, v - have)


def run_search(
    runner: Callable[[Schedule, str], dict],
    *,
    search_dir: str,
    n_nodes: int,
    budget_s: float = 60.0,
    seed: int = 0,
    families: Sequence[str] = DEFAULT_FAMILIES,
    min_nodes: int = 1,
    max_iterations: Optional[int] = None,
    shrink_attempts: int = 12,
    repair_template: Optional[dict] = None,
) -> dict:
    """The coverage-guided loop: heal leftovers, seed one schedule per
    family (guaranteed early coverage growth), then breed from the
    corpus under the wall-clock budget.  Interesting outcomes (see
    `reasons`) are shrunk and emitted as fault-matrix cells.  State is
    checkpointed atomically to <search-dir>/search.json after every
    iteration, so a SIGKILL loses at most the in-flight run — which the
    next invocation's heal sweep repairs."""
    os.makedirs(search_dir, exist_ok=True)
    heal_crashed_iterations(search_dir, repair_template)

    rng = random.Random(seed)
    coverage = CoverageMap()
    corpus = Corpus(os.path.join(search_dir, CORPUS_DIR))
    cells_dir = os.path.join(search_dir, CELLS_DIR)
    os.makedirs(cells_dir, exist_ok=True)
    # Re-grow coverage from a resumed corpus so replays aren't "novel".
    for entry in corpus.entries:
        coverage.add(frozenset(entry.get("signature") or []))

    deadline = time.monotonic() + budget_s
    stats = {
        "iterations": 0, "novel": 0, "interesting": 0, "shrunk": 0,
        "shrink-attempts": 0,
    }
    history: list[dict] = []
    cells: list[dict] = []
    state_path = os.path.join(search_dir, STATE_FILE)

    def checkpoint() -> None:
        _write_json_atomic(state_path, {
            "seed": seed,
            "families": list(families),
            "n_nodes": n_nodes,
            "min_nodes": min_nodes,
            "budget_s": budget_s,
            "coverage": len(coverage),
            "features": sorted(coverage.features),
            "counters": {f"nemesis.search.{k}": v
                         for k, v in stats.items()},
            "iterations": history,
            "corpus": [
                {k: e[k] for k in ("id", "iteration", "valid",
                                   "interesting", "novel")}
                for e in corpus.entries
            ],
            "cells": cells,
        })

    def spend(sched: Schedule, label: str) -> dict:
        outcome = runner(sched, label)
        stats["iterations"] += 1
        return outcome

    def primary_reason_reproduces(want: str):
        def check(cand: Schedule) -> bool:
            if not respects_floor(cand, n_nodes, min_nodes):
                return False
            out = spend(cand, f"shrink-{stats['iterations']:04d}")
            stats["shrink-attempts"] += 1
            return want in reasons(out)
        return check

    def record(sched: Schedule, outcome: dict, label: str) -> None:
        sig = signature(outcome)
        novel = coverage.add(sig)
        why = reasons(outcome)
        valid = (outcome.get("results") or {}).get("valid")
        if novel:
            stats["novel"] += 1
            corpus.add(sched, sig, novel, stats["iterations"], valid, why)
        history.append({
            "i": stats["iterations"],
            "label": label,
            "events": len(sched.events),
            "families": sorted(sched.families),
            "new_features": len(novel),
            "coverage": len(coverage),
            "interesting": why,
        })
        if why:
            stats["interesting"] += 1
            already = any(
                c["reason"] == why[0] and
                Schedule.from_json(c["schedule"]).families
                == sched.families
                for c in cells
            )
            # The budget bounds exploration, not minimization: a found
            # reproducer is the search's whole point, so shrink it even
            # at the budget edge (bounded overrun — `shrink_attempts`
            # runs at most).
            if not already:
                small, spent = shrink(
                    sched, primary_reason_reproduces(why[0]),
                    max_attempts=shrink_attempts,
                )
                stats["shrunk"] += 1
                cell = {
                    "name": f"searched-{why[0]}-{len(cells)}",
                    "reason": why[0],
                    "schedule": small.to_json(),
                    "events": len(small.events),
                    "shrink_runs": spent,
                    "from_events": len(sched.events),
                }
                cells.append(cell)
                _write_json_atomic(
                    os.path.join(cells_dir, cell["name"] + ".json"), cell
                )
                log.info("shrunk %s reproducer to %d event(s) "
                         "(%d shrink runs)", why[0], len(small.events),
                         spent)
        _count_preserving(stats)
        checkpoint()

    # Seed round: one deterministic single-event schedule per family —
    # each contributes family-distinct ledger/verdict features, so
    # coverage strictly grows across the round.
    for i, fam in enumerate(families):
        if time.monotonic() >= deadline:
            break
        if max_iterations and stats["iterations"] >= max_iterations:
            break
        sched = seed_schedule(fam, seed=seed + i + 1)
        outcome = spend(sched, f"seed-{fam}")
        record(sched, outcome, f"seed-{fam}")

    # Evolution: mutate/crossover corpus parents until the budget runs
    # out.  With an empty corpus (everything crashed?) fall back to
    # fresh random schedules.
    while time.monotonic() < deadline:
        if max_iterations and stats["iterations"] >= max_iterations:
            break
        parents = corpus.schedules()
        if parents and len(parents) >= 2 and rng.random() < 0.3:
            sched = crossover(
                rng.choice(parents), rng.choice(parents),
                n_nodes, min_nodes, rng,
            )
        elif parents:
            sched = mutate(
                rng.choice(parents), families, n_nodes, min_nodes, rng,
            )
        else:
            sched = enforce_floor(
                Schedule(seed=rng.randrange(1 << 32), events=(
                    _fresh_event(families, n_nodes, rng),
                    _fresh_event(families, n_nodes, rng),
                )), n_nodes, min_nodes, rng,
            )
        if not sched.events:
            continue
        label = f"iter-{stats['iterations']:04d}"
        outcome = spend(sched, label)
        record(sched, outcome, label)

    _count_preserving(stats)
    checkpoint()
    return {
        "search_dir": search_dir,
        "coverage": len(coverage),
        "stats": stats,
        "corpus": len(corpus.entries),
        "cells": cells,
        "history": history,
    }


def replay(entry_or_schedule: Any, runner: Callable[[Schedule, str], dict],
           label: str = "replay") -> dict:
    """Re-runs a corpus entry (or Schedule) and returns its outcome.
    Determinism contract: the materialized op timeline is identical to
    the original run's (same genome -> same ops); observed counters may
    bucket differently under real thread timing, but verdict validity
    and interestingness class are expected to match."""
    sched = (
        entry_or_schedule
        if isinstance(entry_or_schedule, Schedule)
        else Schedule.from_json(entry_or_schedule["schedule"])
    )
    out = runner(sched, label)
    telemetry.count("nemesis.search.replays")
    return out


def load_state(search_dir: str) -> Optional[dict]:
    """The last checkpoint a search wrote, or None."""
    path = os.path.join(search_dir, STATE_FILE)
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def floor_from_test(test: dict) -> int:
    """The min-nodes floor the search must honor, from the test map's
    --node-loss-policy.  Under "tolerate[:<min>]" the floor is that
    minimum; under "abort" (the node-loss-averse default) the search
    stays maximally conservative and never takes more than one node
    down at a time."""
    policy, min_nodes = health.node_loss_policy(test)
    if policy == "abort":
        return max(1, len(test.get("nodes") or []) - 1)
    return min_nodes
