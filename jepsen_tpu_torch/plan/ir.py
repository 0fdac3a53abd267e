"""The checking-plan IR: pass families, plan nodes, and the plan DAG.

The port's copy of `jepsen_tpu/plan/ir.py`, unchanged in behaviour:
`Plan.fingerprint()` hashes the same canonical JSON, so one plan gives
byte-equal fingerprints in both packages.

A **pass family** is a checking engine registered with its contract:
which verdict direction it can settle (`can-prove-valid` passes like
the stream witness only ever return True; `can-refute` screens only
False; `exact` engines both), and which resource class it occupies
(`device` passes hold the card; `host` passes are CPU/numpy).  The
compiler composes family instances — `PassNode`s with chosen knobs and
declared cost features — into a `Plan`: a small DAG whose typed edges
say where a key goes when a pass cannot decide it ("unknown") or when a
classifier fires ("refuted").

Soundness is the load-bearing invariant: an edge never *changes* a
verdict, it only routes undecided work, so any topology the compiler
emits produces the same per-key verdicts — knobs and ordering are pure
performance choices, which is what lets the cost model drive them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import OrderedDict
from typing import Any, Callable, Iterator, Optional

#: Verdict directions a family may settle.
SOUNDNESS = ("can-prove-valid", "can-refute", "exact")
#: Resource classes (who holds the accelerator while the pass runs).
RESOURCES = ("device", "host")

#: Edge labels: every node has an implicit "decided" exit; these route
#: the rest.  "unknown" is the generic fallback; "refuted" carries keys
#: a classifier marked invalid-but-uncertified toward a detail pass.
EDGE_LABELS = ("unknown", "refuted")


@dataclasses.dataclass(frozen=True)
class PassFamily:
    """One registered checking engine.

    `runner(ctx, node, keys) -> (decided, routed)` where `decided` maps
    key -> result dict and `routed` maps edge label -> keys to forward.
    Runners live in executor.py; registration here keeps the IR import
    cycle-free.
    """

    name: str
    soundness: str
    resource: str
    runner: Callable[..., Any]
    #: Knob names the cost model may choose for nodes of this family.
    knob_spec: tuple = ()
    doc: str = ""

    def __post_init__(self) -> None:
        if self.soundness not in SOUNDNESS:
            raise ValueError(
                f"{self.name}: soundness {self.soundness!r} not in "
                f"{SOUNDNESS}"
            )
        if self.resource not in RESOURCES:
            raise ValueError(
                f"{self.name}: resource {self.resource!r} not in "
                f"{RESOURCES}"
            )


_FAMILIES: "OrderedDict[str, PassFamily]" = OrderedDict()


def register_family(fam: PassFamily) -> PassFamily:
    """Adds (or replaces) a family in the registry.  Replacement is
    deliberate: tests register instrumented doubles under the stock
    names."""
    _FAMILIES[fam.name] = fam
    return fam


def family(name: str) -> PassFamily:
    f = _FAMILIES.get(name)
    if f is None:
        raise KeyError(
            f"unknown pass family {name!r} (known: {list(_FAMILIES)})"
        )
    return f


def known_families() -> list[str]:
    # Importing the executor registers the builtin families; lazy so
    # importing the IR alone stays cheap.
    from . import executor  # noqa: F401

    return list(_FAMILIES)


@dataclasses.dataclass
class PassNode:
    """One pass instance in a plan: a family plus the knobs the
    compiler chose for it and the cost features it declared."""

    id: str
    family: str
    #: Chosen knob values (segment sizes, beams, budget slices...).
    #: None values mean "engine default" and are preserved in the
    #: fingerprint so trained-vs-untrained plans hash apart.
    knobs: dict = dataclasses.field(default_factory=dict)
    #: Declared cost features (key count, op count) — inputs the cost
    #: model predicted from, recorded for the profile store.
    features: dict = dataclasses.field(default_factory=dict)
    #: label -> node id (or None = exit undecided).  Missing labels
    #: fall back to "unknown"'s target.
    edges: dict = dataclasses.field(default_factory=dict)
    #: Nodes inside the digest-dedup scope operate on one
    #: representative per identical subhistory; the executor fans the
    #: verdict out on scope exit (the settle-memo mechanic).
    group: bool = False

    def target(self, label: str) -> Optional[str]:
        if label in self.edges:
            return self.edges[label]
        return self.edges.get("unknown")

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "family": self.family,
            "knobs": dict(self.knobs),
            "features": dict(self.features),
            "edges": dict(self.edges),
            "group": self.group,
        }


class Plan:
    """An ordered DAG of pass nodes.  Node order is topological by
    construction: the compiler emits nodes in execution order and edges
    only point forward (enforced here), so the executor is a single
    forward sweep with work queues — no scheduler needed."""

    def __init__(self, nodes: list[PassNode], *, meta: Optional[dict] = None):
        self.nodes: "OrderedDict[str, PassNode]" = OrderedDict()
        for n in nodes:
            if n.id in self.nodes:
                raise ValueError(f"duplicate plan node id {n.id!r}")
            self.nodes[n.id] = n
        order = {nid: i for i, nid in enumerate(self.nodes)}
        for n in nodes:
            for label, tgt in n.edges.items():
                if tgt is None:
                    continue
                if tgt not in order:
                    raise ValueError(
                        f"node {n.id!r} edge {label!r} -> unknown node "
                        f"{tgt!r}"
                    )
                if order[tgt] <= order[n.id]:
                    raise ValueError(
                        f"node {n.id!r} edge {label!r} -> {tgt!r} points "
                        "backward; plans are forward DAGs"
                    )
        #: Plan-identity facts (model key, algorithm, budget) — part of
        #: the fingerprint, surfaced in telemetry.
        self.meta = dict(meta or {})

    def __iter__(self) -> Iterator[PassNode]:
        return iter(self.nodes.values())

    def __len__(self) -> int:
        return len(self.nodes)

    def node(self, nid: str) -> PassNode:
        return self.nodes[nid]

    def to_dict(self) -> dict:
        return {
            "meta": dict(self.meta),
            "nodes": [n.to_dict() for n in self.nodes.values()],
        }

    def fingerprint(self) -> str:
        """Stable digest of the whole plan — topology, knobs, and
        identity meta.  Two processes compiling the same cohort with
        the same model/budget/knobs agree on it, which is what lets
        the persistent caches key on it."""
        blob = json.dumps(self.to_dict(), sort_keys=True, default=repr)
        return hashlib.sha256(blob.encode()).hexdigest()

    def describe(self) -> str:
        """One-line-per-node rendering for logs."""
        out = []
        for n in self.nodes.values():
            fam = _FAMILIES.get(n.family)
            kn = ",".join(f"{k}={v}" for k, v in sorted(n.knobs.items()))
            edges = ",".join(
                f"{label}->{tgt}" for label, tgt in sorted(n.edges.items())
            )
            out.append(
                f"{n.id}[{n.family}"
                + (f"/{fam.soundness}/{fam.resource}" if fam else "")
                + (f" {kn}" if kn else "")
                + (f" {edges}" if edges else "")
                + ("%" if n.group else "")
                + "]"
            )
        return " ; ".join(out)
