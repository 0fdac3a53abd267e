"""Nemesis protocol and stock fault injectors.

The port's copy of `jepsen_tpu/nemesis/core.py`.

Equivalent of jepsen/src/jepsen/nemesis.clj: the
`Nemesis` protocol (:12-17) and `Reflection` (:19-22), `noop`,
partition grudges — `complete-grudge` :121, `bridge` :145,
`majorities-ring` :203-276 — the `partitioner` nemesis :158-184, node
isolation helpers :27-107, `compose` :385-429, and `f-map` :303-328.

Faults that shell into nodes (clock scrambling, kill/pause, file
corruption) live in `jepsen_tpu_torch.nemesis.faults` since they need the
control plane; this module is pure protocol + graph math over the
network-manipulation `Net` interface carried in ``test["net"]``.
"""

from __future__ import annotations

import logging
import random
from typing import Any, Callable, Iterable, Mapping, Optional, Sequence

from ..control import health
from ..history import INFO, Op
from ..utils import JepsenTimeout, majority, timeout as run_timeout
from . import ledger as fault_ledger

log = logging.getLogger(__name__)


class Nemesis:
    """A special process that injects faults (nemesis.clj:12-17)."""

    def setup(self, test: dict) -> "Nemesis":
        return self

    def invoke(self, test: dict, op: Op) -> Op:
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        pass

    def fs(self) -> set:
        """The :f values this nemesis handles (Reflection, :19-22)."""
        return set()


class NoopNemesis(Nemesis):
    """Does nothing (nemesis.clj:24-30)."""

    def invoke(self, test: dict, op: Op) -> Op:
        return op

    def fs(self) -> set:
        return set()


noop = NoopNemesis()


# ---------------------------------------------------------------------------
# Grudges: maps of node -> collection of nodes to cut links FROM
# ---------------------------------------------------------------------------


def complete_grudge(components: Sequence[Sequence[Any]]) -> dict:
    """Takes a collection of components (collections of nodes) and
    returns a grudge cutting every node off from all nodes in the other
    components (nemesis.clj:121-130)."""
    all_nodes = [n for comp in components for n in comp]
    grudge = {}
    for comp in components:
        comp_set = set(comp)
        others = [n for n in all_nodes if n not in comp_set]
        for n in comp:
            grudge[n] = set(others)
    return grudge


def bisect(coll: Sequence[Any]) -> tuple[list, list]:
    """Splits a collection into [first-half, second-half]; the first half
    is smaller for odd sizes (nemesis.clj:109-113)."""
    coll = list(coll)
    mid = len(coll) // 2
    return coll[:mid], coll[mid:]


def _rng() -> random.Random:
    """Nemesis randomness rides the generator module's seedable RNG so
    set_rng_seed reproduces partition choices along with schedules."""
    from ..generator.core import get_rng

    return get_rng()


def split_one(coll: Sequence[Any], rng: Optional[random.Random] = None) -> tuple[list, list]:
    """Splits a collection into one random node and the rest
    (nemesis.clj:115-119)."""
    coll = list(coll)
    r = rng or _rng()
    i = r.randrange(len(coll))
    return [coll[i]], coll[:i] + coll[i + 1 :]


def bridge(nodes: Sequence[Any]) -> dict:
    """A grudge cutting the network in half, preserving a middle node
    with uninterrupted connectivity to both components
    (nemesis.clj:145-156)."""
    nodes = list(nodes)
    mid = len(nodes) // 2
    bridge_node = nodes[mid]
    a = [n for n in nodes[:mid]]
    b = [n for n in nodes[mid + 1 :]]
    grudge = {n: set(b) for n in a}
    grudge.update({n: set(a) for n in b})
    grudge[bridge_node] = set()
    return grudge


def majorities_ring(nodes: Sequence[Any]) -> dict:
    """Grudge in which every node can see a majority including itself,
    but no two nodes see the *same* majority: overlapping majorities
    arranged in a ring (nemesis.clj:203-276).  Node i's view is the
    window of the ring *centered* on i — centering makes visibility
    symmetric, so every node keeps a BIDIRECTIONAL majority (itself
    plus its k nearest neighbors each way).  A window keyed at i
    instead of centered on it would isolate every node: i could hear
    nodes that cannot hear it back.  Even majority sizes round up to
    the next odd window to stay symmetric.

    The ring order is shuffled per call, like the reference's
    majorities-ring-perfect (nemesis.clj:203-217): repeated partitions
    in one test then cut different edges each time."""
    nodes = list(nodes)
    _rng().shuffle(nodes)
    n = len(nodes)
    k = majority(n) // 2
    grudge = {}
    for i, node in enumerate(nodes):
        visible = {nodes[(i + d) % n] for d in range(-k, k + 1)}
        grudge[node] = set(nodes) - visible
    return grudge


def invert_grudge(grudge: Mapping[Any, Iterable[Any]]) -> dict:
    """Symmetrizes a grudge: if a is cut from b, b is cut from a."""
    out: dict[Any, set] = {k: set(v) for k, v in grudge.items()}
    for a, bs in grudge.items():
        for b in bs:
            out.setdefault(b, set()).add(a)
    return out


# ---------------------------------------------------------------------------
# Partitioner nemesis
# ---------------------------------------------------------------------------


class Partitioner(Nemesis):
    """Responds to {:f "start"} by cutting links per a grudge and
    {:f "stop"} by healing (nemesis.clj:158-184).  `grudge_fn` maps the
    test's node list to a grudge; a start op whose value is already a
    grudge mapping takes precedence."""

    def __init__(self, grudge_fn: Optional[Callable[[Sequence[Any]], dict]] = None):
        self.grudge_fn = grudge_fn

    def setup(self, test: dict) -> "Partitioner":
        net = test.get("net")
        if net is not None:
            net.heal(test)
        return self

    def invoke(self, test: dict, op: Op) -> Op:
        net = test["net"]
        if op.f == "start":
            if isinstance(op.value, Mapping):
                grudge = {k: set(v) for k, v in op.value.items()}
            elif self.grudge_fn is not None:
                # Grudges form over the nodes still in rotation: cutting
                # links to a quarantined corpse wastes the fault budget.
                grudge = self.grudge_fn(health.eligible_nodes(test))
            else:
                raise ValueError(
                    "partition start op needs a grudge value or grudge_fn"
                )
            fault_ledger.intent(
                test,
                "partition",
                nodes=sorted(str(n) for n in grudge),
                params={"grudge": {str(k): sorted(v) for k, v in
                                   grudge.items()}},
                compensator={
                    "type": "net-heal",
                    "mech": fault_ledger.net_mech(net),
                },
            )
            net.drop_all(test, grudge)
            return op.replace(
                value={k: sorted(v) for k, v in grudge.items()}
            )
        elif op.f == "stop":
            if fault_ledger.heal_guard():
                return op.replace(value="network heal abandoned")
            net.heal(test)
            fault_ledger.healed(test, fault="partition")
            return op.replace(value="network healed")
        raise ValueError(f"partitioner got unknown f {op.f!r}")

    def teardown(self, test: dict) -> None:
        net = test.get("net")
        if net is None:
            return
        if fault_ledger.heal_guard():
            return
        net.heal(test)
        fault_ledger.healed(test, fault="partition", by="teardown")

    def fs(self) -> set:
        return {"start", "stop"}


def partitioner(grudge_fn: Optional[Callable] = None) -> Partitioner:
    return Partitioner(grudge_fn)


def partition_halves() -> Partitioner:
    """Cuts the network into two halves at start (nemesis.clj:186-192)."""
    return Partitioner(lambda nodes: complete_grudge(bisect(nodes)))


def partition_random_halves() -> Partitioner:
    """Two randomly-chosen halves (nemesis.clj:194-201)."""

    def grudge(nodes: Sequence[Any]) -> dict:
        shuffled = list(nodes)
        _rng().shuffle(shuffled)
        return complete_grudge(bisect(shuffled))

    return Partitioner(grudge)


def partition_random_node() -> Partitioner:
    """Isolates a single random node (nemesis.clj:132-143)."""
    return Partitioner(lambda nodes: complete_grudge(split_one(nodes)))


def partition_majorities_ring() -> Partitioner:
    """Overlapping-majorities ring partition (nemesis.clj:278-282)."""
    return Partitioner(majorities_ring)


# ---------------------------------------------------------------------------
# Combinators
# ---------------------------------------------------------------------------


class FMap(Nemesis):
    """Remaps the :f values a nemesis sees: `fmap` is {outer-f: inner-f};
    ops are translated on the way in and back on the way out
    (nemesis.clj:303-328)."""

    def __init__(self, fmap: Mapping[Any, Any], nem: Nemesis):
        self.fmap = dict(fmap)
        self.inv = {v: k for k, v in self.fmap.items()}
        self.nem = nem

    def setup(self, test: dict) -> "FMap":
        return FMap(self.fmap, self.nem.setup(test))

    def invoke(self, test: dict, op: Op) -> Op:
        inner = op.replace(f=self.fmap[op.f])
        out = self.nem.invoke(test, inner)
        return out.replace(f=self.inv[out.f])

    def teardown(self, test: dict) -> None:
        self.nem.teardown(test)

    def fs(self) -> set:
        return set(self.fmap.keys())


def f_map(fmap: Mapping[Any, Any], nem: Nemesis) -> FMap:
    return FMap(fmap, nem)


class NemesisTeardownError(Exception):
    """Aggregate of per-child Compose teardown failures: every child got
    its teardown attempt; these are the ones that failed."""

    def __init__(self, failures: list[tuple["Nemesis", BaseException]]):
        self.failures = failures
        super().__init__(
            "nemesis teardown failed for "
            + "; ".join(
                f"{type(nem).__name__}: {type(e).__name__}: {e}"
                for nem, e in failures
            )
        )


class Compose(Nemesis):
    """Routes ops to one of several nemeses by :f (nemesis.clj:385-429).
    Takes a plain list of nemeses (fs taken from Reflection) or a list
    of (fs, nemesis) pairs, where fs is a collection of f values or an
    {outer-f: inner-f} remapping (the reference's fmap-key form —
    expressed as pairs here since dicts can't key a Python dict)."""

    def __init__(self, nemeses: Any):
        entries = []
        for item in nemeses:
            if (
                isinstance(item, tuple)
                and len(item) == 2
                and not isinstance(item[0], Nemesis)
            ):
                fs, nem = item
                if isinstance(fs, Mapping):
                    entries.append((set(fs.keys()), f_map(fs, nem)))
                else:
                    entries.append((set(fs), nem))
            else:
                entries.append((set(item.fs()), item))
        seen: set = set()
        for fs, _ in entries:
            dup = seen & fs
            if dup:
                raise ValueError(f"multiple nemeses claim fs {sorted(dup)}")
            seen |= fs
        self.entries = entries

    @classmethod
    def _from_entries(cls, entries: list) -> "Compose":
        self = cls([])
        self.entries = entries
        return self

    def _route(self, f: Any) -> Nemesis:
        for fs, nem in self.entries:
            if f in fs:
                return nem
        raise ValueError(f"no nemesis handles f {f!r}")

    def setup(self, test: dict) -> "Compose":
        return Compose._from_entries(
            [(fs, nem.setup(test)) for fs, nem in self.entries]
        )

    def invoke(self, test: dict, op: Op) -> Op:
        return self._route(op.f).invoke(test, op)

    def teardown(self, test: dict) -> None:
        # One failing child must not strand its siblings' faults: every
        # child gets its teardown attempt, then the failures surface as
        # one aggregate.
        failures: list[tuple[Nemesis, BaseException]] = []
        for _, nem in self.entries:
            try:
                nem.teardown(test)
            except Exception as e:  # noqa: BLE001 — aggregated below
                log.warning(
                    "nemesis %s teardown failed: %r", type(nem).__name__, e
                )
                failures.append((nem, e))
        if failures:
            raise NemesisTeardownError(failures)

    def fs(self) -> set:
        out: set = set()
        for fs, _ in self.entries:
            out |= fs
        return out


def compose(nemeses: Any) -> Compose:
    return Compose(nemeses)


class Timeout(Nemesis):
    """Bounds nemesis invocations at `ms`; on expiry the op completes
    with an error note and the fault thread keeps running
    (nemesis.clj:430-434 analog of client/Timeout)."""

    def __init__(self, ms: float, nem: Nemesis):
        self.ms = ms
        self.nem = nem

    def setup(self, test: dict) -> "Timeout":
        return Timeout(self.ms, self.nem.setup(test))

    def invoke(self, test: dict, op: Op) -> Op:
        try:
            return run_timeout(self.ms, lambda: self.nem.invoke(test, op))
        except JepsenTimeout:
            return op.replace(value="nemesis timeout")

    def teardown(self, test: dict) -> None:
        self.nem.teardown(test)

    def fs(self) -> set:
        return self.nem.fs()


def timeout(ms: float, nem: Nemesis) -> Timeout:
    return Timeout(ms, nem)
