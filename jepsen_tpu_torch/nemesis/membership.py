"""Membership nemesis: standardized grow/shrink cluster faults.

The port's copy of `jepsen_tpu/nemesis/membership.py`.

Equivalent of jepsen/src/jepsen/nemesis/membership.clj
(design doc :1-47) + membership/state.clj: cluster membership is a
state machine over three framework-managed pieces —

  * ``node_views``: each node's own (possibly stale, possibly divergent)
    view of the cluster, refreshed by a background poller per node;
  * ``view``: the merged, authoritative-as-far-as-we-know view;
  * ``pending``: operations we applied whose effect is not yet
    confirmed — they constrain further choices (e.g. don't start a 5th
    removal while 4 are in flight) and are *resolved* against fresh
    views via a fixed-point loop.

Databases vary wildly in how membership looks, so the specifics live in
a user-supplied `MembershipState` subclass (the reference's `State`
protocol, membership/state.clj:20-57).  Python idiom: the state object
is mutable and the nemesis serializes every touch through one lock —
the reference reaches the same end with an atom + `locking`.

The package's generator asks the *state* what operation is currently
legal (`op`), so fault scheduling adapts to the cluster's actual
condition rather than a fixed script.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Optional

from ..control import on_nodes
from ..generator.core import PENDING, Generator, fill_in_op, stagger
from ..history import Op
from . import ledger as fault_ledger
from .core import Nemesis

log = logging.getLogger(__name__)

#: Seconds between node-view refreshes (membership.clj:57-59).
NODE_VIEW_INTERVAL = 5.0


class MembershipState:
    """Cluster-specific membership logic (membership/state.clj:20-57).

    Subclasses own any fields they like; the nemesis initializes and
    maintains `node_views` (dict node -> view), `view` (merged), and
    `pending` (list of [invocation, completion] op pairs) on the
    instance, and calls every method below under its lock."""

    node_views: dict
    view: Any
    pending: list

    def setup(self, test: dict) -> "MembershipState":
        """One-time initialization (open connections etc.)."""
        return self

    def node_view(self, test: dict, session, node: str) -> Any:
        """This node's view of the cluster, via `session`; None =
        currently unknown (ignored)."""
        return None

    def merge_views(self, test: dict) -> Any:
        """Derive the authoritative view from self.node_views."""
        return self.view

    def fs(self) -> set:
        """All op :f values this state machine may generate."""
        return set()

    def op(self, test: dict) -> Any:
        """An op template we could perform now, PENDING if nothing is
        currently legal, or None to stop generating forever."""
        return None

    def invoke(self, test: dict, op: Op) -> Op:
        """Apply a generated op to the cluster; return the completed op.
        State mutation is safe here (the nemesis holds its lock)."""
        raise NotImplementedError

    def resolve(self, test: dict) -> bool:
        """Evolve toward a fixed point after view changes; return True
        if anything changed (the loop re-runs until False)."""
        return False

    def resolve_op(self, test: dict, pair: list) -> bool:
        """True if the pending [op, op'] pair is now confirmed complete
        (it is then removed from `pending`)."""
        return False

    def teardown(self, test: dict) -> None:
        pass


class MembershipNemesis(Nemesis):
    """Drives a MembershipState: background per-node view pollers, op
    application, pending-op bookkeeping (membership.clj:150-232)."""

    def __init__(self, state: MembershipState,
                 view_interval: float = NODE_VIEW_INTERVAL):
        self.state = state
        self.lock = threading.RLock()
        self.view_interval = view_interval
        self._stop = threading.Event()
        self._pollers: list[threading.Thread] = []
        # Ledger entry ids per pending pair, keyed by id(pair): user
        # code unpacks pending pairs as 2-tuples, so the id cannot ride
        # the list itself.
        self._intents: dict[int, int] = {}

    # -- resolution --------------------------------------------------------

    def _resolve(self, test: dict) -> None:
        """resolve + resolve-ops to fixed point (membership.clj:94-117),
        caller holds the lock."""
        st = self.state
        for _ in range(1000):  # fixed-point with a runaway guard
            changed = st.resolve(test)
            for pair in list(st.pending):
                if st.resolve_op(test, pair):
                    log.info("resolved membership op: %s", pair[0])
                    st.pending.remove(pair)
                    eid = self._intents.pop(id(pair), None)
                    if eid is not None:
                        fault_ledger.healed(test, entry_id=eid,
                                            by="resolve")
                    changed = True
            if not changed:
                return

    def _update_node_view(self, test: dict, node: str) -> None:
        def view(sess, n):
            return self.state.node_view(test, sess, n)

        nv = on_nodes(test, view, [node]).get(node)
        if nv is None:
            return
        with self.lock:
            st = self.state
            if st.node_views.get(node) != nv:
                log.debug("new node view from %s: %s", node, nv)
            st.node_views[node] = nv
            st.view = st.merge_views(test)
            self._resolve(test)

    def _poll(self, test: dict, node: str) -> None:
        while not self._stop.is_set():
            try:
                self._update_node_view(test, node)
            except Exception:  # noqa: BLE001 — poller must survive
                log.warning(
                    "membership view poller for %s failed; will retry",
                    node, exc_info=True,
                )
            self._stop.wait(self.view_interval)

    # -- Nemesis protocol --------------------------------------------------

    def setup(self, test: dict) -> "MembershipNemesis":
        with self.lock:
            st = self.state
            st.node_views = {}
            st.view = None
            st.pending = []
            self.state = st.setup(test)
        for node in test.get("nodes") or []:
            t = threading.Thread(
                target=self._poll, args=(test, node),
                name=f"membership-view-{node}", daemon=True,
            )
            t.start()
            self._pollers.append(t)
        return self

    def invoke(self, test: dict, op: Op) -> Op:
        with self.lock:
            # Membership changes have no mechanical inverse the framework
            # could replay (the state machine owns the cluster logic), so
            # the ledger records them for the repair report only.
            eid = fault_ledger.intent(
                test, "membership",
                params={"f": op.f, "value": op.value},
                compensator={
                    "type": "unreplayable",
                    "note": "membership change; converge via the state "
                            "machine or operator action",
                },
                tag="membership",
            )
            op2 = self.state.invoke(test, op)
            pair = [op, op2]
            self.state.pending.append(pair)
            if eid is not None:
                self._intents[id(pair)] = eid
            self._resolve(test)
            return op2

    def teardown(self, test: dict) -> None:
        self._stop.set()
        for t in self._pollers:
            t.join(timeout=2.0)
        with self.lock:
            state = self.state
        state.teardown(test)

    def fs(self) -> set:
        with self.lock:
            state = self.state
        return set(state.fs())


class MembershipGenerator(Generator):
    """Asks the state machine for the next legal operation
    (membership.clj:234-244)."""

    __slots__ = ("nemesis",)

    def __init__(self, nemesis: MembershipNemesis):
        self.nemesis = nemesis

    def op(self, test, ctx):
        with self.nemesis.lock:
            o = self.nemesis.state.op(test)
        if o is None:
            return None
        if o is PENDING or o == "pending":
            return (PENDING, self)
        filled = fill_in_op(dict(o), ctx)
        return (filled, self)


def membership_package(opts: dict) -> Optional[dict]:
    """Package constructor (membership.clj:246-270).  opts:

        {"faults": {"membership", ...},
         "membership": {"state": MembershipState instance,
                        "view-interval": secs},
         "interval": secs}

    The returned dict carries "state" so custom generators can target
    faults from the current cluster view."""
    if "membership" not in (opts.get("faults") or set()):
        return None
    mopts = opts.get("membership", {}) or {}
    state = mopts["state"]
    nem = MembershipNemesis(
        state, view_interval=mopts.get("view-interval", NODE_VIEW_INTERVAL)
    )
    gen = stagger(opts.get("interval", 10.0), MembershipGenerator(nem))
    return {
        "state": state,
        "nemesis": nem,
        "generator": gen,
        "final-generator": None,
        "perf": [],
    }
