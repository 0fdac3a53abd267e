"""Node health: partial-cluster survival.

The port's copy of `jepsen_tpu/control/health.py` (no JAX there either).

The control plane's last structural gap between "a flaky cluster" and
"a lost run": the lifecycle assumes every DB node answers SSH for the
whole test, so one permanently dead node (VM gone, sshd down — *not* a
nemesis fault) used to crash client setup outright and burn a full
``op_timeout`` per op against the corpse mid-run.  This module keeps
the run alive on the surviving nodes, the way training fleets
quarantine bad hosts instead of aborting the job.

Per-node state machine::

    healthy ──signal──▶ suspect ──K probe failures──▶ quarantined
       ▲                   │                              │
       └────probe pass─────┘        N probe passes        ▼
       ◀──────signal──────────────────────────────── readmitted

* **Signals** are passive and fed from the data path: client ``open``
  failures, ``RemoteDisconnected``/connection errors during invoke,
  and op-watchdog fires (`HealthMonitor.signal`).  A healthy cluster
  never pays anything: the monitor thread does not exist until the
  first signal arrives (the same zero-overhead contract as the fault
  ledger's lazy open).
* **Probes** are the active confirmation: an SSH liveness ``true``
  under a short deadline (the PR-4 residue-probe discipline — cheap,
  best-effort, bounded).  One transient failure makes a node suspect;
  only consecutive probe failures quarantine it, so a nemesis-caused
  outage (partition, SIGSTOP burst) that heals between probes is NOT
  mistaken for node death.
* **Quarantine** is read lock-free on the per-op hot path
  (`is_quarantined` is one frozenset lookup): `ClientWorker`s complete
  ops against a quarantined node immediately as ``:fail``, the nemesis
  skips it when picking targets, and setup phases shrink around it
  under the ``tolerate`` policy.
* **Re-admission** after N consecutive probe passes returns the node
  to rotation; the worker dropped its client when fast-failing, so the
  next op reopens a fresh one.

Policy: ``test["node-loss-policy"]`` is ``"abort"`` (default — a setup
failure raises one aggregate `NodeLossError` naming every failed node)
or ``"tolerate"`` / ``"tolerate:<min_nodes>"`` (failed nodes are
quarantined and the run proceeds on the survivors, unless fewer than
``min_nodes`` remain).

Telemetry: ``node.suspect`` / ``node.quarantined`` / ``node.readmitted``
/ ``node.probe.pass`` / ``node.probe.fail`` / ``node.signal.<kind>`` /
``node.setup.failed`` counters, and `HealthMonitor.summary` is the
per-node availability timeline `core.analyze` attaches as
``results["resilience"]["nodes"]``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Optional

from .. import telemetry

log = logging.getLogger(__name__)

HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
READMITTED = "readmitted"

#: Seconds between probe sweeps while any node is suspect/quarantined.
DEFAULT_PROBE_INTERVAL_S = 1.0
#: Per-probe exec deadline: liveness must be cheap, not another hang.
DEFAULT_PROBE_DEADLINE_S = 5.0
#: Consecutive probe failures that turn suspect into quarantined.  Two,
#: not one: a single failed probe is indistinguishable from a nemesis
#: window or a dropped packet.
DEFAULT_QUARANTINE_AFTER = 2
#: Consecutive probe passes that readmit a quarantined node.
DEFAULT_READMIT_AFTER = 3


class NodeLossError(RuntimeError):
    """A setup phase failed on one or more nodes.  Unlike `real_pmap`'s
    first-error contract, this names EVERY failed node so the operator
    sees the whole blast radius at once.  A `RuntimeError` so callers
    that treat setup crashes generically keep working."""

    def __init__(self, phase: str, failures: dict):
        self.phase = phase
        self.failures = dict(failures)
        names = ", ".join(sorted(str(n) for n in self.failures))
        details = "; ".join(
            f"{n}: {type(e).__name__}: {e}"
            for n, e in sorted(self.failures.items(), key=lambda kv: str(kv[0]))
        )
        super().__init__(
            f"{phase} failed on {len(self.failures)} node(s) "
            f"[{names}]: {details}"
        )


def node_loss_policy(test: dict) -> tuple[str, int]:
    """Parses test["node-loss-policy"]: "abort" (default), "tolerate",
    or "tolerate:<min_nodes>".  Returns (policy, min_nodes)."""
    raw = str(test.get("node-loss-policy") or "abort").strip()
    if raw == "abort":
        return "abort", 0
    if raw == "tolerate":
        return "tolerate", 1
    if raw.startswith("tolerate:"):
        n = int(raw.split(":", 1)[1])
        if n < 1:
            raise ValueError(f"node-loss-policy min_nodes must be >= 1: {raw!r}")
        return "tolerate", n
    raise ValueError(
        f"bad node-loss-policy {raw!r} (want abort | tolerate[:<min_nodes>])"
    )


def _ssh_probe(test: dict, node: Any) -> bool:
    """The default liveness probe: a fresh session running ``true``
    under a short deadline.  Any transport failure reads as down."""
    from . import Session

    deadline = float(
        test.get("health-probe-deadline", DEFAULT_PROBE_DEADLINE_S)
    )
    try:
        sess = Session.connect(test, node)
    except Exception:  # noqa: BLE001 — can't even connect: down
        return False
    try:
        res = sess.exec_star("true", timeout=deadline)
        return int(res.get("exit") or 0) == 0
    except Exception:  # noqa: BLE001
        return False
    finally:
        try:
            sess.disconnect()
        except Exception:  # noqa: BLE001
            pass


def tcp_probe(port_of: Callable[[dict, Any], int],
              host: str = "127.0.0.1") -> Callable[[dict, Any], bool]:
    """A ``test["health-probe"]`` that dials the node's daemon port
    instead of running SSH ``true`` — for the standing monitor, where
    "healthy" means "the monitored daemon accepts connections", not
    "the host answers".  `port_of(test, node)` resolves the port (the
    suites' `node_port` signature)."""
    import socket

    def probe(test: dict, node: Any) -> bool:
        try:
            port = int(port_of(test, node))
        except Exception:  # noqa: BLE001 — unresolvable port = down
            return False
        try:
            with socket.create_connection((host, port), timeout=1.0):
                return True
        except OSError:
            return False

    return probe


class _NodeState:
    __slots__ = (
        "state", "signals", "consec_fail", "consec_pass",
        "probes_pass", "probes_fail", "timeline",
    )

    def __init__(self) -> None:
        self.state = HEALTHY
        self.signals = 0
        self.consec_fail = 0
        self.consec_pass = 0
        self.probes_pass = 0
        self.probes_fail = 0
        self.timeline: list[dict] = []


class HealthMonitor:
    """The per-run node health registry + background monitor thread.

    Bound into the test map as ``test["node-health"]`` by
    `core._run_prepared` (like ``test["fault-ledger"]``); every caller
    goes through the module-level accessors so a test map without one
    pays a single dict get."""

    def __init__(self, test: dict, *, start_thread: bool = True):
        self.test = test
        probe = test.get("health-probe")
        self._probe: Callable[[dict, Any], bool] = (
            probe if callable(probe) else _ssh_probe
        )
        self.probe_interval_s = float(
            test.get("health-probe-interval", DEFAULT_PROBE_INTERVAL_S)
        )
        self.quarantine_after = int(
            test.get("health-quarantine-after", DEFAULT_QUARANTINE_AFTER)
        )
        self.readmit_after = int(
            test.get("health-readmit-after", DEFAULT_READMIT_AFTER)
        )
        self._start_thread = start_thread
        self._lock = threading.Lock()
        self._states: dict[Any, _NodeState] = {}
        #: Swapped atomically under the lock; read lock-free on the
        #: per-op hot path (a reference load is atomic in CPython).
        self._quarantined: frozenset = frozenset()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- hot-path reads --------------------------------------------------

    def is_quarantined(self, node: Any) -> bool:
        return node in self._quarantined

    def quarantined_nodes(self) -> frozenset:
        return self._quarantined

    @property
    def active(self) -> bool:
        """True once any failure signal or quarantine happened — the
        healthy-run summary stays empty (zero behavior change)."""
        return bool(self._states)

    # -- signal intake (passive; the data path calls these) --------------

    def signal(self, node: Any, kind: str, detail: Any = None) -> None:
        """A passive failure signal (open-failed, disconnect,
        op-timeout).  healthy/readmitted -> suspect, and the monitor
        thread spins up for active probing."""
        if node is None:
            return
        telemetry.count(f"node.signal.{kind}")
        with self._lock:
            st = self._states.get(node)
            if st is None:
                st = self._states[node] = _NodeState()
            st.signals += 1
            if st.state in (HEALTHY, READMITTED):
                self._transition(node, st, SUSPECT, f"signal:{kind}")
        self._ensure_thread()

    def quarantine(self, node: Any, reason: str) -> None:
        """Direct quarantine (setup failures under the tolerate
        policy): no probation, the node is out of rotation now.  The
        monitor still probes it for re-admission."""
        with self._lock:
            st = self._states.get(node)
            if st is None:
                st = self._states[node] = _NodeState()
            if st.state != QUARANTINED:
                self._transition(node, st, QUARANTINED, reason)
        self._ensure_thread()

    # -- probing ---------------------------------------------------------

    def probe_sweep(self) -> None:
        """One synchronous probe pass over every suspect/quarantined
        node — the monitor thread's unit of work, callable directly in
        tests for deterministic stepping."""
        with self._lock:
            todo = [
                n for n, st in self._states.items()
                if st.state in (SUSPECT, QUARANTINED)
            ]
        for node in todo:
            if self._stop.is_set():
                return
            ok = False
            try:
                ok = bool(self._probe(self.test, node))
            except Exception as e:  # noqa: BLE001 — probe crash = down
                log.debug("health probe on %s crashed: %r", node, e)
            telemetry.count("node.probe.pass" if ok else "node.probe.fail")
            self._on_probe(node, ok)

    def _on_probe(self, node: Any, ok: bool) -> None:
        with self._lock:
            st = self._states.get(node)
            if st is None:
                return
            if ok:
                st.probes_pass += 1
                st.consec_pass += 1
                st.consec_fail = 0
                if st.state == SUSPECT:
                    self._transition(node, st, HEALTHY, "probe-pass")
                elif (st.state == QUARANTINED
                        and st.consec_pass >= self.readmit_after):
                    self._transition(
                        node, st, READMITTED,
                        f"{self.readmit_after} consecutive probe passes",
                    )
            else:
                st.probes_fail += 1
                st.consec_fail += 1
                st.consec_pass = 0
                if (st.state == SUSPECT
                        and st.consec_fail >= self.quarantine_after):
                    self._transition(
                        node, st, QUARANTINED,
                        f"{self.quarantine_after} consecutive probe failures",
                    )

    def _transition(self, node: Any, st: _NodeState, to: str,
                    reason: str) -> None:
        """Caller holds self._lock."""
        frm = st.state
        st.state = to
        st.consec_fail = 0
        st.consec_pass = 0
        st.timeline.append(
            {"t": time.time(), "from": frm, "to": to, "reason": reason}
        )
        self._quarantined = frozenset(
            n for n, s in self._states.items() if s.state == QUARANTINED
        )
        if to == QUARANTINED:
            telemetry.count("node.quarantined")
            log.warning(
                "node %s QUARANTINED (%s): ops against it now fail fast, "
                "the nemesis will skip it, and probes continue for "
                "re-admission", node, reason,
            )
        elif to == READMITTED:
            telemetry.count("node.readmitted")
            log.info("node %s readmitted (%s): back in rotation",
                     node, reason)
        elif to == SUSPECT:
            telemetry.count("node.suspect")
            log.info("node %s suspect (%s): probing", node, reason)

    # -- monitor thread --------------------------------------------------

    def _ensure_thread(self) -> None:
        if not self._start_thread or self._stop.is_set():
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._monitor, name="jepsen-health-monitor",
                daemon=True,
            )
            self._thread.start()

    def _monitor(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                live = any(
                    st.state in (SUSPECT, QUARANTINED)
                    for st in self._states.values()
                )
            if not live:
                # All settled: exit; the next signal restarts us.
                return
            self.probe_sweep()
            # Pace sweeps strictly by the interval: "N consecutive probe
            # failures" must mean N failures *spread over N intervals*,
            # or a single outage blip could quarantine instantly.
            self._stop.wait(self.probe_interval_s)

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t = self._thread
        # join OUTSIDE the lock: the monitor thread takes it each
        # sweep, and holding it across the join would deadlock.
        if t is not None and t.is_alive():
            t.join(timeout=2.0)

    # -- reporting -------------------------------------------------------

    def summary(self) -> dict:
        """Per-node availability for results["resilience"]["nodes"]:
        state, transition timeline, probe/signal tallies.  Every test
        node appears so the picture is complete."""
        with self._lock:
            out: dict[str, dict] = {}
            for node in self.test.get("nodes") or []:
                st = self._states.get(node)
                if st is None:
                    out[str(node)] = {
                        "state": HEALTHY, "timeline": [], "signals": 0,
                        "probes": {"pass": 0, "fail": 0},
                    }
                else:
                    out[str(node)] = {
                        "state": st.state,
                        "timeline": list(st.timeline),
                        "signals": st.signals,
                        "probes": {"pass": st.probes_pass,
                                   "fail": st.probes_fail},
                    }
            return out


def monitor_for_targets(
    targets: list,
    probe: Callable[[dict, Any], bool],
    *,
    interval_s: float = DEFAULT_PROBE_INTERVAL_S,
    quarantine_after: int = DEFAULT_QUARANTINE_AFTER,
    readmit_after: int = DEFAULT_READMIT_AFTER,
    start_thread: bool = True,
) -> HealthMonitor:
    """A HealthMonitor over arbitrary targets instead of SSH nodes.

    The checkerd federation router reuses the suspect→quarantined
    state machine for daemon addresses: `probe` is a TCP stats
    round-trip instead of an SSH ``true``, signals come from failed
    submissions/polls instead of client ops, and quarantined daemons
    drop out of placement until probes readmit them.  Same lazy-thread
    contract: a healthy fleet runs no monitor thread at all."""
    test = {
        "nodes": list(targets),
        "health-probe": probe,
        "health-probe-interval": interval_s,
        "health-quarantine-after": quarantine_after,
        "health-readmit-after": readmit_after,
    }
    return HealthMonitor(test, start_thread=start_thread)


def monitor_of(test: dict) -> Optional[HealthMonitor]:
    hm = test.get("node-health")
    return hm if isinstance(hm, HealthMonitor) else None


def is_quarantined(test: dict, node: Any) -> bool:
    hm = monitor_of(test)
    return hm is not None and hm.is_quarantined(node)


def quarantined_nodes(test: dict) -> frozenset:
    hm = monitor_of(test)
    return hm.quarantined_nodes() if hm is not None else frozenset()


def eligible_nodes(test: dict) -> list:
    """The test's nodes minus the quarantined ones — the pool setup
    phases and the nemesis draw from."""
    q = quarantined_nodes(test)
    nodes = list(test.get("nodes") or [])
    if not q:
        return nodes
    return [n for n in nodes if n not in q]


def signal(test: dict, node: Any, kind: str) -> None:
    hm = monitor_of(test)
    if hm is not None:
        hm.signal(node, kind)


# ---------------------------------------------------------------------------
# Policy-aware fan-out for setup phases
# ---------------------------------------------------------------------------


def node_fanout(nodes, f) -> tuple[dict, dict]:
    """f(node) in parallel (one thread per node, like real_pmap) but
    returning ({node: result}, {node: error}) instead of raising the
    first error — the aggregate-visibility primitive."""
    nodes = list(nodes)
    results: dict = {}
    failures: dict = {}
    lock = threading.Lock()

    def run(node) -> None:
        try:
            r = f(node)
            with lock:
                results[node] = r
        except BaseException as e:  # noqa: BLE001 — collected, not raised
            with lock:
                failures[node] = e

    threads = [
        threading.Thread(target=run, args=(n,), daemon=True) for n in nodes
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # Preserve the caller's node order (dict(real_pmap(...)) did).
    return (
        {n: results[n] for n in nodes if n in results},
        {n: failures[n] for n in nodes if n in failures},
    )


def absorb_failures(test: dict, phase: str, failures: dict) -> None:
    """Applies the node-loss policy to a setup phase's per-node
    failures.  abort: re-raise a lone failure untouched, or raise one
    aggregate `NodeLossError` naming every failed node when several
    fail.  tolerate: quarantine them and keep going — unless the
    surviving-node count would drop below the policy's floor (or
    there is no health monitor to remember the quarantine)."""
    if not failures:
        return
    policy, min_nodes = node_loss_policy(test)
    hm = monitor_of(test)
    if policy == "abort" or hm is None:
        if len(failures) == 1:
            # One node failed: surface its exception untouched so
            # single-node tests (and anything catching specific types)
            # see exactly what they always saw.  The aggregate wrapper
            # only earns its keep when there are several to name.
            raise next(iter(failures.values()))
        err = NodeLossError(phase, failures)
        raise err from next(iter(failures.values()))
    for node, exc in sorted(failures.items(), key=lambda kv: str(kv[0])):
        log.warning(
            "%s failed on %s under tolerate policy: %r — quarantining",
            phase, node, exc,
        )
        telemetry.count("node.setup.failed")
        hm.quarantine(node, reason=f"{phase}: {type(exc).__name__}")
    surviving = eligible_nodes(test)
    if len(surviving) < max(min_nodes, 1):
        raise NodeLossError(
            f"{phase} (only {len(surviving)} node(s) survive, "
            f"policy floor is {max(min_nodes, 1)})", failures,
        ) from next(iter(failures.values()))


def run_phase(test: dict, phase: str, f, nodes=None) -> dict:
    """`on_nodes` with the node-loss policy applied: f(session, node)
    fans out over the non-quarantined nodes, per-node failures are
    collected, and `absorb_failures` decides abort vs shrink.  Returns
    the survivors' {node: result}."""
    sessions = test.get("sessions")
    if sessions is None:
        raise RuntimeError("no sessions bound; run inside with_sessions(test)")
    todo = [
        n
        for n in (list(nodes) if nodes is not None else list(sessions.keys()))
        if not is_quarantined(test, n)
    ]
    ok, failed = node_fanout(todo, lambda n: f(sessions[n], n))
    absorb_failures(test, phase, failed)
    return ok
