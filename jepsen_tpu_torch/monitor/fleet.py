"""`jepsen fleet` — supervised multi-tenant standing-verification fleet.

The port's copy of `jepsen_tpu/monitor/fleet.py`.  What differs: the
supervisor resolves its `device` ("cuda" by default) when it is made,
so a fleet without its card raises before any child starts; `run`
builds the witness sweep kernel once in this process (the library is
renamed into place, so tenants load it instead of each compiling it);
each tenant child gets the resolved device as `--device`; and a
child's uptime ends when it exits (a thread waits on it), not when the
next reconcile tick notices, so a slow tick cannot make a crash-looping
child look healthy.  The registry files are the reference's: either
package reads a registry the other wrote.

One supervisor process runs N tenants' live monitors (each a child
process wrapping ``run_monitor --suite``) against a shared
router-fronted checkerd federation, with hard tenant isolation as the
design invariant:

  - **Registry** (`fleet.json` + `fleet.jsonl`): the tenant set is a
    crash-safe document — every mutation appends a fsync'd journal
    record *before* the snapshot is atomically rewritten, so a SIGKILL
    between the two recovers by replaying journal records past the
    snapshot's sequence number, and a torn journal tail is skipped,
    never fatal.  Add/remove/drain/restart mutate one tenant without
    touching the others; concurrent mutators (CLI vs. supervisor)
    serialize on a flock'd lock file.

  - **Supervision tree**: each tenant child is restarted through a
    per-tenant :class:`~jepsen_tpu.checkerd.overload.CircuitBreaker`
    (exponential backoff + jitter); a child that dies before
    ``min_uptime_s`` counts as a crash-loop, and ``park_after``
    consecutive crash-loops park the tenant (persisted in the
    registry, dossier written) while every sibling keeps running.
    ``jepsen fleet restart --tenant X`` bumps the spec's generation;
    the reconcile loop notices and performs a rolling restart through
    the monitor's graceful SIGTERM drain path, escalating to SIGKILL
    only after ``drain_timeout_s``.

  - **Fault containment**: every tenant owns a private store dir
    (``<root>/tenants/<name>/store``) — and with it a private search
    dir, fault ledger, slo.jsonl, and daemon port range (ports hash
    from the store dir).  The registry rejects a tenant whose explicit
    node set intersects any sibling's, so one tenant's nemesis can
    never target another tenant's nodes; a monitor dying mid-inject is
    repaired by the existing ``core.repair`` sweep on *that tenant's*
    next start only, because the ledger lives under its store.

  - **Retention**: the supervisor periodically runs
    :func:`jepsen_tpu.monitor.retention.sweep` per tenant, bounding
    dossier count, age, and total disk under the spec's budget.

The supervisor's own observable state is ``fleet-status.json``
(atomic rewrite per tick) — the document `/api/fleet` and
``jepsen fleet status`` read.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Tuple

from .. import device as _device
from .. import telemetry
from ..checkerd.overload import CircuitBreaker
from .retention import RetentionPolicy, disk_bytes, sweep
from .loop import _atomic_json, _write_dossier

log = logging.getLogger("jepsen.fleet")

FLEET_FILE = "fleet.json"
FLEET_JOURNAL = "fleet.jsonl"
FLEET_LOCK = "fleet.lock"
FLEET_STATUS = "fleet-status.json"
TENANTS_DIR = "tenants"

#: Registry tenant states.  ``running`` is supervised; ``drained`` is
#: deliberately stopped (graceful) but still registered; ``parked`` is
#: the crash-loop escalation — stopped until an operator resumes it.
TENANT_STATES = ("running", "drained", "parked")


def tenant_store_dir(root: str, name: str) -> str:
    """The one directory a tenant may touch — store, search dir,
    fault ledger, series, forensics, slo.jsonl all live under it."""
    return os.path.join(root, TENANTS_DIR, name, "store")


# ---------------------------------------------------------------------------
# Tenant spec


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's standing-monitor configuration, as persisted in
    the registry.  ``generation`` is bumped by ``fleet restart`` to
    request a rolling restart; ``state`` tracks the registry-level
    lifecycle (see TENANT_STATES)."""

    name: str
    suite: str = "kvdb"
    nodes: Tuple[str, ...] = ()
    rate: float = 50.0
    duration_s: float = 3600.0       # epoch length; clean exit => restart
    keys: int = 2
    procs_per_key: int = 2
    cadence_s: float = 1.0
    live_faults: Tuple[str, ...] = ()
    sinks: Tuple[str, ...] = ()
    endpoint: Optional[str] = None   # overrides the fleet-wide endpoint
    weight: float = 1.0              # DRR weight (daemon --tenant-weight)
    deadline_s: float = 120.0        # tee verdict deadline (shed budget)
    tee_window_ops: int = 4096
    retain_dossiers: int = 64
    retain_days: float = 14.0
    retain_bytes: Optional[int] = None
    state: str = "running"
    generation: int = 0

    def to_json(self) -> dict:
        return {
            "name": self.name, "suite": self.suite,
            "nodes": list(self.nodes), "rate": self.rate,
            "duration-s": self.duration_s, "keys": self.keys,
            "procs-per-key": self.procs_per_key,
            "cadence-s": self.cadence_s,
            "live-faults": list(self.live_faults),
            "sinks": list(self.sinks), "endpoint": self.endpoint,
            "weight": self.weight, "deadline-s": self.deadline_s,
            "tee-window-ops": self.tee_window_ops,
            "retain-dossiers": self.retain_dossiers,
            "retain-days": self.retain_days,
            "retain-bytes": self.retain_bytes,
            "state": self.state, "generation": self.generation,
        }

    @classmethod
    def from_json(cls, doc: dict) -> "TenantSpec":
        return cls(
            name=doc["name"], suite=doc.get("suite", "kvdb"),
            nodes=tuple(doc.get("nodes") or ()),
            rate=float(doc.get("rate", 50.0)),
            duration_s=float(doc.get("duration-s", 3600.0)),
            keys=int(doc.get("keys", 2)),
            procs_per_key=int(doc.get("procs-per-key", 2)),
            cadence_s=float(doc.get("cadence-s", 1.0)),
            live_faults=tuple(doc.get("live-faults") or ()),
            sinks=tuple(doc.get("sinks") or ()),
            endpoint=doc.get("endpoint"),
            weight=float(doc.get("weight", 1.0)),
            deadline_s=float(doc.get("deadline-s", 120.0)),
            tee_window_ops=int(doc.get("tee-window-ops", 4096)),
            retain_dossiers=int(doc.get("retain-dossiers", 64)),
            retain_days=float(doc.get("retain-days", 14.0)),
            retain_bytes=doc.get("retain-bytes"),
            state=doc.get("state", "running"),
            generation=int(doc.get("generation", 0)),
        )

    def retention_policy(self) -> RetentionPolicy:
        return RetentionPolicy(retain_dossiers=self.retain_dossiers,
                               retain_days=self.retain_days,
                               budget_bytes=self.retain_bytes)


# ---------------------------------------------------------------------------
# Crash-safe registry


class FleetRegistry:
    """Tenant registry: `fleet.json` snapshot + `fleet.jsonl` journal.

    Durability protocol (the jepsenlint append→fsync→apply rule):
    every mutation (1) takes the flock, (2) appends one journal record
    with the next sequence number and fsyncs it, (3) atomically
    rewrites the snapshot.  A crash after (2) is recovered by
    :meth:`load` replaying journal records with ``seq >`` the
    snapshot's; a torn final journal line is skipped.
    """

    def __init__(self, root: str) -> None:
        self.root = root
        self.path = os.path.join(root, FLEET_FILE)
        self.journal = os.path.join(root, FLEET_JOURNAL)
        self._lockpath = os.path.join(root, FLEET_LOCK)

    # -- reads ----------------------------------------------------------

    def _read_snapshot(self) -> Tuple[int, Dict[str, TenantSpec]]:
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return 0, {}
        tenants = {}
        for name, td in (doc.get("tenants") or {}).items():
            try:
                tenants[name] = TenantSpec.from_json(td)
            except (KeyError, TypeError, ValueError):
                continue
        return int(doc.get("seq", 0)), tenants

    def _read_journal(self) -> list:
        recs = []
        try:
            with open(self.journal) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        recs.append(json.loads(line))
                    except ValueError:
                        break  # torn tail — nothing after it is trusted
        except OSError:
            pass
        return recs

    @staticmethod
    def _apply(tenants: Dict[str, TenantSpec], rec: dict) -> None:
        op, name = rec.get("op"), rec.get("tenant")
        if op == "add" and rec.get("spec"):
            try:
                tenants[name] = TenantSpec.from_json(rec["spec"])
            except (KeyError, TypeError, ValueError):
                pass
        elif op == "remove":
            tenants.pop(name, None)
        elif op == "set-state" and name in tenants:
            st = rec.get("state")
            if st in TENANT_STATES:
                tenants[name] = replace(tenants[name], state=st)
        elif op == "bump-generation" and name in tenants:
            sp = tenants[name]
            tenants[name] = replace(sp, generation=sp.generation + 1)

    def load(self) -> Dict[str, TenantSpec]:
        """Snapshot + journal replay; torn-tail tolerant, lock-free
        (readers never block the supervisor or the CLI)."""
        seq, tenants = self._read_snapshot()
        for rec in self._read_journal():
            if int(rec.get("seq", 0)) > seq:
                self._apply(tenants, rec)
        return tenants

    def max_seq(self) -> int:
        seq, _ = self._read_snapshot()
        for rec in self._read_journal():
            seq = max(seq, int(rec.get("seq", 0)))
        return seq

    # -- mutations ------------------------------------------------------

    def _commit(self, rec: dict) -> Dict[str, TenantSpec]:
        """Journal-then-snapshot under the registry lock."""
        import fcntl
        os.makedirs(self.root, exist_ok=True)
        with open(self._lockpath, "a") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            tenants = self.load()
            seq = self.max_seq() + 1
            rec = dict(rec, seq=seq, t=time.time())
            self._apply(tenants, rec)
            with open(self.journal, "a") as jf:
                jf.write(json.dumps(rec, sort_keys=True) + "\n")
                jf.flush()
                os.fsync(jf.fileno())
            _atomic_json(self.path, {
                "seq": seq,
                "tenants": {n: s.to_json()
                            for n, s in sorted(tenants.items())},
            })
            return tenants

    def add(self, spec: TenantSpec) -> None:
        """Register a tenant.  Rejects a name collision and — the
        cross-tenant containment invariant — any explicit node that
        another tenant already owns."""
        if not spec.name or "/" in spec.name or spec.name.startswith("."):
            raise ValueError(f"bad tenant name {spec.name!r}")
        current = self.load()
        if spec.name in current:
            raise ValueError(f"tenant {spec.name!r} already registered")
        mine = set(spec.nodes)
        for other in current.values():
            shared = mine & set(other.nodes)
            if shared:
                raise ValueError(
                    f"tenant {spec.name!r} claims nodes "
                    f"{sorted(shared)} owned by {other.name!r}: "
                    f"cross-tenant nemesis targeting is forbidden")
        self._commit({"op": "add", "tenant": spec.name,
                      "spec": spec.to_json()})
        telemetry.count("fleet.tenants-added")

    def remove(self, name: str) -> None:
        self._commit({"op": "remove", "tenant": name})
        telemetry.count("fleet.tenants-removed")

    def set_state(self, name: str, state: str) -> None:
        if state not in TENANT_STATES:
            raise ValueError(f"bad tenant state {state!r}")
        if name not in self.load():
            raise ValueError(f"unknown tenant {name!r}")
        self._commit({"op": "set-state", "tenant": name, "state": state})

    def bump_generation(self, name: str) -> None:
        if name not in self.load():
            raise ValueError(f"unknown tenant {name!r}")
        self._commit({"op": "bump-generation", "tenant": name})


# ---------------------------------------------------------------------------
# Supervision


def tenant_argv(spec: TenantSpec, store: str, endpoint: Optional[str],
                device: str = "cuda") -> list:
    """The command line of one tenant's live monitor: `python -m
    jepsen_tpu_torch.suites.<suite> monitor ... --device <device>` — the
    same child the live smoke drives, plus tenant identity for the
    checkerd tee."""
    argv = [
        sys.executable, "-m", f"jepsen_tpu_torch.suites.{spec.suite}",
        "monitor", "--suite", spec.suite, "--device", device,
        "--store-dir", store,
        "--search-dir", os.path.join(store, "search"),
        "--rate", str(spec.rate), "--duration", str(spec.duration_s),
        "--keys", str(spec.keys),
        "--procs-per-key", str(spec.procs_per_key),
        "--cadence", str(spec.cadence_s),
        "--tenant", spec.name, "--tee-deadline", str(spec.deadline_s),
        "--tee-window", str(spec.tee_window_ops),
    ]
    if spec.live_faults:
        argv += ["--live-faults", ",".join(spec.live_faults)]
    ep = spec.endpoint or endpoint
    if ep:
        argv += ["--endpoint", ep]
    for n in spec.nodes:
        argv += ["--node", n]
    for s in spec.sinks:
        argv += ["--sink", s]
    return argv


def default_spawn(spec: TenantSpec, store: str, endpoint: Optional[str],
                  device: str = "cuda") -> subprocess.Popen:
    """Spawns `tenant_argv`'s monitor."""
    return subprocess.Popen(tenant_argv(spec, store, endpoint, device))


class _Child:
    """Runtime state for one tenant's monitor process."""

    def __init__(self, spec: TenantSpec, clock: Callable[[], float],
                 rng: Callable[[], float], breaker_base_s: float,
                 breaker_max_s: float, park_after: int) -> None:
        self.spec = spec
        self.proc: Optional[subprocess.Popen] = None
        self.started_at: Optional[float] = None
        #: When `proc` exited (its waiter thread's clock reading).
        self.exited_at: Optional[float] = None
        self.generation = spec.generation
        self.restarts = 0
        self.crash_loops = 0
        self.park_after = park_after
        self.last_exit: Optional[int] = None
        self.draining_until: Optional[float] = None
        self.restart_after_drain = False
        self.last_sweep: dict = {}
        self.breaker = CircuitBreaker(
            failure_threshold=max(1, park_after - 1) or 1,
            base_backoff_s=breaker_base_s, max_backoff_s=breaker_max_s,
            clock=clock, rng=rng)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class FleetSupervisor:
    """The reconcile loop: registry is the desired state, children are
    the actual state, every tick converges one toward the other."""

    def __init__(self, root: str, *, device: str = "cuda",
                 endpoint: Optional[str] = None,
                 tick_s: float = 1.0, park_after: int = 3,
                 min_uptime_s: float = 5.0, drain_timeout_s: float = 20.0,
                 retention_interval_s: float = 30.0,
                 breaker_base_s: float = 0.5, breaker_max_s: float = 30.0,
                 spawn: Optional[Callable[..., subprocess.Popen]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Optional[Callable[[], float]] = None) -> None:
        self.root = os.path.abspath(root)
        #: The tenants' device, resolved here and passed to every child.
        self.device = str(_device.resolve(device))
        self.registry = FleetRegistry(self.root)
        self.endpoint = endpoint
        self.tick_s = tick_s
        self.park_after = max(1, park_after)
        self.min_uptime_s = min_uptime_s
        self.drain_timeout_s = drain_timeout_s
        self.retention_interval_s = retention_interval_s
        self.breaker_base_s = breaker_base_s
        self.breaker_max_s = breaker_max_s
        self.spawn = spawn or functools.partial(default_spawn,
                                                device=self.device)
        self.clock = clock
        self.rng = rng or __import__("random").random
        self.children: Dict[str, _Child] = {}
        self._last_retention = 0.0
        self.status_path = os.path.join(self.root, FLEET_STATUS)

    # -- child lifecycle ------------------------------------------------

    def _start(self, ch: _Child) -> None:
        store = tenant_store_dir(self.root, ch.spec.name)
        os.makedirs(store, exist_ok=True)
        try:
            ch.proc = self.spawn(ch.spec, store, self.endpoint)
        except OSError as e:
            log.warning("fleet: spawn %s failed: %r", ch.spec.name, e)
            ch.breaker.record_failure()
            telemetry.count("fleet.spawn-errors")
            return
        ch.started_at = self.clock()
        ch.exited_at = None
        threading.Thread(target=self._watch, args=(ch, ch.proc),
                         name=f"fleet-wait-{ch.spec.name}",
                         daemon=True).start()
        ch.generation = ch.spec.generation
        telemetry.count("fleet.tenant-starts")
        log.info("fleet: started tenant %s (pid %s, gen %d)",
                 ch.spec.name, ch.proc.pid, ch.generation)

    def _watch(self, ch: _Child, proc: subprocess.Popen) -> None:
        """Notes when `proc` exits, without reaping it (`_reap` does, on
        a tick)."""
        try:
            os.waitid(os.P_PID, proc.pid, os.WEXITED | os.WNOWAIT)
        except ChildProcessError:
            pass  # a tick reaped it first
        if ch.proc is proc:
            ch.exited_at = self.clock()

    def _begin_drain(self, ch: _Child, *, restart_after: bool) -> None:
        """Graceful stop via the monitor's SIGTERM drain path; SIGKILL
        only after drain_timeout_s (handled in _reap_drain)."""
        if not ch.alive() or ch.draining_until is not None:
            ch.restart_after_drain = ch.restart_after_drain or restart_after
            return
        try:
            ch.proc.send_signal(signal.SIGTERM)
        except OSError:
            pass
        ch.draining_until = self.clock() + self.drain_timeout_s
        ch.restart_after_drain = restart_after
        telemetry.count("fleet.drains")

    def _reap(self, ch: _Child) -> None:
        """Handle an exited child: crash-loop accounting, parking."""
        rc = ch.proc.poll()
        ch.last_exit = rc
        ended = ch.exited_at if ch.exited_at is not None else self.clock()
        uptime = (ended - ch.started_at
                  if ch.started_at is not None else 0.0)
        drained = ch.draining_until is not None
        ch.proc = None
        ch.started_at = None
        ch.draining_until = None
        if drained:
            return  # deliberate stop, not a crash
        if uptime >= self.min_uptime_s:
            # A long-lived child that exits (epoch end, clean rc) is
            # healthy: reset the loop counter, restart next tick.
            ch.crash_loops = 0
            ch.breaker.record_success()
            return
        ch.crash_loops += 1
        ch.breaker.record_failure()
        telemetry.count("fleet.crash-loops")
        log.warning("fleet: tenant %s crash-loop %d/%d (rc=%s, "
                    "uptime %.1fs)", ch.spec.name, ch.crash_loops,
                    self.park_after, rc, uptime)
        if ch.crash_loops >= self.park_after:
            self._park(ch, rc, uptime)

    def _park(self, ch: _Child, rc: Optional[int], uptime: float) -> None:
        telemetry.count("fleet.tenants-parked")
        log.error("fleet: parking tenant %s after %d crash-loops",
                  ch.spec.name, ch.crash_loops)
        # The dossier goes first: whoever reads "parked" in the registry
        # finds it on disk (the reference writes it after the state, so
        # a reader between the two finds none).
        store = tenant_store_dir(self.root, ch.spec.name)
        _write_dossier(store, f"fleet-parked-{int(time.time())}", {
            "kind": "fleet-parked", "tenant": ch.spec.name,
            "crash-loops": ch.crash_loops, "last-exit": rc,
            "last-uptime-s": round(uptime, 3),
            "generation": ch.generation, "t": time.time(),
        })
        try:
            self.registry.set_state(ch.spec.name, "parked")
        except ValueError:
            pass  # tenant was removed out from under us

    # -- reconcile ------------------------------------------------------

    def _tick(self) -> None:
        telemetry.count("fleet.reconciles")
        specs = self.registry.load()
        now = self.clock()

        # Forget removed tenants (drain first).
        for name in list(self.children):
            if name not in specs:
                ch = self.children[name]
                if ch.alive():
                    self._begin_drain(ch, restart_after=False)
                    if ch.draining_until is not None and \
                            now < ch.draining_until:
                        continue
                    self._force_kill(ch)
                if ch.proc is not None:
                    self._reap(ch)
                del self.children[name]

        for name, spec in specs.items():
            ch = self.children.get(name)
            if ch is None:
                ch = self.children[name] = _Child(
                    spec, self.clock, self.rng, self.breaker_base_s,
                    self.breaker_max_s, self.park_after)
            prev_state = ch.spec.state
            ch.spec = spec
            if spec.state != "parked" and prev_state == "parked":
                # Operator resumed a parked tenant: clean slate.
                ch.crash_loops = 0
                ch.breaker = CircuitBreaker(
                    failure_threshold=max(1, self.park_after - 1),
                    base_backoff_s=self.breaker_base_s,
                    max_backoff_s=self.breaker_max_s,
                    clock=self.clock, rng=self.rng)

            # Drain-deadline escalation is state-independent.
            if ch.alive() and ch.draining_until is not None \
                    and now >= ch.draining_until:
                self._force_kill(ch)

            if ch.proc is not None and not ch.alive():
                self._reap(ch)

            if spec.state in ("drained", "parked"):
                if ch.alive():
                    self._begin_drain(ch, restart_after=False)
                continue

            # state == running
            if ch.alive():
                if ch.generation != spec.generation:
                    # Rolling restart: drain, then relaunch.
                    self._begin_drain(ch, restart_after=True)
                continue
            want_start = (ch.restart_after_drain
                          or ch.last_exit is None
                          or ch.crash_loops < self.park_after)
            if want_start and ch.breaker.allow():
                was_restart = ch.last_exit is not None \
                    or ch.restart_after_drain
                ch.restart_after_drain = False
                self._start(ch)
                if was_restart and ch.proc is not None:
                    ch.restarts += 1
                    telemetry.count("fleet.tenant-restarts")

    def _force_kill(self, ch: _Child) -> None:
        try:
            ch.proc.kill()
        except OSError:
            pass
        try:
            ch.proc.wait(timeout=10)
        except Exception:  # noqa: BLE001 — already escalating
            pass
        telemetry.count("fleet.drain-kills")

    # -- retention ------------------------------------------------------

    def _retention_pass(self) -> None:
        now = self.clock()
        if now - self._last_retention < self.retention_interval_s:
            return
        self._last_retention = now
        for name, ch in self.children.items():
            store = tenant_store_dir(self.root, name)
            if not os.path.isdir(store):
                continue
            try:
                ch.last_sweep = sweep(store, ch.spec.retention_policy())
            except OSError as e:
                telemetry.count("fleet.retention.errors")
                log.warning("fleet: retention sweep %s failed: %r",
                            name, e)

    # -- status ---------------------------------------------------------

    def status(self) -> dict:
        tenants = {}
        for name, ch in sorted(self.children.items()):
            store = tenant_store_dir(self.root, name)
            tenants[name] = {
                "state": ch.spec.state,
                "suite": ch.spec.suite,
                "alive": ch.alive(),
                "pid": ch.proc.pid if ch.alive() else None,
                "generation": ch.generation,
                "target-generation": ch.spec.generation,
                "restarts": ch.restarts,
                "crash-loops": ch.crash_loops,
                "last-exit": ch.last_exit,
                "draining": ch.draining_until is not None,
                "breaker": ch.breaker.stats(),
                "weight": ch.spec.weight,
                "deadline-s": ch.spec.deadline_s,
                "disk-bytes": disk_bytes(store)
                if os.path.isdir(store) else 0,
                "retention": ch.last_sweep,
                "store-dir": store,
            }
        return {"t": time.time(), "root": self.root,
                "endpoint": self.endpoint, "tenants": tenants}

    def _write_status(self) -> None:
        _atomic_json(self.status_path, self.status())

    # -- main loop ------------------------------------------------------

    def run(self, stop: Optional[threading.Event] = None) -> int:
        """Supervise until ``stop`` is set (or signals arrive when the
        caller installed none).  Children are drained on exit."""
        stop = stop or threading.Event()
        os.makedirs(self.root, exist_ok=True)
        if self.device.startswith("cuda"):
            # One build here before any child starts: the tenants then
            # load the built library instead of each compiling it.
            from ..ops import kernels

            kernels.sweep_lib()
        try:
            while not stop.is_set():
                self._tick()
                self._retention_pass()
                self._write_status()
                stop.wait(self.tick_s)
        finally:
            self.shutdown()
        return 0

    def shutdown(self) -> None:
        """Drain every child through SIGTERM, escalate at the drain
        deadline, and leave a final status snapshot."""
        deadline = self.clock() + self.drain_timeout_s
        for ch in self.children.values():
            if ch.alive():
                self._begin_drain(ch, restart_after=False)
        while self.clock() < deadline and \
                any(ch.alive() for ch in self.children.values()):
            time.sleep(0.1)
        for ch in self.children.values():
            if ch.alive():
                self._force_kill(ch)
            if ch.proc is not None:
                self._reap(ch)
        self._write_status()
        log.info("fleet: shut down")


def read_status(root: str) -> dict:
    """fleet-status.json, torn-tolerant (atomic writes make a torn
    read impossible; missing file yields {})."""
    try:
        with open(os.path.join(root, FLEET_STATUS)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}
