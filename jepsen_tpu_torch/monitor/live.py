"""Live-target standing verification: the monitor's suite-backed mode.

The port's copy of `jepsen_tpu/monitor/live.py` (host code: the client
pool, the fault windows and the supervision; the verdicts come from the
loop's rolling checker, on its device).  The catch-alls below guard
client calls, fault windows and daemon restarts, none of which reaches
the card; the checker's device faults raise in `run_monitor`.

`jepsen monitor --suite kvdb` swaps the in-process `_OpSource` for a
pool of real suite clients talking to real daemon processes, and runs a
*live nemesis driver* inside the standing loop: coverage-guided fault
schedules (nemesis/search.py) are materialized window after window, each
window's outcome is fingerprinted (resilience counters, verdict and
anomaly signatures, heal-vs-abandon ledger records, epoch restarts), and
the next window evolves toward novelty.  Three standing guarantees:

  * **Honest degradation, never a wedge.**  A dead client reconnects
    with backoff; a dead node is quarantined and readmitted by the
    health monitor; a frontier death after discard is an epoch restart
    with a dossier; an unhealed window left by a crash is swept by
    `core.repair` on the next start.
  * **Intent before inject.**  Every fault flows through the same
    nemesis packages batch tests use, so the fault ledger journals a
    compensator before the wound lands — a SIGKILL'd monitor leaves a
    ledger a fresh one can replay.
  * **Guaranteed heals.**  Every window ends by applying the schedule's
    per-family final heal in a `finally:` block, stop-flag or not, and
    daemons that die *outside* a fault window are restarted by the
    supervisor (counted `monitor.live.daemon-restarts`).

Crash-safety: the search frontier checkpoints atomically to
`search.json` after every window, so a killed monitor resumes both its
verdict stream (fresh epoch, honest unknown for the dying one) and its
coverage search exactly where they stopped.
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue
import random
import threading
import time
from typing import Any, Callable, Optional

from .. import telemetry
from ..control import health
from ..control import util as cutil
from ..history import FAIL, INFO
from ..history.core import Op
from ..nemesis import ledger as fault_ledger
from ..nemesis import search
from .loop import _atomic_json, _write_dossier

log = logging.getLogger(__name__)

#: Status document the dashboard and the smoke read, under the store dir.
LIVE_STATUS_FILE = "live-status.json"

#: Subdirectory of the store dir holding the live run's cluster state:
#: fault ledger, repair reports.  Stable across restarts so a resumed
#: monitor finds the crashed run's ledger.
LIVE_DIR = "live"

#: suite name -> callable returning the adapter dict.  Lazy imports keep
#: `import jepsen_tpu_torch.monitor` free of suite (and compiler) baggage.
SUITES: dict[str, Callable[[], dict]] = {}


def _register(name: str, modname: str) -> None:
    def load() -> dict:
        import importlib

        mod = importlib.import_module(f"jepsen_tpu_torch.suites.{modname}")
        return mod.live_suite()

    SUITES[name] = load


for _name in ("kvdb", "logd", "electd", "txnd", "repkv"):
    _register(_name, _name)


def resolve_suite(name: str) -> dict:
    try:
        loader = SUITES[name]
    except KeyError:
        raise ValueError(
            f"unknown monitor suite {name!r}; have {sorted(SUITES)}"
        ) from None
    return loader()


# ---------------------------------------------------------------------------
# Live op source: a pool of real suite clients
# ---------------------------------------------------------------------------


class LiveSource:
    """Suite-backed replacement for the loop's `_OpSource`: one worker
    thread per (key, process) running a real client against a real
    daemon, emitting (key, Op) events through a bounded queue in the
    exact shape the in-process source produces — invoke then
    completion, `process = key * procs_per_key + p`, a monotonic global
    index assigned at dequeue.

    Wound behavior is the tentpole's contract: a quarantined node
    fast-fails without dialing; a failed open retries with exponential
    backoff and signals the health monitor; an invoke that raises
    becomes an honest `info` completion, the client is dropped, and the
    worker reconnects."""

    QUEUE_DEPTH = 4096
    BACKOFF_MIN = 0.05
    BACKOFF_MAX = 2.0
    #: info-completion error prefixes that mean the protocol stream may
    #: be desynchronized: drop the client and reconnect.
    DESYNC_ERRORS = ("timeout", "io", "connection", "closed")

    def __init__(self, test: dict, adapter: dict, *, keys: int,
                 procs_per_key: int, rate: float, seed: int):
        self.test = test
        self.adapter = adapter
        self.keys = keys
        self.procs = procs_per_key
        self.seed = seed
        # Per-worker pacing: the pool as a whole targets ~rate
        # completions/s; each worker's share is rate / (keys * procs).
        per_worker = max(1e-3, rate / max(1, keys * procs_per_key))
        self.interval = 1.0 / per_worker
        self.index = 0
        self.q: queue.Queue = queue.Queue(maxsize=self.QUEUE_DEPTH)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def start(self) -> None:
        for key in range(self.keys):
            for p in range(self.procs):
                t = threading.Thread(
                    target=self._work, args=(key, p),
                    name=f"live-src-{key}-{p}", daemon=True,
                )
                self._threads.append(t)
                t.start()

    # -- loop-facing API ------------------------------------------------

    def next_event(self, timeout: float = 0.25
                   ) -> Optional[tuple[int, Op]]:
        """The next (key, op) event, or None if the pool produced
        nothing within `timeout` (wounded cluster, all nodes down)."""
        try:
            key, op = self.q.get(timeout=timeout)
        except queue.Empty:
            return None
        self.index += 1
        return key, op.replace(index=self.index)

    def drain(self, deadline_s: float = 5.0) -> list[tuple[int, Op]]:
        """Stops the workers and returns every event still in flight
        (keeping queue space free so blocked workers can finish their
        final put and exit)."""
        self._stop.set()
        leftovers: list[tuple[int, Op]] = []

        def pop(timeout: Optional[float]) -> bool:
            try:
                key, op = (self.q.get(timeout=timeout) if timeout
                           else self.q.get_nowait())
            except queue.Empty:
                return False
            self.index += 1
            leftovers.append((key, op.replace(index=self.index)))
            return True

        deadline = time.monotonic() + deadline_s
        while (any(t.is_alive() for t in self._threads)
               and time.monotonic() < deadline):
            pop(0.05)
        for t in self._threads:
            t.join(timeout=0.5)
        while pop(None):
            pass
        return leftovers

    # -- worker ---------------------------------------------------------

    def _emit(self, key: int, op: Op) -> None:
        while not self._stop.is_set():
            try:
                self.q.put((key, op), timeout=0.25)
                return
            except queue.Full:
                continue

    def _pace(self, t_start: float, extra: float = 0.0) -> None:
        budget = self.interval + extra - (time.monotonic() - t_start)
        if budget > 0:
            self._stop.wait(budget)

    def _work(self, key: int, p: int) -> None:
        from ..suites._common import live_register_mix

        test, adapter = self.test, self.adapter
        proc = key * self.procs + p
        rng = random.Random((self.seed * 1_000_003) ^ proc)
        lo, hi = adapter.get("values", (0, 5))
        next_op = live_register_mix(
            rng, with_cas=bool(adapter.get("with_cas")), lo=lo, hi=hi
        )
        node = adapter["node"](test, key)
        template = adapter["client"](test, key)
        client = None
        backoff = self.BACKOFF_MIN
        connected_once = False
        try:
            while not self._stop.is_set():
                t_start = time.monotonic()
                if health.is_quarantined(test, node):
                    # Fast-fail: don't burn a dial timeout on a node
                    # the health monitor already wrote off.
                    inv = Op(type="invoke", f="read", value=None,
                             process=proc)
                    self._emit(key, inv)
                    self._emit(key, inv.complete(
                        FAIL, error="node-quarantined"))
                    telemetry.count("monitor.live.fastfail-quarantined")
                    self._pace(t_start, extra=0.05)
                    continue
                if client is None:
                    try:
                        client = template.open(test, node)
                    except Exception as e:  # noqa: BLE001 — retry forever
                        health.signal(test, node, "open-failed")
                        telemetry.count("monitor.live.open-retries")
                        log.debug("live open %s/%s failed: %r",
                                  node, proc, e)
                        self._stop.wait(backoff)
                        backoff = min(backoff * 2, self.BACKOFF_MAX)
                        continue
                    backoff = self.BACKOFF_MIN
                    if connected_once:
                        telemetry.count("monitor.live.client-reconnects")
                    connected_once = True
                f, value = next_op()
                inv = Op(type="invoke", f=f, value=value, process=proc)
                self._emit(key, inv)
                try:
                    comp = client.invoke(test, inv)
                except Exception as e:  # noqa: BLE001 — wound, not crash
                    telemetry.count("monitor.live.client-errors")
                    health.signal(test, node, "invoke-failed")
                    self._close(client)
                    client = None
                    comp = inv.complete(
                        INFO, error=f"{type(e).__name__}: {e}")
                self._emit(key, comp)
                if client is not None and comp.type == INFO:
                    err = str((comp.ext or {}).get("error", "")).lower()
                    if err.startswith(self.DESYNC_ERRORS):
                        self._close(client)
                        client = None
                        telemetry.count("monitor.live.client-drops")
                self._pace(t_start)
        finally:
            self._close(client)

    def _close(self, client: Any) -> None:
        if client is None:
            return
        try:
            client.close(self.test)
        except Exception:  # noqa: BLE001 — already broken
            pass


# ---------------------------------------------------------------------------
# Live nemesis driver: coverage-guided fault windows inside the run
# ---------------------------------------------------------------------------


class LiveNemesisDriver(threading.Thread):
    """Materializes one evolved fault schedule per window against the
    live cluster, fingerprints the outcome, and checkpoints the search
    frontier so a killed monitor resumes where it stopped.

    Window discipline: every op flows through the registry nemesis
    packages (ledger intent precedes every wound), the node-loss floor
    is enforced at evolution time, and the per-family final heals run
    in a `finally:` so neither an error nor a stop-flag leaves a wound
    open at thread exit."""

    FRONTIER_CAP = 32
    RECENT_CAP = 8

    def __init__(self, test: dict, *, families: tuple,
                 search_dir: str, store_dir: str, seed: int,
                 checker_status: Callable[[], dict],
                 gap_s: float = 0.75, seed_duration_s: float = 2.0):
        super().__init__(name="live-nemesis", daemon=True)
        self.test = test
        self.families = tuple(families)
        self.search_dir = search_dir
        self.store_dir = store_dir
        self.checker_status = checker_status
        self.gap_s = gap_s
        self.seed_duration_s = seed_duration_s
        self.rng = random.Random(seed ^ 0x5EED)
        nodes = list(test.get("nodes") or [])
        # Single-node suites must keep a floor of 0 — the whole point
        # of a kill window there is taking the only daemon down and
        # healing it; floor 1 would strip every node-down event.
        self.min_nodes = (0 if len(nodes) <= 1
                          else search.floor_from_test(test))
        self.coverage = search.CoverageMap()
        self.frontier: list[search.Schedule] = []
        self.windows = 0
        self.novel_windows = 0
        self.recent: list[dict] = []
        #: Nodes a kill/pause op of the current window took down on
        #: purpose — the supervisor must not "rescue" them mid-window.
        self.scheduled_down: set = set()
        self.faults_active = False
        self._halt = threading.Event()
        self._restore()

    # -- persistence ----------------------------------------------------

    def _restore(self) -> None:
        state = search.load_state(self.search_dir)
        if not state:
            return
        self.coverage.features = set(state.get("coverage") or [])
        self.windows = int(state.get("windows") or 0)
        self.novel_windows = int(state.get("novel-windows") or 0)
        for d in state.get("frontier") or []:
            try:
                self.frontier.append(search.Schedule.from_json(d))
            except Exception:  # noqa: BLE001 — drop a torn genome
                log.warning("live search: dropping unparsable genome")
        self.recent = list(state.get("recent") or [])[-self.RECENT_CAP:]
        telemetry.count("monitor.live.resumes")
        log.info(
            "live search resumed: %d windows, %d coverage features, "
            "%d frontier genomes", self.windows, len(self.coverage),
            len(self.frontier),
        )

    def _checkpoint(self) -> None:
        os.makedirs(self.search_dir, exist_ok=True)
        search._write_json_atomic(
            os.path.join(self.search_dir, search.STATE_FILE),
            {
                "mode": "live-monitor",
                "families": list(self.families),
                "windows": self.windows,
                "novel-windows": self.novel_windows,
                "coverage": sorted(self.coverage.features),
                "frontier": [s.to_json() for s in self.frontier],
                "recent": self.recent,
            },
        )
        _atomic_json(
            os.path.join(self.store_dir, LIVE_STATUS_FILE), self.status()
        )

    def status(self) -> dict:
        return {
            "families": list(self.families),
            "windows": self.windows,
            "novel-windows": self.novel_windows,
            "coverage": len(self.coverage),
            "frontier": len(self.frontier),
            "recent": self.recent,
        }

    # -- window machinery -----------------------------------------------

    def run(self) -> None:
        while not self._halt.is_set():
            try:
                self._window()
            except Exception:  # noqa: BLE001 — the driver must outlive
                telemetry.count("monitor.live.nemesis-errors")
                log.exception("live nemesis window %d failed",
                              self.windows)
            if self._halt.wait(self.gap_s):
                break

    def stop_and_join(self, timeout: float = 30.0) -> None:
        self._halt.set()
        if self.is_alive():
            self.join(timeout=timeout)
            if self.is_alive():
                log.warning("live nemesis driver did not stop in %.0fs",
                            timeout)

    def _sleep_until(self, deadline: float) -> None:
        while not self._halt.is_set():
            budget = deadline - time.monotonic()
            if budget <= 0:
                return
            self._halt.wait(min(budget, 0.25))

    def _window(self) -> None:
        test = self.test
        nodes = list(test.get("nodes") or [])
        sched = search.evolve(
            self.frontier, self.families, len(nodes), self.min_nodes,
            self.rng, window=self.windows,
            seed_duration=self.seed_duration_s,
        )
        pkg = search.compile_schedule(
            sched, {"interval": 1.0}, nodes=nodes
        )
        nem = pkg["nemesis"]
        led = fault_ledger.ledger_of(test)
        watermark = len(led.records()) if led else 0
        before = dict(telemetry.resilience_counters())
        status0 = self.checker_status()
        error: Optional[str] = None
        t0 = time.monotonic()
        self.faults_active = True
        try:
            if nem is not None:
                nem.setup(test)
            for t, op_d in pkg["timeline"]:
                if self._halt.is_set():
                    break
                self._sleep_until(t0 + t)
                self._mark_scheduled(op_d)
                if nem is not None:
                    nem.invoke(test, Op.from_dict(
                        dict(op_d, process="nemesis")))
                if op_d.get("f") in ("kill", "pause", "partition",
                                     "start-partition", "start-packet",
                                     "bump"):
                    telemetry.count("monitor.live.faults-injected")
            # Quiesce past the schedule horizon so wounds have time to
            # show up in the op stream before the heals land.
            self._sleep_until(t0 + sched.horizon)
        except Exception as e:  # noqa: BLE001 — heal anyway, fingerprint
            error = f"{type(e).__name__}: {e}"
            telemetry.count("monitor.live.nemesis-errors")
            log.warning("live window %d inject failed: %r",
                        self.windows, e)
        finally:
            # Guaranteed per-family heals: stop-flag, error, or clean
            # run, every family's idempotent final heal is applied.
            for fam in sorted(sched.families):
                heal = search._FINAL_HEAL.get(fam)
                if heal is None:
                    continue
                try:
                    if nem is not None:
                        nem.invoke(test, Op.from_dict(
                            dict(heal, process="nemesis")))
                    telemetry.count("monitor.live.heals")
                except Exception as e:  # noqa: BLE001 — keep healing
                    telemetry.count("monitor.live.heal-errors")
                    log.warning("live heal %s failed: %r", fam, e)
            if nem is not None:
                with contextlib.suppress(Exception):
                    nem.teardown(test)
            self.scheduled_down.clear()
            self.faults_active = False

        self._fingerprint(sched, watermark=watermark, before=before,
                          status0=status0, error=error, t0=t0, led=led)

    def _mark_scheduled(self, op_d: dict) -> None:
        f = op_d.get("f")
        if f in ("kill", "pause"):
            targets = op_d.get("value")
            self.scheduled_down.update(
                targets if isinstance(targets, (list, tuple))
                else self.test.get("nodes") or []
            )
        elif f in ("start", "resume"):
            targets = op_d.get("value")
            if isinstance(targets, (list, tuple)):
                self.scheduled_down.difference_update(targets)
            else:
                self.scheduled_down.clear()

    def _fingerprint(self, sched: search.Schedule, *, watermark: int,
                     before: dict, status0: dict, error: Optional[str],
                     t0: float, led) -> None:
        from ..forensics import window_fingerprint

        after = telemetry.resilience_counters()
        delta = {
            k: round(v - before.get(k, 0), 6)
            for k, v in after.items()
            if isinstance(v, (int, float)) and v - before.get(k, 0) > 0
        }
        status1 = self.checker_status()
        epoch_delta = (status1.get("epoch-restarts", 0)
                       - status0.get("epoch-restarts", 0))
        records = led.records()[watermark:] if led else []
        outcome = {
            "resilience": delta,
            # Epoch restarts are the live run's verdict signal: a
            # window that forced one is honestly unknown, not invalid.
            "results": {"valid": True if epoch_delta == 0 else None},
            "ledger": records,
            "hang": False,
            "error": error,
        }
        sig = search.signature(outcome)
        novel = self.coverage.add(sig)
        if novel:
            self.novel_windows += 1
            telemetry.count("monitor.live.novel-windows")
            self.frontier.append(sched)
            del self.frontier[:-self.FRONTIER_CAP]
        self.windows += 1
        telemetry.count("monitor.live.windows")
        outstanding = len(led.outstanding()) if led else 0
        telemetry.gauge("monitor.live.outstanding", outstanding)
        telemetry.gauge("monitor.live.coverage-features",
                        len(self.coverage))
        record = {
            "window": self.windows,
            "t": time.time(),
            "families": sorted(sched.families),
            "events": len(sched.events),
            "duration-s": round(time.monotonic() - t0, 3),
            "fingerprint": window_fingerprint(sig),
            "novel": sorted(novel),
            "epoch-restarts": epoch_delta,
            "ledger-records": len(records),
            "outstanding": outstanding,
            "error": error,
        }
        self.recent.append(record)
        del self.recent[:-self.RECENT_CAP]
        self._checkpoint()
        _write_dossier(
            self.store_dir, f"live-window-{self.windows}",
            dict(record, schedule=sched.to_json(),
                 signature=sorted(sig)),
        )
        log.info(
            "live window %d: families=%s novel=%d coverage=%d "
            "epoch-restarts=%d outstanding=%d",
            self.windows, ",".join(sorted(sched.families)), len(novel),
            len(self.coverage), epoch_delta, outstanding,
        )


# ---------------------------------------------------------------------------
# Daemon supervision: restarts outside fault windows
# ---------------------------------------------------------------------------


class _Supervisor(threading.Thread):
    """Detects a daemon that died *outside* a fault window (OOM, bug,
    disk full — not the nemesis) and restarts it via
    `retrying_daemon_start`, counted `monitor.live.daemon-restarts`.
    Scheduled wounds are the driver's business: the sweep skips nodes
    in `driver.scheduled_down`, quarantined nodes, and entire sweeps
    while a window is active."""

    def __init__(self, test: dict, driver: Optional[LiveNemesisDriver],
                 port_of: Callable[[dict, Any], int],
                 interval_s: float = 1.0, fails_needed: int = 2):
        super().__init__(name="live-supervisor", daemon=True)
        self.test = test
        self.driver = driver
        self.port_of = port_of
        self.interval_s = interval_s
        self.fails_needed = fails_needed
        self._halt = threading.Event()
        self._probe = health.tcp_probe(port_of)

    def stop_and_join(self, timeout: float = 5.0) -> None:
        self._halt.set()
        if self.is_alive():
            self.join(timeout=timeout)

    def run(self) -> None:
        fails: dict = {}
        while not self._halt.wait(self.interval_s):
            if self.driver is not None and self.driver.faults_active:
                continue
            down = (self.driver.scheduled_down
                    if self.driver is not None else set())
            for node in self.test.get("nodes") or []:
                if node in down or health.is_quarantined(
                        self.test, node):
                    fails.pop(node, None)
                    continue
                if self._probe(self.test, node):
                    fails.pop(node, None)
                    continue
                fails[node] = fails.get(node, 0) + 1
                if fails[node] < self.fails_needed:
                    continue
                fails.pop(node, None)
                self._restart(node)

    def _restart(self, node: Any) -> None:
        sess = (self.test.get("sessions") or {}).get(node)
        db = self.test.get("db")
        if sess is None or db is None:
            return
        log.warning("live supervisor: daemon on %s is down outside a "
                    "fault window; restarting", node)
        try:
            cutil.retrying_daemon_start(
                sess, lambda: db.start(self.test, sess, node),
                self.port_of(self.test, node),
                await_timeout_s=5.0, interval_s=0.1,
            )
            telemetry.count("monitor.live.daemon-restarts")
        except Exception as e:  # noqa: BLE001 — keep supervising
            telemetry.count("monitor.live.restart-failures")
            log.warning("live supervisor: restart of %s failed: %r",
                        node, e)


# ---------------------------------------------------------------------------
# Lifecycle: wiring a suite cluster into the standing loop
# ---------------------------------------------------------------------------


class LiveContext:
    """Owns the live run's cluster: resolves the suite adapter, sweeps
    a crashed predecessor's ledger with `core.repair`, boots the
    daemons, and runs the source/driver/supervisor trio.  `run_monitor`
    calls `start` before its loop, `shutdown` first in its finally (so
    leftovers still reach the checker), and `finalize` last (teardown,
    residue probe, summary block)."""

    def __init__(self, cfg) -> None:
        self.cfg = cfg
        self.adapter: dict = {}
        self.test: dict = {}
        self.source: Optional[LiveSource] = None
        self.driver: Optional[LiveNemesisDriver] = None
        self.supervisor: Optional[_Supervisor] = None
        self.repair_report: Optional[dict] = None
        self._stack = contextlib.ExitStack()
        self._led: Optional[fault_ledger.FaultLedger] = None
        self._hm = None

    # -- startup --------------------------------------------------------

    def start(self, checker_status: Callable[[], dict]) -> LiveSource:
        from .. import core as jcore
        from .. import db as jdb
        from .. import oses
        from ..control import with_sessions

        cfg = self.cfg
        self.adapter = resolve_suite(cfg.suite)
        test = self.adapter["test"]({
            "store-dir": cfg.store_dir,
            "nodes": list(cfg.nodes) or None,
        })
        live_dir = os.path.join(cfg.store_dir, LIVE_DIR)
        os.makedirs(live_dir, exist_ok=True)
        ledger_path = fault_ledger.ledger_path(live_dir)

        # Crash recovery: a predecessor SIGKILL'd between inject and
        # heal left outstanding intent — sweep it before touching the
        # cluster, so setup starts from a healed machine.
        if fault_ledger.read_outstanding(ledger_path):
            log.warning("live monitor: predecessor left outstanding "
                        "faults; running repair sweep")
            self.repair_report = jcore.repair(live_dir, dict(test))
            telemetry.count("monitor.live.resume-repairs")

        test["fault-ledger"] = self._led = fault_ledger.FaultLedger(
            ledger_path)
        test["health-probe"] = health.tcp_probe(self.adapter["port"])
        test["node-health"] = self._hm = health.HealthMonitor(test)
        test.setdefault("node-loss-policy", "tolerate")
        self.test = test

        self._stack.enter_context(with_sessions(test))
        oses.setup(test)
        jdb.cycle(test)

        families = self._families()
        search_dir = cfg.search_dir or os.path.join(live_dir, "search")
        if families:
            self.driver = LiveNemesisDriver(
                test, families=families, search_dir=search_dir,
                store_dir=cfg.store_dir, seed=cfg.seed,
                checker_status=checker_status,
                gap_s=cfg.window_gap_s,
                seed_duration_s=cfg.live_seed_duration_s,
            )
        if cfg.supervise:
            self.supervisor = _Supervisor(
                test, self.driver, self.adapter["port"])
        self.source = LiveSource(
            test, self.adapter, keys=cfg.keys,
            procs_per_key=cfg.procs_per_key, rate=cfg.rate,
            seed=cfg.seed,
        )
        self.source.start()
        if self.supervisor is not None:
            self.supervisor.start()
        if self.driver is not None:
            self.driver.start()
        log.info(
            "live monitor: suite=%s nodes=%s families=%s search=%s",
            cfg.suite, test.get("nodes"), list(families), search_dir,
        )
        return self.source

    def _families(self) -> tuple:
        cfg, adapter, test = self.cfg, self.adapter, self.test
        allowed = adapter.get("families")
        if cfg.live_faults:
            fams = tuple(cfg.live_faults)
            if fams == ("none",):
                return ()
            if allowed:
                dropped = [f for f in fams if f not in allowed]
                if dropped:
                    log.warning(
                        "live monitor: suite %s forbids %s (kept %s)",
                        cfg.suite, dropped, list(allowed))
                fams = tuple(f for f in fams if f in allowed)
            return fams
        if allowed:
            return tuple(allowed)
        # Capability-probed defaults: node-down families are always
        # safe; partition needs more than one node to part; packet
        # and clock faults are machine-global unless the transport
        # declares it isolates them (Remote.isolation) — a LocalRemote
        # tenant skips them, an ssh/k8s/netns-backed cluster gets the
        # full family set.
        fams = ["kill", "pause"]
        if len(test.get("nodes") or []) > 1:
            fams.insert(0, "partition")
        isolation = getattr(test.get("remote"), "isolation",
                            frozenset())
        if "net" in isolation:
            fams.append("packet")
        if "clock" in isolation:
            fams.append("clock")
        return tuple(fams)

    # -- shutdown -------------------------------------------------------

    def shutdown(self) -> list[tuple[int, Op]]:
        """Graceful-drain half of the teardown: stop the driver (its
        window `finally` heals any open wounds), stop the supervisor,
        and drain the source so the loop can feed the leftovers."""
        if self.driver is not None:
            self.driver.stop_and_join()
        if self.supervisor is not None:
            self.supervisor.stop_and_join()
        if self.source is not None:
            return self.source.drain()
        return []

    def finalize(self) -> dict:
        """Cluster teardown + the summary's "live" block: daemons are
        stopped (their kill/pause intents healed by tag), residue is
        probed while sessions are still open, and every handle closes."""
        from .. import db as jdb
        from .. import oses

        test = self.test
        status: dict = {
            "suite": self.cfg.suite,
            "nodes": list(test.get("nodes") or []),
            "driver": (self.driver.status()
                       if self.driver is not None else None),
            "repair-on-start": self.repair_report,
            "daemon-restarts": telemetry.counter_value(
                "monitor.live.daemon-restarts"),
            "client-reconnects": telemetry.counter_value(
                "monitor.live.client-reconnects"),
        }
        try:
            try:
                jdb.teardown(test)
            except Exception as e:  # noqa: BLE001 — still probe residue
                log.warning("live teardown failed: %r", e)
                status["teardown-error"] = f"{type(e).__name__}: {e}"
            if self._led is not None:
                for tag in ("db-kill", "db-pause"):
                    self._led.heal_matching(tag=tag, by="db-teardown")
                status["residue"] = fault_ledger.probe_residue(
                    test, ledger=self._led)
                status["outstanding-at-exit"] = len(
                    self._led.outstanding())
            with contextlib.suppress(Exception):
                oses.teardown(test)
        finally:
            if self._hm is not None:
                with contextlib.suppress(Exception):
                    self._hm.stop()
            if self._led is not None:
                with contextlib.suppress(Exception):
                    self._led.close()
            self._stack.close()
        return status
