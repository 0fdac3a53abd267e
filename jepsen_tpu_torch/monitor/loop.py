"""`jepsen monitor`: the standing continuous-verification loop.

The port's copy of `jepsen_tpu/monitor/loop.py`.  What differs: the
rolling checker's frontiers run on `MonitorConfig.device` ("cuda" by
default), resolved before the first op, so a monitor that asks for the
card where there is none raises before it starts; a device fault (a
kernel that did not build or launch, a CUDA error: `ops.degrade.
is_device_fault`) in the checker ends the run after the summary is
written (with the fault named, and no verdicts), and is raised out of
`run_monitor`, never turned into an unknown epoch; the summary carries
the process's hand-kernel launch counts (`ops.kernels.launch_counts`).

The composition layer over:

  * a paced op source — either the in-process linearizable-by-
    construction keyed register workload (utils/histgen.py's
    pending-dict idiom, driven incrementally), or, with `--suite`, a
    pool of real suite clients against real daemons plus a live
    nemesis driver evolving in-run fault schedules (monitor/live.py);
  * a `RollingChecker` (monitor/rolling.py) holding memory constant
    via stable-prefix discards;
  * a `SeriesStore` + `Sampler` (telemetry/timeseries.py) persisting
    every gauge/counter/SLO state and per-pass profile medians on a
    fixed cadence;
  * the SLO engine evaluated each cadence with the quantile gauges
    (verdict-lag p95 instead of last-sample) and an `AlertRouter`
    turning transitions into sink deliveries;
  * an optional checkerd/router tee: each completed window of ops is
    also submitted to a daemon for an independent post-hoc verdict
    (best-effort, counted, never blocking the loop);
  * epoch restarts (a dead frontier after discard) write a forensics
    dossier under the store dir, so the alert that follows carries
    evidence.

Telemetry growth is bounded every cadence: the trace-event ring is
trimmed (spans keep their aggregate stats), the flight ring is already
a 512-deep deque, quantile rings and series stores are bounded deques
and rotated files — `monitor.resident-history-bytes` gauges what
remains so the memory ceiling is itself monitored.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import queue
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from .. import device as _device
from .. import telemetry
from ..history.core import Op
from ..models.registers import cas_register
from ..ops import degrade, kernels
from ..telemetry import flight, profile, slo, timeseries
from .alerts import AlertRouter
from .rolling import RollingChecker

log = logging.getLogger(__name__)

#: Directory under the store dir where epoch-restart dossiers land
#: (same root the alert router scans).
MONITOR_FORENSICS = "monitor"

SUMMARY_FILE = "monitor-summary.json"


@dataclass
class MonitorConfig:
    """Knobs for one monitor run (CLI flags map 1:1)."""

    store_dir: str
    device: str = "cuda"          # where the rolling checker runs
    rate: float = 1000.0          # target completed ops per second
    duration_s: float = 60.0      # 0 = run until stopped
    keys: int = 8
    procs_per_key: int = 4
    cadence_s: float = 5.0        # sample/evaluate/alert cadence
    seed: int = 45100
    info_rate: float = 0.0
    max_ops: Optional[int] = None
    # rolling checker
    bars_per_block: int = 64
    blocks_per_call: int = 4
    beam: int = 8
    advance_rows: int = 1024
    discard: bool = True
    # alerting
    sinks: tuple = ()
    dedup_s: float = 60.0
    renotify_s: float = 300.0
    #: fire a synthetic SLO for the first N seconds then clear it —
    #: the smoke's deterministic fire->alert->clear round trip.
    inject_slo_s: float = 0.0
    # integration
    endpoint: Optional[str] = None   # checkerd/router tee address
    tee_window_ops: int = 4096
    tenant: Optional[str] = None     # DRR identity on the tee SUBMIT
    tee_deadline_s: float = 120.0    # per-window verdict deadline
    serve_port: Optional[int] = None
    extra_rules: tuple = field(default_factory=tuple)
    # live (suite-backed) mode — monitor/live.py
    suite: Optional[str] = None      # kvdb|logd|electd|txnd|repkv
    nodes: tuple = ()                # override the suite's node list
    live_faults: tuple = ()          # fault families ("none" disables)
    search_dir: Optional[str] = None  # coverage-search checkpoint dir
    window_gap_s: float = 0.75       # quiet gap between fault windows
    live_seed_duration_s: float = 2.0
    supervise: bool = True           # restart daemons dead out-of-window


class _OpSource:
    """Incremental keyed register workload: linearizable by
    construction (each op's effect applies atomically at completion —
    histgen.random_register_history's pending-dict idiom, emitted one
    event at a time, forever)."""

    def __init__(self, keys: int, procs_per_key: int, seed: int,
                 info_rate: float):
        self.keys = keys
        self.procs = procs_per_key
        self.info_rate = info_rate
        self.rng = random.Random(seed)
        self.value: list[Optional[int]] = [None] * keys
        self.pending: list[dict] = [dict() for _ in range(keys)]
        self.index = 0
        self._key = 0

    def _emit(self, key: int, op_type: str, f: str, value: Any,
              p: int) -> tuple[int, Op]:
        self.index += 1
        return key, Op(
            type=op_type, f=f, value=value,
            process=key * self.procs + p, index=self.index,
        )

    def next_event(self) -> tuple[int, Op]:
        """One (key, op) event: an invocation or a completion."""
        rng = self.rng
        key = self._key
        self._key = (self._key + 1) % self.keys
        pending = self.pending[key]
        p = rng.randrange(self.procs)
        if p in pending:
            f, payload, as_info = pending.pop(p)
            value = self.value[key]
            if as_info:
                if f == "write" and rng.random() < 0.5:
                    self.value[key] = payload
                elif (f == "cas" and rng.random() < 0.5
                        and value == payload[0]):
                    self.value[key] = payload[1]
                return self._emit(key, "info", f, payload, p)
            if f == "read":
                return self._emit(key, "ok", "read", value, p)
            if f == "write":
                self.value[key] = payload
                return self._emit(key, "ok", "write", payload, p)
            if value == payload[0]:
                self.value[key] = payload[1]
                return self._emit(key, "ok", "cas", payload, p)
            return self._emit(key, "fail", "cas", payload, p)
        f = rng.choice(("read", "write", "cas"))
        if f == "read":
            payload: Any = None
        elif f == "write":
            payload = rng.randrange(5)
        else:
            payload = (rng.randrange(5), rng.randrange(5))
        as_info = f != "read" and rng.random() < self.info_rate
        pending[p] = (f, payload, as_info)
        return self._emit(key, "invoke", f, payload, p)


class _Tee:
    """Best-effort checkerd tee: windows of op dicts are submitted to
    a daemon/router for an independent post-hoc verdict.  A bounded
    queue + worker thread; a slow or dead daemon drops windows
    (counted), never stalls the monitor.

    Overload handling: an `F_SHED` from the daemon's admission path is
    *not* a daemon failure — treating it as one (the old behaviour)
    permanently degraded the tee to in-process checking, silently
    un-sharing the fleet.  Sheds now back off for the server-provided
    `retry-after-s` (bounded by MAX_SHED_WAIT_S) and retry while the
    window's deadline budget can still cover another attempt, counted
    under `monitor.shed.*`; only a truly unmeetable deadline drops the
    window."""

    def __init__(self, endpoint: str, keys: int, run_id: str,
                 tenant: Optional[str] = None,
                 deadline_s: float = 120.0):
        from ..checkerd.protocol import model_to_spec

        self.endpoint = endpoint
        self.keys = keys
        self.run_id = run_id
        self.tenant = tenant
        self.deadline_s = deadline_s
        self.spec = model_to_spec(cas_register()) or {}
        self.q: queue.Queue = queue.Queue(maxsize=4)
        self.windows: list[list[dict]] = [[] for _ in range(keys)]
        self.pending_events = 0
        self.n = 0
        self._thread = threading.Thread(
            target=self._work, name="monitor-tee", daemon=True
        )
        self._thread.start()

    def feed(self, key: int, op: Op) -> None:
        self.windows[key].append(op.to_dict())
        self.pending_events += 1

    def flush(self, window_ops: int) -> None:
        if self.pending_events < window_ops:
            return
        self.n += 1
        try:
            self.q.put_nowait((f"{self.run_id}-w{self.n}", self.windows))
            telemetry.count("monitor.tee-submitted")
        except queue.Full:
            telemetry.count("monitor.tee-dropped")
        self.windows = [[] for _ in range(self.keys)]
        self.pending_events = 0

    def _submit_once(self, run: str, windows: list,
                     budget_s: float) -> dict:
        from ..checkerd.client import CheckerdClient

        with CheckerdClient(self.endpoint) as c:
            ticket = c.submit_ops(run, self.spec, windows,
                                  tenant=self.tenant,
                                  deadline_s=self.deadline_s)
            return c.wait(ticket, deadline_s=budget_s)

    def _work(self) -> None:
        from ..checkerd.client import MAX_SHED_WAIT_S, ShedByServer

        while True:
            run, windows = self.q.get()
            deadline = time.monotonic() + self.deadline_s
            try:
                while True:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        telemetry.count("monitor.shed.deadline-unmet")
                        log.warning("monitor tee %s: window %s shed "
                                    "past its %.0fs deadline, dropped",
                                    self.endpoint, run, self.deadline_s)
                        break
                    try:
                        res = self._submit_once(run, windows, remaining)
                    except ShedByServer as e:
                        # Overload, not failure: honour the server's
                        # retry-after (bounded) and try again while
                        # the deadline budget allows.
                        wait = min(max(e.retry_after_s, 0.05),
                                   MAX_SHED_WAIT_S,
                                   deadline - time.monotonic())
                        if wait <= 0:
                            continue  # deadline check drops it
                        telemetry.count("monitor.shed.backoffs")
                        time.sleep(wait)
                        continue
                    valid = (res.get("result") or {}).get("valid")
                    telemetry.count(
                        "monitor.tee-valid" if valid is True
                        else "monitor.tee-nonvalid"
                    )
                    break
            except Exception as e:  # noqa: BLE001 — tee is best-effort
                telemetry.count("monitor.tee-errors")
                log.warning("monitor tee %s failed: %r",
                            self.endpoint, e)


def _atomic_json(path: str, doc: dict) -> None:
    """tmp + fsync + rename: readers (the web UI, `jepsen fleet`) see
    either the old document or the new one, never a torn tail."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, default=repr)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _write_dossier(store_dir: str, stem: str, doc: dict) -> Optional[str]:
    """One JSON dossier under the forensics root the alert router
    attaches evidence from."""
    from ..forensics import FORENSICS_DIR

    d = os.path.join(store_dir, FORENSICS_DIR, MONITOR_FORENSICS)
    path = os.path.join(d, f"{stem}.json")
    try:
        os.makedirs(d, exist_ok=True)
        _atomic_json(path, doc)
        return path
    except OSError as e:
        log.warning("monitor dossier write failed: %r", e)
        return None


def _write_epoch_dossier(store_dir: str, checker: RollingChecker,
                         n: int) -> Optional[str]:
    """A frontier death after discard has no post-hoc fallback; what
    it does have is evidence."""
    return _write_dossier(store_dir, f"epoch-restart-{n}", {
        "what": "monitor epoch restart",
        "why": "frontier died after history discard; the "
               "dying epoch's verdict is unknown",
        "t": time.time(),
        "checker": checker.status(),
        "flight": flight.status(),
    })


def run_monitor(cfg: MonitorConfig,
                stop: Optional[threading.Event] = None) -> dict:
    """Runs the monitor until `duration_s` elapses, `max_ops` complete,
    or `stop` is set.  Returns (and persists) a summary dict.  Raises
    `DeviceUnavailable` before anything starts when `cfg.device` is the
    card and there is none, and a device fault of the checker after the
    summary is written."""
    dev = _device.resolve(cfg.device)
    os.makedirs(cfg.store_dir, exist_ok=True)
    telemetry.enable()
    slo.set_dir(cfg.store_dir)
    flight.set_dir(cfg.store_dir)
    profile.set_store(cfg.store_dir)
    rules = list(slo.DEFAULT_RULES) + list(slo.MONITOR_RULES)
    if cfg.suite:
        rules += list(slo.LIVE_MONITOR_RULES)
    if cfg.tenant:
        rules += list(slo.TENANT_RULES)
    rules += list(cfg.extra_rules)
    if cfg.inject_slo_s > 0:
        rules.append(slo.Rule(
            "monitor-injected", "gauge-above", "monitor.injected", 0.5
        ))
    slo.reset(tuple(rules))

    store = timeseries.SeriesStore(cfg.store_dir)
    sampler = timeseries.Sampler(
        store, profile_path=profile.store_path()
    )
    router = AlertRouter(
        cfg.sinks, store_dir=cfg.store_dir,
        dedup_s=cfg.dedup_s, renotify_s=cfg.renotify_s,
    )
    pm = cas_register().packed()
    checker = RollingChecker(
        pm,
        bars_per_block=cfg.bars_per_block,
        blocks_per_call=cfg.blocks_per_call,
        beam=cfg.beam,
        advance_rows=cfg.advance_rows,
        discard=cfg.discard,
        device=dev,
    )
    # Graceful shutdown (live satellite, but useful everywhere): turn
    # SIGTERM/SIGINT into a stop-flag so the finally block drains
    # in-flight ops, heals open fault windows, flushes the series
    # store and alert router, and ticks a final verdict.
    if stop is None:
        stop = threading.Event()
    prev_handlers: dict = {}
    if threading.current_thread() is threading.main_thread():
        import signal as _signal

        def _graceful(signum: int, frame: Any) -> None:
            log.info("monitor: signal %d, draining gracefully", signum)
            telemetry.count("monitor.graceful-shutdowns")
            stop.set()

        for _sig in (_signal.SIGTERM, _signal.SIGINT):
            prev_handlers[_sig] = _signal.signal(_sig, _graceful)

    live = None
    if cfg.suite:
        from . import live as live_mod

        live = live_mod.LiveContext(cfg)
        try:
            source: Any = live.start(checker.status)
        except BaseException:
            import contextlib
            import signal as _signal

            with contextlib.suppress(Exception):
                live.finalize()
            for _sig, h in prev_handlers.items():
                _signal.signal(_sig, h)
            store.close()
            raise
    else:
        source = _OpSource(cfg.keys, cfg.procs_per_key, cfg.seed,
                           cfg.info_rate)
    tee = (_Tee(cfg.endpoint, cfg.keys, f"monitor-{os.getpid()}",
                tenant=cfg.tenant, deadline_s=cfg.tee_deadline_s)
           if cfg.endpoint else None)
    server = None
    if cfg.serve_port is not None:
        from .. import web

        server = web.make_server(cfg.store_dir, port=cfg.serve_port)
        threading.Thread(
            target=server.serve_forever, name="monitor-web", daemon=True
        ).start()
        log.info("monitor dashboard at http://127.0.0.1:%d/monitor",
                 server.server_address[1])

    t0 = time.monotonic()
    wall0 = time.time()
    deadline = t0 + cfg.duration_s if cfg.duration_s > 0 else None
    next_sample = t0 + cfg.cadence_s
    events = 0
    completed = 0
    epoch_dossiers = 0
    rate_window: collections.deque = collections.deque(maxlen=8)
    rate_window.append((t0, 0))
    ingest_window = collections.deque(maxlen=rate_window.maxlen)
    ingest_window.append((t0, telemetry.counter_value("ingest.append.ops")))
    burst = max(1, min(512, int(cfg.rate * cfg.cadence_s / 50) or 1))
    telemetry.count("monitor.runs")

    def cadence(now: float) -> None:
        nonlocal epoch_dossiers
        # --- gauges for this tick
        lag = checker.verdict_lag_s(now)
        telemetry.gauge("monitor.verdict-lag-s", lag)
        timeseries.observe("monitor.verdict-lag-s", lag)
        telemetry.gauge("monitor.resident-history-bytes",
                        checker.resident_bytes())
        telemetry.gauge("monitor.resident-rows", checker.resident_rows())
        telemetry.gauge("monitor.series-disk-bytes", store.disk_bytes())
        rate_window.append((now, completed))
        ingest_window.append(
            (now, telemetry.counter_value("ingest.append.ops")))
        (tA, cA), (tB, cB) = rate_window[0], rate_window[-1]
        if tB > tA:
            telemetry.gauge("monitor.ops-per-s",
                            round((cB - cA) / (tB - tA), 1))
        # Measured ingest throughput (ingest.append.ops delta over the
        # same rolling window): the PackedBuilder-side rate the
        # roofline/ingest work optimizes against.
        (tI, iA), (tJ, iB) = ingest_window[0], ingest_window[-1]
        if tJ > tI and iB > iA:
            telemetry.gauge("monitor.ingest-ops-per-s",
                            round((iB - iA) / (tJ - tI), 1))
        if cfg.inject_slo_s > 0:
            telemetry.gauge(
                "monitor.injected",
                1.0 if now - t0 <= cfg.inject_slo_s else 0.0,
            )
        # --- epoch restarts -> dossiers (evidence for the next alert)
        restarts = checker.status()["epoch-restarts"]
        while epoch_dossiers < restarts:
            epoch_dossiers += 1
            _write_epoch_dossier(cfg.store_dir, checker, epoch_dossiers)
        # --- bound trace-event growth (satellite: constant memory)
        mark = telemetry.event_mark()
        if mark:
            telemetry.trim_events(0)
            telemetry.count("monitor.events-trimmed", mark)
        # --- evaluate + alert + persist
        extras = timeseries.quantile_gauges()
        transitions = slo.evaluate(
            extra_gauges=extras, chip_state=degrade.chip_state()
        )
        # Each firing gets a forensics dossier *before* routing, so the
        # alert event that reaches the sink carries its evidence path.
        for tr in transitions:
            if tr.get("rec") == "firing":
                _write_dossier(
                    cfg.store_dir,
                    f"slo-{tr.get('rule')}-{int(now - t0)}s",
                    {
                        "what": "monitor SLO firing",
                        "transition": tr,
                        "t": time.time(),
                        "checker": checker.status(),
                        "gauges": extras,
                        "flight": flight.status(),
                    },
                )
        router.route(transitions)
        router.tick(slo.firing_gauges())
        sampler.sample(extra=extras)
        telemetry.count("monitor.samples")
        if tee is not None:
            tee.flush(cfg.tee_window_ops)

    #: A device fault of the checker: it ends the run, and no verdict
    #: is taken from the checker after it.
    fault: Optional[BaseException] = None
    raised = False
    try:
        while True:
            now = time.monotonic()
            if stop is not None and stop.is_set():
                break
            if deadline is not None and now >= deadline:
                break
            if cfg.max_ops is not None and completed >= cfg.max_ops:
                break
            # Drain the whole burst per key through the columnar ingest
            # (PackedBuilder.append_many) instead of per-op feeds.
            by_key: dict = {}
            for _ in range(burst):
                ev = source.next_event()
                if ev is None:
                    # Live pool produced nothing (wounded cluster);
                    # the blocking get already paced us.
                    break
                key, op = ev
                by_key.setdefault(key, []).append(op)
                if tee is not None:
                    tee.feed(key, op)
                events += 1
                if op.type != "invoke":
                    completed += 1
            t_feed = time.monotonic()
            for key, kops in by_key.items():
                checker.feed_many(key, kops, t_feed)
            # Pace: one completed op ~= two events.  Live mode paces at
            # the source (real clients, per-worker intervals), so only
            # the synthetic source sleeps here.
            target = t0 + events / (2.0 * cfg.rate)
            now = time.monotonic()
            if now >= next_sample:
                cadence(now)
                next_sample += cfg.cadence_s
            if live is None and now < target:
                time.sleep(min(target - now, 0.25))
    except BaseException as e:
        raised = True
        if degrade.is_device_fault(e):
            fault = e
        raise
    finally:
        if prev_handlers:
            import signal as _signal

            for _sig, h in prev_handlers.items():
                _signal.signal(_sig, h)
        if live is not None:
            # Graceful drain: stop the driver (healing any open fault
            # window), stop the supervisor, and feed the in-flight ops
            # the client pool still holds.
            leftovers = live.shutdown()
            if leftovers:
                by_key = {}
                for key, op in leftovers:
                    by_key.setdefault(key, []).append(op)
                    events += 1
                    if op.type != "invoke":
                        completed += 1
                if fault is None:
                    t_feed = time.monotonic()
                    try:
                        for key, kops in by_key.items():
                            checker.feed_many(key, kops, t_feed)
                    except Exception as e:
                        if not degrade.is_device_fault(e):
                            raise
                        fault = e
        now = time.monotonic()
        verdicts: dict = {}
        if fault is None:
            try:
                checker.pump(now)
                cadence(now)
                verdicts = checker.finish()
            except Exception as e:
                if not degrade.is_device_fault(e):
                    raise
                fault = e
        router.flush()
        status = checker.status()
        summary = {
            "ops": completed,
            "events": events,
            "duration_s": round(now - t0, 3),
            "rate_target": cfg.rate,
            "rate_measured": round(completed / max(1e-9, now - t0), 1),
            "started_at": wall0,
            "keys": cfg.keys,
            "discard": cfg.discard,
            "verdicts": {str(k): v for k, v in verdicts.items()},
            "ok_keys": sum(1 for v in verdicts.values() if v is True),
            "unknown_keys": sum(
                1 for v in verdicts.values() if v != True  # noqa: E712
            ),
            "checker": status,
            "verdict_lag_s": checker.verdict_lag_s(now),
            "series_disk_bytes": store.disk_bytes(),
            "alerts": router.status(),
            "slo": slo.status(),
            "launches": kernels.launch_counts(),
            "device": str(dev),
        }
        if fault is not None:
            summary["device_fault"] = f"{type(fault).__name__}: {fault}"
        if live is not None:
            try:
                summary["live"] = live.finalize()
            except Exception as e:  # noqa: BLE001 — summary must land
                log.warning("live finalize failed: %r", e)
                summary["live"] = {"error": f"{type(e).__name__}: {e}"}
        try:
            _atomic_json(os.path.join(cfg.store_dir, SUMMARY_FILE),
                         summary)
        except OSError as e:
            log.warning("monitor summary write failed: %r", e)
        store.close()
        if server is not None:
            server.shutdown()
        if fault is not None and not raised:
            raise fault
    return summary
