"""Declarative SLO rules over the telemetry registry.

The port's copy of `jepsen_tpu/telemetry/slo.py` (the rules, the
engine, the `slo.jsonl` journal, whose records either package reads,
and the firing gauges, with every rule set the reference's monitors
add).  A small set of declarative threshold/burn-rate rules evaluated
against the live registry (gauge
last-values, counter deltas, surface-local extras like checkerd queue
depth, and the chip-health state) on every telemetry flush and on every
/metrics scrape.

Rule kinds:

  * ``gauge-above`` / ``gauge-below`` — the gauge's last sample crossed
    a threshold (verdict lag, queue depth, merge ratio);
  * ``counter-above`` — a monotone counter's absolute value crossed a
    threshold (quarantined nodes);
  * ``counter-rate-above`` — burn rate: the counter's increase per
    second since the previous evaluation exceeds the threshold
    (op-timeout rate);
  * ``chip-unhealthy`` — the degrade ladder reports a bad chip state
    (wedged / absent).

A rule *fires* after ``for_count`` consecutive breaching evaluations
(hysteresis against one-sample blips) and *clears* on the first clean
one.  Both transitions append a record to a crash-safe ``slo.jsonl``
(one open-append-fsync-close per line, torn tails skipped on read —
the profile-store contract), firing additionally notes into the flight
recorder and dumps a postmortem, so every blown SLO ships the ring
that led up to it.  Current state exports as
``jepsen_slo_firing{rule=...}`` 0/1 gauges via ``prometheus_text()``.

Missing inputs are never breaches: a rule whose gauge has no sample
has no opinion, so an idle process scrapes all-zeros rather than
firing vacuously.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

from . import _gauges, _counters, _lock as _reg_lock
from . import count as _count
from . import flight

log = logging.getLogger(__name__)

#: File name of the SLO transition journal inside a store/run dir.
SLO_FILE = "slo.jsonl"

_KINDS = (
    "gauge-above", "gauge-below", "counter-above", "counter-rate-above",
    "chip-unhealthy",
)


@dataclass(frozen=True)
class Rule:
    """One declarative alert rule.

    - name:      stable identifier; the `rule` label on the exported
                 gauge and the key in slo.jsonl records.
    - kind:      one of `_KINDS`.
    - target:    gauge/counter name the rule reads (resolved against
                 surface extras first, then the registry); unused for
                 chip-unhealthy.
    - threshold: the boundary value (rate rules: per second).
    - for_count: consecutive breaching evaluations before firing.
    """

    name: str
    kind: str
    target: str = ""
    threshold: float = 0.0
    for_count: int = 1

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown SLO rule kind {self.kind!r}")


#: The stock rule set over the gauges/counters the subsystems already
#: emit.  Replace or extend with `reset(rules=...)`.
DEFAULT_RULES: tuple[Rule, ...] = (
    # Online checking: the verdict must land promptly after the last op
    # (streaming/pipeline.py gauges the measured lag at finish()).
    Rule("verdict-lag", "gauge-above", "wgl.online.verdict-lag-s", 30.0),
    # Checkerd pool health: a deep queue means runs are waiting on the
    # daemon; a near-zero merge ratio under load means cohort merging —
    # the whole point of the shared pool — stopped happening.
    Rule("checkerd-queue-depth", "gauge-above", "checkerd.queue-depth",
         32.0, for_count=2),
    Rule("checkerd-merge-ratio", "gauge-below", "checkerd.merge-ratio",
         0.01, for_count=3),
    # Cluster health: any quarantined node is an alert; op timeouts
    # above a trickle mean the workload is burning its watchdogs.
    Rule("quarantined-nodes", "counter-above", "node.quarantined", 0.0),
    Rule("op-timeout-rate", "counter-rate-above",
         "interpreter.op-timeouts", 0.5, for_count=2),
    # Accelerator health straight from the degrade ladder.
    Rule("chip-health", "chip-unhealthy"),
)

#: Rules a standing monitor layers on top of the defaults.  The p95
#: rule thresholds on the quantile gauges the
#: time-series rings export (telemetry/timeseries.quantile_gauges(),
#: passed as evaluation extras) instead of a single last-sample gauge
#: — one slow verdict no longer pages; a shifted distribution does.
#: The drift rule watches the plan cost model's predictions against
#: measured pass costs (monitor.cost-drift-ratio, a rolling median of
#: measured/predicted) and fires when retraining is due.
MONITOR_RULES: tuple[Rule, ...] = (
    Rule("monitor-verdict-lag", "gauge-above", "monitor.verdict-lag-s",
         60.0, for_count=2),
    Rule("verdict-lag-p95", "gauge-above",
         "wgl.online.verdict-lag-s.p95", 30.0),
    Rule("cost-drift", "gauge-above", "monitor.cost-drift-ratio",
         3.0, for_count=3),
    # Overload control plane: a sustained shed rate means the fleet is
    # saturated past the point graceful degradation can absorb —
    # capacity or weights need attention, not just patience (the
    # brownout ladder and deadline shedding are already doing their
    # jobs when this fires).
    Rule("checkerd-shed-rate", "counter-rate-above",
         "checkerd.overload.shed", 1.0, for_count=3),
)

#: Rules the live (suite-backed) monitor adds when a real cluster is
#: under watch.  Daemon restarts outside fault windows at a sustained
#: rate mean the target is crash-looping on its own; client
#: reconnect-storms mean the op stream is mostly backoff; a fault
#: window left outstanding for consecutive cadences means a heal
#: failed and residue is accumulating on a live machine.
LIVE_MONITOR_RULES: tuple[Rule, ...] = (
    Rule("live-daemon-restart-rate", "counter-rate-above",
         "monitor.live.daemon-restarts", 0.2, for_count=2),
    Rule("live-reconnect-rate", "counter-rate-above",
         "monitor.live.client-reconnects", 5.0, for_count=3),
    Rule("live-unhealed-window", "gauge-above",
         "monitor.live.outstanding", 0.5, for_count=3),
)

#: Per-tenant rules a fleet member (`jepsen monitor --tenant`) adds:
#: each tenant's monitor evaluates these against its *own* counters
#: into its *own* slo.jsonl, so one tenant's shed storm or epoch
#: churn alerts that tenant's sinks without paging the fleet.  A
#: sustained shed-backoff rate means the tenant's DRR share can't
#: cover its offered load (weight or deadline needs attention); a
#: deadline-unmet means verification work was actually dropped;
#: epoch restarts at a sustained rate mean the rolling checker keeps
#: losing its prefix-discard invariant.
TENANT_RULES: tuple[Rule, ...] = (
    Rule("tenant-shed-backoff-rate", "counter-rate-above",
         "monitor.shed.backoffs", 2.0, for_count=3),
    Rule("tenant-shed-deadline-unmet", "counter-above",
         "monitor.shed.deadline-unmet", 0.0),
    Rule("tenant-epoch-restart-rate", "counter-rate-above",
         "monitor.epoch-restarts", 0.1, for_count=3),
)


class SLOEngine:
    """Evaluates a rule set against registry snapshots and journals
    firing/cleared transitions.  One module-level default instance
    serves the process (like the flight recorder); tests build their
    own."""

    def __init__(self, rules: Optional[tuple] = None,
                 directory: Optional[str] = None):
        self._lock = threading.Lock()
        self.rules: tuple[Rule, ...] = tuple(rules if rules is not None
                                             else DEFAULT_RULES)
        self._dir = directory
        # name -> {"firing", "breaches", "since", "value",
        #          "prev_counter", "prev_t"}
        self._state: dict[str, dict] = {r.name: self._fresh()
                                        for r in self.rules}

    @staticmethod
    def _fresh() -> dict:
        return {"firing": False, "breaches": 0, "since": None,
                "value": None, "prev_counter": None, "prev_t": None}

    def set_dir(self, directory: Optional[str]) -> None:
        with self._lock:
            self._dir = directory

    def set_rules(self, rules: tuple) -> None:
        with self._lock:
            self.rules = tuple(rules)
            self._state = {r.name: self._fresh() for r in self.rules}

    # -- evaluation -----------------------------------------------------

    def _value(self, rule: Rule, gauges: dict, counters: dict,
               extras: dict, chip_state: Optional[str],
               st: dict, now: float):
        """(observed value, breached | None).  None = no opinion (the
        input is absent), never a breach."""
        if rule.kind == "chip-unhealthy":
            if chip_state is None:
                return None, None
            return chip_state, chip_state in ("wedged", "absent")
        if rule.kind in ("gauge-above", "gauge-below"):
            v = extras.get(rule.target, gauges.get(rule.target))
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                return None, None
            if rule.kind == "gauge-above":
                return v, v > rule.threshold
            return v, v < rule.threshold
        v = extras.get(rule.target, counters.get(rule.target))
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            return None, None
        if rule.kind == "counter-above":
            return v, v > rule.threshold
        # counter-rate-above: needs two samples to have an opinion.
        prev_v, prev_t = st["prev_counter"], st["prev_t"]
        st["prev_counter"], st["prev_t"] = v, now
        if prev_v is None or prev_t is None or now <= prev_t:
            return None, None
        rate = max(0.0, (v - prev_v)) / (now - prev_t)
        return round(rate, 6), rate > rule.threshold

    def evaluate(self, extra_gauges: Optional[dict] = None,
                 chip_state: Optional[str] = None,
                 now: Optional[float] = None) -> list[dict]:
        """One evaluation sweep; returns the transition records
        appended (empty when nothing changed state).  Never raises:
        alerting must not change the outcome of the thing it watches."""
        now = time.time() if now is None else now
        extras = dict(extra_gauges or {})
        with _reg_lock:
            gauges = {k: g[0] for k, g in _gauges.items()}
            counters = dict(_counters)
        transitions: list[dict] = []
        with self._lock:
            for rule in self.rules:
                st = self._state[rule.name]
                try:
                    value, breached = self._value(
                        rule, gauges, counters, extras, chip_state,
                        st, now)
                except Exception:  # noqa: BLE001 — one bad rule only
                    log.warning("SLO rule %s evaluation failed",
                                rule.name, exc_info=True)
                    continue
                st["value"] = value
                if breached:
                    st["breaches"] += 1
                    if (not st["firing"]
                            and st["breaches"] >= rule.for_count):
                        st["firing"] = True
                        st["since"] = now
                        transitions.append(self._transition(
                            "firing", rule, value, now))
                else:
                    st["breaches"] = 0
                    if st["firing"]:
                        st["firing"] = False
                        st["since"] = None
                        transitions.append(self._transition(
                            "cleared", rule, value, now))
            path = self._path()
        for rec in transitions:
            self._append(path, rec)
            if rec["rec"] == "firing":
                _count("slo.fired")
                flight.note("slo-firing", rule=rec["rule"],
                            value=rec["value"],
                            threshold=rec["threshold"])
                # The postmortem: the flight ring as of the moment the
                # SLO blew, dumped next to the journal.
                flight.dump(f"slo-{rec['rule']}")
            else:
                _count("slo.cleared")
                flight.note("slo-cleared", rule=rec["rule"],
                            value=rec["value"])
        if transitions:
            _count("slo.transitions", len(transitions))
        return transitions

    @staticmethod
    def _transition(rec: str, rule: Rule, value: Any,
                    now: float) -> dict:
        return {
            "rec": rec,
            "rule": rule.name,
            "kind": rule.kind,
            "target": rule.target,
            "threshold": rule.threshold,
            "value": value,
            "t": now,
        }

    def _path(self) -> Optional[str]:
        return (os.path.join(self._dir, SLO_FILE)
                if self._dir else None)

    @staticmethod
    def _append(path: Optional[str], rec: dict) -> None:
        """Crash-safe single-line append: a SIGKILL mid-write loses at
        most this line, and `read` skips the torn tail."""
        if path is None:
            return
        try:
            line = json.dumps(rec, sort_keys=True, default=repr)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "a") as f:
                f.write(line + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:
            log.warning("slo journal append to %s failed: %r", path, e)

    # -- views ----------------------------------------------------------

    def firing_gauges(self) -> dict[str, int]:
        """{rule: 0|1} over EVERY configured rule, so the exported
        family is always complete and a cleared rule scrapes as 0."""
        with self._lock:
            return {r.name: int(self._state[r.name]["firing"])
                    for r in self.rules}

    def status(self) -> list[dict]:
        """Per-rule detail for the web panel."""
        with self._lock:
            out = []
            for r in self.rules:
                st = self._state[r.name]
                out.append({
                    "rule": r.name,
                    "kind": r.kind,
                    "target": r.target,
                    "threshold": r.threshold,
                    "firing": st["firing"],
                    "since": st["since"],
                    "value": st["value"],
                })
            return out


def read(path: str) -> list[dict]:
    """Every intact transition record in an slo.jsonl; torn or garbage
    lines (crash mid-append) are skipped, not fatal."""
    out: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and rec.get("rec"):
                    out.append(rec)
    except OSError:
        pass
    return out


# ---------------------------------------------------------------------------
# Module-level default engine (the flight-recorder pattern)
# ---------------------------------------------------------------------------

_engine = SLOEngine()


def set_dir(directory: Optional[str]) -> None:
    """Points the default engine's journal at <directory>/slo.jsonl
    (None detaches it)."""
    _engine.set_dir(directory)


def reset(rules: Optional[tuple] = None) -> None:
    """Clears all rule state; optionally installs a new rule set."""
    _engine.set_rules(tuple(rules if rules is not None
                            else DEFAULT_RULES))


def evaluate(extra_gauges: Optional[dict] = None,
             chip_state: Optional[str] = None,
             now: Optional[float] = None) -> list[dict]:
    return _engine.evaluate(extra_gauges, chip_state, now)


def firing_gauges() -> dict[str, int]:
    return _engine.firing_gauges()


def status() -> list[dict]:
    return _engine.status()


def slo_path(directory: str) -> str:
    return os.path.join(directory, SLO_FILE)
