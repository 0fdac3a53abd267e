"""Run-scoped telemetry: spans, counters, gauges, Chrome-trace export.

The port's copy of `jepsen_tpu/telemetry/__init__.py`, trimmed to what
the checking paths and the plan layer read.  A process-wide,
thread-safe registry of

  * **spans** — `with span("wgl.witness"):` timed sections, aggregated
    per name (count / total / max) and appended to a bounded
    trace-event buffer;
  * **counters** — accumulated values (`count("wgl.plan.compile")`);
  * **gauges** — last/min/max samples (`gauge("wgl.witness.beam", B)`).

Everything is off by default: set ``JEPSEN_TELEMETRY=1`` (or call
`enable()`) to record.  When disabled, `span()` returns one shared
no-op context manager and `count`/`gauge` return after one module bool
check, so the checking paths pay next to nothing.

`export(dir)` writes ``telemetry.json`` (the `summary()` dict) and
``trace.json`` (Chrome trace-event format, "X" complete events in
microseconds, loadable in Perfetto or chrome://tracing).

Span names are dotted ``subsystem.phase``, the reference's: ``wgl.*``
(the witness, its plan, the stream, the online frontier), ``ingest.*``
(the packed builder), ``checker.<Name>`` (`check_safe`).  Counters
``wgl.plan.*`` count the plan layer, ``wgl.settle.*`` the keys each
many-key tier decided, ``wgl.degrade.<tier>.<action>`` the degradation
steps.  `device.counters` (host syncs, chain rounds, ...) stays the
port's own always-on record beside this one.

The cross-process event transport (`event_mark`, `events_between`,
`trim_events`, `adopt_remote_events`) ships the checker daemon's
cohort spans back to each submitter, whose trace shows them under the
daemon's pid.  `export` evaluates the SLO rules (telemetry/slo.py)
before it writes, and `prometheus_text` renders the registry, the
time-series quantiles (telemetry/timeseries.py) and the SLO firing
gauges in Prometheus text format for the daemon's `/metrics`.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
import uuid
from typing import Any, Callable, Optional

log = logging.getLogger(__name__)

ENV_VAR = "JEPSEN_TELEMETRY"

#: Trace-event buffer cap: aggregated span stats keep counting past it;
#: only the per-event trace detail is dropped (and reported in
#: `summary()["trace_events_dropped"]`).
MAX_TRACE_EVENTS = 200_000

_enabled = os.environ.get(ENV_VAR, "") not in ("", "0", "false", "no")
_lock = threading.Lock()

#: perf_counter origin of the trace timestamps, and the wall clock at
#: that instant, so trace times can be related to log lines.
_T0_NS = time.perf_counter_ns()
_T0_WALL = time.time()

# name -> [count, total_ns, max_ns]
_span_stats: dict[str, list] = {}
_counters: dict[str, Any] = {}
# name -> [last, min, max, n_samples]
_gauges: dict[str, list] = {}
# (name, t0_ns_rel, dur_ns, tid, thread_name, attrs-or-None)
_events: list[tuple] = []
_events_dropped = 0

#: Events adopted from other processes (a checker daemon's RESULT
#: meta["spans"]), so a run's trace shows daemon-side work under the
#: daemon's pid.  Wall-clock timestamped dicts, bounded.
MAX_FOREIGN_EVENTS = 4096
_foreign: list[dict] = []

#: The run's trace context: its trace id, minted lazily (`trace_id`) or
#: adopted (`seed_trace`), which profile records carry, and the span
#: propagated work nests under.
_trace_id: Optional[str] = None
_parent_span: Optional[str] = None

#: Per-thread span-exit hook: profile.capture() installs a callback
#: `(span_name, dur_ns) -> None` that folds execute-span durations into
#: the active pass record.
_pass_hook = threading.local()


def enabled() -> bool:
    return _enabled


def enable(on: bool = True) -> None:
    """Programmatic override of JEPSEN_TELEMETRY (tests, embedding)."""
    global _enabled
    _enabled = bool(on)


def reset() -> None:
    """Clears every registry — the start of a run scope."""
    global _events_dropped, _trace_id, _parent_span
    with _lock:
        _span_stats.clear()
        _counters.clear()
        _gauges.clear()
        _events.clear()
        _foreign.clear()
        _events_dropped = 0
        _trace_id = None
        _parent_span = None


#: Counter prefixes whose values outlive a single run: the online
#: path, the plan route and the daemon accumulate across many core.run
#: scopes.  `scoped_reset` keeps these.
FLEET_COUNTER_PREFIXES = (
    "nemesis.search.",
    "wgl.online.",
    "wgl.plan.",
    "checkerd.",
    "router.",
    "ingest.",
    "chaos.",
)


def scoped_reset(prefix_keep: tuple = FLEET_COUNTER_PREFIXES) -> None:
    """`reset()` that keeps the counters under `prefix_keep` — the start
    of a run's scope (core.run) in a process that outlives it."""
    global _events_dropped, _trace_id, _parent_span
    with _lock:
        kept = {k: v for k, v in _counters.items()
                if any(k.startswith(p) for p in prefix_keep)}
        _span_stats.clear()
        _counters.clear()
        _counters.update(kept)
        _gauges.clear()
        _events.clear()
        _foreign.clear()
        _events_dropped = 0
        _trace_id = None
        _parent_span = None


# ---------------------------------------------------------------------------
# Trace context
# ---------------------------------------------------------------------------


def new_span_id() -> str:
    """A fresh 16-hex id (span ids and trace ids)."""
    return uuid.uuid4().hex[:16]


def trace_id() -> str:
    """The current trace id, minted lazily per run scope."""
    global _trace_id
    with _lock:
        if _trace_id is None:
            _trace_id = new_span_id()
        return _trace_id


def trace_context() -> dict:
    """The propagatable context ``{"trace-id", "parent-span"}``: a
    checker daemon client sends it in SUBMIT, and the daemon stamps the
    request's cohort spans with it."""
    return {"trace-id": trace_id(), "parent-span": _parent_span}


def seed_trace(ctx: Optional[dict]) -> None:
    """Adopts a propagated trace context ({"trace-id", "parent-span"})
    or, when `ctx` is falsy or malformed, mints a fresh id."""
    global _trace_id, _parent_span
    tid = psp = None
    if isinstance(ctx, dict):
        tid = ctx.get("trace-id") or ctx.get("trace_id")
        psp = ctx.get("parent-span") or ctx.get("parent_span")
    with _lock:
        _trace_id = str(tid) if tid else new_span_id()
        _parent_span = str(psp) if psp else None


def set_parent_span(span_id: Optional[str]) -> None:
    """Sets the span id that work propagated from here nests under
    (core.analyze sets its analyze span's id)."""
    global _parent_span
    _parent_span = span_id


def set_pass_hook(cb: Optional[Callable[[str, int], None]]) -> None:
    """Installs (or clears, with None) this thread's span-exit hook."""
    _pass_hook.cb = cb


class _NoopSpan:
    """Shared do-nothing span for the disabled path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


_NOOP = _NoopSpan()


class Span:
    __slots__ = ("name", "attrs", "_t0")

    def __init__(self, name: str, attrs: Optional[dict]):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs: Any) -> None:
        """Attaches attributes mid-span."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> bool:
        global _events_dropped
        t0 = self._t0
        dur = time.perf_counter_ns() - t0
        t = threading.current_thread()
        with _lock:
            st = _span_stats.get(self.name)
            if st is None:
                _span_stats[self.name] = [1, dur, dur]
            else:
                st[0] += 1
                st[1] += dur
                if dur > st[2]:
                    st[2] = dur
            if len(_events) < MAX_TRACE_EVENTS:
                _events.append((self.name, t0 - _T0_NS, dur, t.ident,
                                t.name, self.attrs))
            else:
                _events_dropped += 1
        cb = getattr(_pass_hook, "cb", None)
        if cb is not None:
            try:
                cb(self.name, dur)
            except Exception:  # noqa: BLE001 — profiling must not change
                # a pass's outcome; a dead hook only loses cost records
                log.debug("span-exit hook failed for %s", self.name,
                          exc_info=True)
        return False


def span(name: str, **attrs: Any) -> Any:
    """Context manager timing a named section.  Disabled -> the shared
    no-op."""
    if not _enabled:
        return _NOOP
    return Span(name, attrs or None)


def count(name: str, n: Any = 1) -> None:
    """Adds `n` to a named counter."""
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counter_value(name: str) -> float:
    """The current value of one named counter (0 when absent)."""
    with _lock:
        v = _counters.get(name, 0)
    return float(v) if isinstance(v, (int, float)) else 0.0


def gauge(name: str, value: Any) -> None:
    """Samples a named gauge, tracking last/min/max."""
    if not _enabled:
        return
    with _lock:
        g = _gauges.get(name)
        if g is None:
            _gauges[name] = [value, value, value, 1]
        else:
            g[0] = value
            if value < g[1]:
                g[1] = value
            if value > g[2]:
                g[2] = value
            g[3] += 1


def summary() -> dict:
    """The aggregate view exported as telemetry.json."""
    with _lock:
        spans = {
            name: {
                "count": c,
                "total_s": round(t / 1e9, 6),
                "max_s": round(m / 1e9, 6),
                "mean_s": round(t / c / 1e9, 6),
            }
            for name, (c, t, m) in _span_stats.items()
        }
        return {
            "enabled": _enabled,
            "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime()),
            "trace_id": _trace_id,
            "spans": spans,
            "counters": dict(_counters),
            "gauges": {
                name: {"last": g[0], "min": g[1], "max": g[2],
                       "samples": g[3]}
                for name, g in _gauges.items()
            },
            "trace_events": len(_events),
            "trace_events_dropped": _events_dropped,
        }


def top_spans(n: int = 5) -> list[tuple[str, dict]]:
    """The n spans with the largest total time, descending."""
    s = summary()["spans"]
    return sorted(s.items(), key=lambda kv: kv[1]["total_s"],
                  reverse=True)[:n]


def phases(prefix: str) -> dict[str, float]:
    """{short-name: total_s} of every span under `prefix.`."""
    pre = prefix + "."
    return {
        name[len(pre):]: st["total_s"]
        for name, st in summary()["spans"].items()
        if name.startswith(pre)
    }


#: Counter families recording robustness events: the checking paths'
#: degradation steps (`wgl.degrade.<tier>.<action>`) and blown checker
#: budgets; a run's watchdog op timeouts and drain stragglers, fault
#: ledger events (nemesis.*), node health (node.*), transport flapping
#: (net.*) and client open failures.
RESILIENCE_COUNTER_PREFIXES = (
    "interpreter.op-timeouts",
    "interpreter.drain-timeouts",
    "checker.budget-exceeded",
    "wgl.degrade.",
    "nemesis.",
    "node.",
    "net.",
    "client.open.",
)


def resilience_counters() -> dict[str, Any]:
    """The counters that record degradation/retry/timeout events."""
    with _lock:
        items = dict(_counters)
    return {k: v for k, v in sorted(items.items())
            if any(k.startswith(p) for p in RESILIENCE_COUNTER_PREFIXES)}


#: Tier-population counters of the many-key settling ladder: how many
#: keys each tier decided (wgl.settle.{online-proven, stream-proven,
#: screen-refuted, batched-proven, batched-refuted, cpu-settled,
#: memo-hit}).
SETTLE_COUNTER_PREFIX = "wgl.settle."


def settle_counters() -> dict[str, Any]:
    """The wgl.settle.* counters (empty when telemetry is disabled or
    no many-key check ran)."""
    with _lock:
        items = dict(_counters)
    return {k: v for k, v in sorted(items.items())
            if k.startswith(SETTLE_COUNTER_PREFIX)}


# ---------------------------------------------------------------------------
# Cross-process span transport
# ---------------------------------------------------------------------------


def event_mark() -> int:
    """An opaque cursor into the trace-event buffer; pass it to
    `events_between` to capture the events recorded since."""
    with _lock:
        return len(_events)


def events_between(mark: int, limit: int = 256) -> list[dict]:
    """The events appended since `mark`, as JSON-able dicts with
    wall-clock timestamps — the payload checkerd attaches to RESULT
    meta["spans"] so clients can adopt daemon-side work into their own
    traces.  Bounded to `limit`; newest events win (the interesting
    spans — cohort, settle tiers — close last)."""
    with _lock:
        evs = _events[mark:]
    out = []
    for name, t0_rel, dur, tid, tname, attrs in evs[-limit:]:
        ev: dict[str, Any] = {
            "name": name,
            "t0_unix_s": _T0_WALL + t0_rel / 1e9,
            "dur_s": dur / 1e9,
            "tid": tid,
            "thread": tname,
        }
        if attrs:
            ev["attrs"] = dict(attrs)
        out.append(ev)
    return out


def trim_events(mark: int) -> None:
    """Truncates the trace-event buffer back to `mark` — a long-lived
    daemon captures each cohort's events then trims, so the 200k cap
    never saturates across weeks of uptime."""
    global _events_dropped
    with _lock:
        if 0 <= mark <= len(_events):
            del _events[mark:]
            _events_dropped = 0


def adopt_remote_events(events: Any, pid: Any = None) -> None:
    """Adopts span events captured in another process (see
    `events_between`) into this run's trace.  They render under their
    own pid in `chrome_trace()`, timestamp-rebased via wall clock."""
    if not _enabled or not isinstance(events, list):
        return
    with _lock:
        room = MAX_FOREIGN_EVENTS - len(_foreign)
        for ev in events[:max(0, room)]:
            if not isinstance(ev, dict) or "name" not in ev:
                continue
            e = dict(ev)
            if pid is not None:
                e.setdefault("pid", pid)
            _foreign.append(e)


def foreign_events() -> list[dict]:
    """The adopted cross-process events (copies)."""
    with _lock:
        return [dict(e) for e in _foreign]


def chrome_trace() -> dict:
    """The recorded spans as a Chrome trace-event dict ("X" complete
    events, µs timestamps) — Perfetto / chrome://tracing loadable.
    Adopted remote events (checkerd daemon spans) appear under their
    own pid, rebased onto this process's clock via wall time."""
    with _lock:
        events = list(_events)
        foreign = [dict(e) for e in _foreign]
        tid_ = _trace_id
    pid = os.getpid()
    out = []
    tnames: dict[int, str] = {}
    for name, t0_rel, dur, tid, tname, attrs in events:
        ev: dict[str, Any] = {
            "name": name,
            "cat": name.split(".", 1)[0],
            "ph": "X",
            "ts": t0_rel / 1000.0,
            "dur": dur / 1000.0,
            "pid": pid,
            "tid": tid,
        }
        if attrs:
            ev["args"] = attrs
        out.append(ev)
        tnames[tid] = tname
    for tid, tname in tnames.items():
        out.append({
            "name": "thread_name",
            "ph": "M",
            "pid": pid,
            "tid": tid,
            "args": {"name": tname},
        })
    fpids: dict[Any, bool] = {}
    for ev in foreign:
        try:
            ts_us = (float(ev["t0_unix_s"]) - _T0_WALL) * 1e6
            dur_us = float(ev.get("dur_s", 0.0)) * 1e6
        except (KeyError, TypeError, ValueError):
            continue
        fpid = ev.get("pid", 0)
        e: dict[str, Any] = {
            "name": ev["name"],
            "cat": str(ev["name"]).split(".", 1)[0],
            "ph": "X",
            "ts": ts_us,
            "dur": dur_us,
            "pid": fpid,
            "tid": ev.get("tid", 0),
        }
        if ev.get("attrs"):
            e["args"] = ev["attrs"]
        out.append(e)
        fpids[fpid] = True
    for fpid in fpids:
        out.append({
            "name": "process_name",
            "ph": "M",
            "pid": fpid,
            "tid": 0,
            "args": {"name": f"checkerd[{fpid}]"},
        })
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "jepsen_tpu_torch.telemetry",
            "t0_unix_s": _T0_WALL,
            "trace_id": tid_,
        },
    }


def export(directory: str) -> Optional[tuple[str, str]]:
    """Writes telemetry.json + trace.json into `directory`; returns the
    two paths, or None when disabled or on a write failure (a side
    output must never change a run's outcome)."""
    if not _enabled:
        return None
    # The flush is the SLO engine's heartbeat: every export re-evaluates
    # the declarative rules over the registry (telemetry/slo.py), so a
    # blown SLO journals its transition and dumps a postmortem even in
    # processes that never serve /metrics.
    try:
        from . import slo as _slo

        _slo.evaluate()
    except Exception:  # noqa: BLE001 — alerting never breaks the flush
        log.warning("slo evaluation on export failed", exc_info=True)
    try:
        os.makedirs(directory, exist_ok=True)
        sum_path = os.path.join(directory, "telemetry.json")
        trace_path = os.path.join(directory, "trace.json")
        with open(sum_path, "w") as f:
            json.dump(summary(), f, indent=2, sort_keys=True,
                      default=repr)
            f.write("\n")
        with open(trace_path, "w") as f:
            json.dump(chrome_trace(), f, default=repr)
            f.write("\n")
        return sum_path, trace_path
    except OSError as e:
        log.warning("telemetry export to %s failed: %r", directory, e)
        return None


# ---------------------------------------------------------------------------
# Prometheus scrape surface
# ---------------------------------------------------------------------------

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")

#: The chip-health states the degrade ladder can report; rendered
#: one-hot so a scrape always sees the full state space.
CHIP_HEALTH_STATES = (
    "unprobed", "ok", "wedged", "ok-after-reset", "absent",
)


def log_top_spans(logger: logging.Logger, n: int = 5) -> None:
    """INFO-logs the top-n spans by total time (a run's summary line)."""
    if not _enabled:
        return
    tops = top_spans(n)
    if tops:
        logger.info("telemetry top spans: %s", "; ".join(
            f"{name} {st['total_s']:.3f}s x{st['count']}"
            for name, st in tops))


def _prom_name(name: str) -> str:
    return "jepsen_" + _PROM_BAD.sub("_", name)


def prometheus_text(
    extra_gauges: Optional[dict] = None,
    chip_state: Optional[str] = None,
    lint_findings: Optional[dict] = None,
    slo_firing: Optional[dict] = None,
    extra_labeled: Optional[dict] = None,
) -> str:
    """The registry rendered in Prometheus text exposition format:
    counters as `counter`, gauge last-values and span totals/counts as
    `gauge`.  `extra_gauges` ({name: number}) lets a server mix in
    surface-local values (queue depth, utilization); `chip_state`
    renders the one-hot `jepsen_chip_health{state=...}` family;
    `lint_findings` ({severity: count} or {family: {severity: count}})
    renders `jepsen_lint_findings{...}` gauges;
    `slo_firing` ({rule: 0|1}) renders the
    `jepsen_slo_firing{rule=...}` family — when omitted, the default
    SLO engine's current state (telemetry/slo.py) is exported, so every
    scrape surface alerts for free;
    `extra_labeled` ({family: (label_name, {label_value: number},
    "counter"|"gauge")}) renders single-label families like
    `jepsen_checkerd_shed_total{tenant=...}` — counters get the
    `_total` suffix appended here, so pass the bare family name."""
    with _lock:
        counters = dict(_counters)
        gauges = {k: g[0] for k, g in _gauges.items()}
        spans = {k: (c, t) for k, (c, t, _m) in _span_stats.items()}
    lines: list[str] = []
    for name in sorted(counters):
        v = counters[name]
        if not isinstance(v, (int, float)):
            continue
        pn = _prom_name(name) + "_total"
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {v}")
    for name in sorted(gauges):
        v = gauges[name]
        if not isinstance(v, (int, float)):
            continue
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {v}")
    if spans:
        lines.append("# TYPE jepsen_span_seconds_total counter")
        lines.append("# TYPE jepsen_span_count_total counter")
        for name in sorted(spans):
            c, t = spans[name]
            lines.append(
                f'jepsen_span_seconds_total{{span="{name}"}} {t / 1e9:.6f}'
            )
            lines.append(f'jepsen_span_count_total{{span="{name}"}} {c}')
    for name in sorted(extra_gauges or {}):
        v = (extra_gauges or {})[name]
        if not isinstance(v, (int, float)):
            continue
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {v}")
    # Histogram-style quantile export (Prometheus summary families)
    # from the in-process time-series rings: one `<name>_dist` family
    # per observed series (the `_dist` suffix keeps the family distinct
    # from the same series' last-sample gauge), e.g.
    # jepsen_wgl_online_verdict_lag_s_dist{quantile="0.95"} — so
    # dashboards and SLO rules see the recent distribution instead of
    # a single sample.  Empty until something observes.
    try:
        from . import timeseries as _ts

        _qmap = {"p50": "0.5", "p95": "0.95", "p99": "0.99"}
        for sname in _ts.ring_names():
            qs = _ts.quantiles(sname)
            if not qs:
                continue
            pn = _prom_name(sname) + "_dist"
            lines.append(f"# TYPE {pn} summary")
            for label in ("p50", "p95", "p99"):
                if label in qs:
                    lines.append(
                        f'{pn}{{quantile="{_qmap[label]}"}} {qs[label]}'
                    )
    except Exception:  # noqa: BLE001 — scrape must render regardless
        pass
    if lint_findings:
        lines.append("# TYPE jepsen_lint_findings gauge")
        for key in sorted(lint_findings):
            v = lint_findings[key]
            if isinstance(v, dict):
                # {family: {severity: count}} from summary["families"].
                for sev in sorted(v):
                    n = v[sev]
                    if not isinstance(n, (int, float)):
                        continue
                    lines.append(
                        f'jepsen_lint_findings{{family="{key}",'
                        f'severity="{sev}"}} {n}')
                continue
            if not isinstance(v, (int, float)):
                continue
            lines.append(
                f'jepsen_lint_findings{{severity="{key}"}} {v}')
    if chip_state is not None:
        lines.append("# TYPE jepsen_chip_health gauge")
        known = chip_state in CHIP_HEALTH_STATES
        for st in CHIP_HEALTH_STATES:
            hot = 1 if st == chip_state or (
                st == "unprobed" and not known) else 0
            lines.append(f'jepsen_chip_health{{state="{st}"}} {hot}')
    if slo_firing is None:
        try:
            from . import slo as _slo

            slo_firing = _slo.firing_gauges()
        except Exception:  # noqa: BLE001 — scrape must render regardless
            slo_firing = None
    if slo_firing:
        lines.append("# TYPE jepsen_slo_firing gauge")
        for rule in sorted(slo_firing):
            v = slo_firing[rule]
            if not isinstance(v, (int, float)):
                continue
            lines.append(
                f'jepsen_slo_firing{{rule="{rule}"}} {int(bool(v))}')
    for family in sorted(extra_labeled or {}):
        try:
            label, values, ptype = (extra_labeled or {})[family]
        except (TypeError, ValueError):
            continue
        if ptype not in ("counter", "gauge") or not isinstance(
                values, dict):
            continue
        pn = _prom_name(family) + ("_total" if ptype == "counter" else "")
        lines.append(f"# TYPE {pn} {ptype}")
        for lv in sorted(values, key=str):
            v = values[lv]
            if not isinstance(v, (int, float)):
                continue
            lines.append(f'{pn}{{{label}="{lv}"}} {v}')
    return "\n".join(lines) + "\n"
