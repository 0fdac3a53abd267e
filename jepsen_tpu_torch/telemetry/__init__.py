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

Left out of the copy: the SLO and time-series hooks of `export`, the
cross-process event transport (checkerd spans) and `prometheus_text`;
they come with the checker daemon and the monitor.
"""

from __future__ import annotations

import json
import logging
import os
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

#: The run's trace id, minted lazily (`trace_id`) or adopted
#: (`seed_trace`); profile records carry it.
_trace_id: Optional[str] = None

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
    global _events_dropped, _trace_id
    with _lock:
        _span_stats.clear()
        _counters.clear()
        _gauges.clear()
        _events.clear()
        _events_dropped = 0
        _trace_id = None


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


def seed_trace(ctx: Optional[dict]) -> None:
    """Adopts a propagated trace context ({"trace-id": ...}) or, when
    `ctx` is falsy or malformed, mints a fresh id."""
    global _trace_id
    tid = None
    if isinstance(ctx, dict):
        tid = ctx.get("trace-id") or ctx.get("trace_id")
    with _lock:
        _trace_id = str(tid) if tid else new_span_id()


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


#: Counter families recording robustness events; the port's checking
#: paths emit the degradation steps (`wgl.degrade.<tier>.<action>`) and
#: blown checker budgets.
RESILIENCE_COUNTER_PREFIXES = (
    "checker.budget-exceeded",
    "wgl.degrade.",
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


def chrome_trace() -> dict:
    """The recorded spans as a Chrome trace-event dict ("X" complete
    events, microsecond timestamps, a thread_name record per thread)."""
    with _lock:
        events = list(_events)
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
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": tname}})
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
    output never changes a run's outcome)."""
    if not _enabled:
        return None
    try:
        os.makedirs(directory, exist_ok=True)
        sum_path = os.path.join(directory, "telemetry.json")
        trace_path = os.path.join(directory, "trace.json")
        with open(sum_path, "w") as f:
            json.dump(summary(), f, indent=2, sort_keys=True, default=repr)
            f.write("\n")
        with open(trace_path, "w") as f:
            json.dump(chrome_trace(), f, default=repr)
            f.write("\n")
        return sum_path, trace_path
    except OSError as e:
        log.warning("telemetry export to %s failed: %r", directory, e)
        return None
