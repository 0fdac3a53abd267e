"""Flight recorder: a bounded ring of recent notable events, dumped to
``postmortem.json`` when something goes wrong.

The port's copy of `jepsen_tpu/telemetry/flight.py`; a dump has the
reference's shape, so either package's tools read the other's.

The ring is **always on** (unlike spans, which need JEPSEN_TELEMETRY):
the events it records — watchdog op timeouts, blown checker budgets,
degradation-ladder steps, chip probes/resets, run crashes — are rare
by construction, so `note()` costs one deque append regardless of
telemetry state.  When a trigger fires, `dump(reason)` snapshots the
ring plus the telemetry counters and top spans into the run's store
dir; a postmortem is then readable even when the process that wrote it
is gone.

Triggers in the port:
  * check_safe's checker budget blows
  * checkerd marks a request budget-exceeded
  * the WGL degradation ladder records a step
  * an SLO rule starts firing (telemetry/slo.py)
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
from typing import Any, Optional

from . import summary, top_spans

log = logging.getLogger(__name__)

#: Ring capacity: triggers are rare events, not per-op traffic, so a
#: few hundred entries cover the interesting tail of any run.
MAX_EVENTS = 512

POSTMORTEM_FILE = "postmortem.json"

_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=MAX_EVENTS)
_dir: Optional[str] = None
_dumps = 0


def set_dir(directory: Optional[str]) -> None:
    """Points postmortem dumps at `directory` (the run's store dir)."""
    global _dir
    with _lock:
        _dir = directory


def reset() -> None:
    """Clears the ring (start of a run scope)."""
    global _dumps
    with _lock:
        _ring.clear()
        _dumps = 0


def note(kind: str, **fields: Any) -> None:
    """Records one event in the ring.  Always on; never raises."""
    try:
        ev = {"t": time.time(), "kind": kind}
        if fields:
            ev.update(fields)
        with _lock:
            _ring.append(ev)
    except Exception:  # noqa: BLE001
        pass


def events() -> list[dict]:
    with _lock:
        return [dict(e) for e in _ring]


def dump_count() -> int:
    with _lock:
        return _dumps


def status() -> dict:
    """{events, dumps, dir} — bench.py embeds this in its JSON line."""
    with _lock:
        return {"events": len(_ring), "dumps": _dumps, "dir": _dir}


def dump(reason: str, directory: Optional[str] = None) -> Optional[str]:
    """Writes postmortem.json (ring + counters + top spans) into
    `directory` (default: the configured dir).  Returns the path, or
    None when no dir is set or the write fails — a postmortem must
    never change the outcome it documents."""
    global _dumps
    with _lock:
        d = directory or _dir
        ring = [dict(e) for e in _ring]
    if not d:
        return None
    try:
        snap = {
            "reason": reason,
            "dumped_at": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
            "events": ring,
            "counters": summary().get("counters", {}),
            "top_spans": [
                {"name": n, **st} for n, st in top_spans(8)
            ],
        }
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, POSTMORTEM_FILE)
        with open(path, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True, default=repr)
            f.write("\n")
        with _lock:
            _dumps += 1
        log.info("flight recorder: postmortem (%s) -> %s", reason, path)
        return path
    except OSError as e:
        log.warning("flight recorder dump failed: %r", e)
        return None
