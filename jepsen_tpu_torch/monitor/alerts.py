"""Alert routing: SLO transitions become actions.

The port's copy of `jepsen_tpu/monitor/alerts.py` (host code: events,
sinks and routing as the reference's, so either package's sink file
reads the same).

The SLO engine (telemetry/slo.py) turns registry state into
firing/cleared transitions; this module turns transitions into
*deliveries* against operator-configured sinks:

    file:/path/alerts.jsonl      append one JSON line per event
    webhook:http://host/hook     POST the event as JSON
    exec:/path/script            run the script, event JSON on stdin

Routing discipline (the part a pager cares about):

  * **dedup** — a rule that re-fires within `dedup_s` of its last
    delivered firing (flapping) is suppressed and counted
    (`alert.deduped`), so one incident pages once;
  * **re-notify** — a rule still firing `renotify_s` after its last
    delivery is re-delivered with ``"renotify": true``, so a
    long-burning incident is not forgotten after the first page;
  * **evidence attach** — every firing event carries the newest
    forensics dossier under the store dir and the flight-recorder
    postmortem that `slo.evaluate()` dumped at fire time, so the page
    links straight to the evidence;
  * sink failures are counted (`alert.sink-errors`), never raised —
    alerting must not take down the thing it watches.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import subprocess
import time
import urllib.request
from typing import Any, Optional

from .. import telemetry
from ..forensics import FORENSICS_DIR
from ..telemetry.flight import POSTMORTEM_FILE

log = logging.getLogger(__name__)

#: Suppress re-fires of the same rule within this window.
DEDUP_S = 60.0

#: Re-deliver a still-firing rule after this long.
RENOTIFY_S = 300.0

_SINK_SCHEMES = ("file:", "webhook:", "exec:")


def _newest_under(root: str, limit: int = 2000) -> Optional[str]:
    """Newest-mtime file under `root` (bounded walk), or None."""
    best: Optional[tuple[float, str]] = None
    seen = 0
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            seen += 1
            if seen > limit:
                return best[1] if best else None
            p = os.path.join(dirpath, fn)
            try:
                m = os.path.getmtime(p)
            except OSError:
                continue
            if best is None or m > best[0]:
                best = (m, p)
    return best[1] if best else None


class AlertRouter:
    """Delivers SLO transitions to configured sinks with dedup and
    re-notify semantics."""

    def __init__(
        self,
        sinks: Any = (),
        *,
        store_dir: Optional[str] = None,
        dedup_s: float = DEDUP_S,
        renotify_s: float = RENOTIFY_S,
    ):
        self.sinks: list[str] = []
        self.store_dir = store_dir
        self.dedup_s = dedup_s
        self.renotify_s = renotify_s
        #: rule -> {"firing": bool, "last_delivery": t, "fires": n}
        self._state: dict[str, dict] = {}
        for spec in sinks or ():
            if isinstance(spec, str) and spec.startswith(_SINK_SCHEMES):
                self.sinks.append(spec)
            else:
                telemetry.count("alert.bad-sink")
                log.warning("ignoring unrecognized alert sink %r", spec)

    # -- evidence -----------------------------------------------------------

    def _evidence(self) -> dict:
        out: dict[str, Optional[str]] = {"dossier": None,
                                         "postmortem": None}
        d = self.store_dir
        if not d:
            return out
        froot = os.path.join(d, FORENSICS_DIR)
        if os.path.isdir(froot):
            out["dossier"] = _newest_under(froot)
        pm = os.path.join(d, POSTMORTEM_FILE)
        if os.path.exists(pm):
            out["postmortem"] = pm
        return out

    # -- delivery -----------------------------------------------------------

    def _deliver(self, event: dict) -> None:
        data = json.dumps(event, sort_keys=True, default=repr)
        delivered = 0
        for spec in self.sinks:
            try:
                if spec.startswith("file:"):
                    path = spec[len("file:"):]
                    os.makedirs(os.path.dirname(path) or ".",
                                exist_ok=True)
                    with open(path, "a") as f:
                        f.write(data + "\n")
                elif spec.startswith("webhook:"):
                    url = spec[len("webhook:"):]
                    req = urllib.request.Request(
                        url,
                        data=data.encode(),
                        headers={"Content-Type": "application/json"},
                    )
                    urllib.request.urlopen(req, timeout=5.0).close()
                else:  # exec:
                    subprocess.run(
                        [spec[len("exec:"):]],
                        input=data.encode(),
                        timeout=15.0,
                        check=False,
                        stdout=subprocess.DEVNULL,
                        stderr=subprocess.DEVNULL,
                    )
                delivered += 1
            except Exception as e:  # noqa: BLE001 — never raise
                telemetry.count("alert.sink-errors")
                log.warning("alert sink %s failed: %r", spec, e)
        if delivered:
            telemetry.count("alert.delivered", delivered)

    def _event(self, transition: dict, **extra: Any) -> dict:
        ev = dict(transition)
        ev["host"] = socket.gethostname()
        ev.update(self._evidence() if transition.get("rec") == "firing"
                  else {})
        ev.update(extra)
        return ev

    # -- API ----------------------------------------------------------------

    def route(self, transitions: Any,
              now: Optional[float] = None) -> int:
        """Routes one evaluation sweep's transitions; returns the
        number of events delivered to sinks."""
        if now is None:
            now = time.time()
        sent = 0
        for tr in transitions or ():
            rule = tr.get("rule")
            rec = tr.get("rec")
            if not rule or rec not in ("firing", "cleared"):
                continue
            st = self._state.setdefault(
                rule, {"firing": False, "last_delivery": None, "fires": 0}
            )
            if rec == "firing":
                st["firing"] = True
                st["fires"] += 1
                last = st["last_delivery"]
                if last is not None and now - last < self.dedup_s:
                    telemetry.count("alert.deduped")
                    continue
                telemetry.count("alert.fired")
                self._deliver(self._event(tr))
                st["last_delivery"] = now
                sent += 1
            else:
                st["firing"] = False
                if st["last_delivery"] is None:
                    continue  # never paged: nothing to resolve
                telemetry.count("alert.cleared")
                self._deliver(self._event(tr))
                sent += 1
        return sent

    def tick(self, firing: Any, now: Optional[float] = None) -> int:
        """Re-notify sweep: `firing` is slo.firing_gauges() ({rule:
        0|1}); rules still firing `renotify_s` past their last delivery
        are re-delivered."""
        if now is None:
            now = time.time()
        sent = 0
        for rule, on in (firing or {}).items():
            if not on:
                continue
            st = self._state.get(rule)
            if (st is None or not st["firing"]
                    or st["last_delivery"] is None):
                continue
            if now - st["last_delivery"] < self.renotify_s:
                continue
            telemetry.count("alert.renotified")
            self._deliver(self._event(
                {"rec": "firing", "rule": rule, "t": now},
                renotify=True,
            ))
            st["last_delivery"] = now
            sent += 1
        return sent

    def flush(self, reason: str = "shutdown",
              now: Optional[float] = None) -> int:
        """Final delivery on graceful shutdown: every rule still firing
        gets one closing ``"rec": "shutdown"`` event so the pager knows
        the watcher (not the incident) went away.  Sinks that already
        saw a clear deliver nothing."""
        if now is None:
            now = time.time()
        sent = 0
        for rule, st in self._state.items():
            if not st["firing"] or st["last_delivery"] is None:
                continue
            self._deliver(self._event(
                {"rec": "shutdown", "rule": rule, "t": now},
                reason=reason,
            ))
            sent += 1
        if sent:
            telemetry.count("alert.flushed", sent)
        return sent

    def status(self) -> dict:
        return {
            "sinks": list(self.sinks),
            "rules": {
                rule: {"firing": st["firing"], "fires": st["fires"]}
                for rule, st in self._state.items()
            },
        }
