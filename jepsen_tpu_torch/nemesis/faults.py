"""Faults that act on nodes through the control plane.

The port's copy of `jepsen_tpu/nemesis/faults.py`.

Equivalents of the process/clock/file faults in
jepsen/src/jepsen/nemesis.clj and nemesis/time.clj:
DB kill/pause via the DB protocol (nemesis/combined.clj:72-100),
`node_start_stopper` (nemesis.clj:453-496), `hammer_time`
SIGSTOP/SIGCONT (nemesis.clj:498-512), clock bump/strobe/reset with a
C helper compiled on the node (nemesis/time.clj:21-40, :104-167),
`truncate_file` (nemesis.clj:514-548), and `bitflip` (nemesis.clj:550-597,
reimplemented with dd+xxd instead of a downloaded Go binary).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Optional, Sequence

from .. import telemetry
from ..control import Session, health, on_nodes
from ..history import Op
from ..utils import with_retry
from . import ledger as fault_ledger
from .core import Nemesis, _rng

log = logging.getLogger(__name__)

RESOURCE_DIR = os.path.join(os.path.dirname(__file__), "..", "resources")


def _pick_nodes(test: dict, spec: Any) -> list:
    """Node selection spec: None = all, int = that many random, list =
    exactly those, callable = filter (nemesis.clj:453-467).  Quarantined
    nodes are out of the draw — faulting a corpse is wasted fault budget
    and would muddy the health timeline — and the ledger records the
    skip so a post-mortem reader knows why the fault's footprint
    shrank."""
    all_nodes = list(test.get("nodes") or [])
    nodes = [n for n in all_nodes if not health.is_quarantined(test, n)]
    skipped = [n for n in all_nodes if n not in nodes]
    if skipped:
        telemetry.count("nemesis.skip.quarantined", len(skipped))
        fault_ledger.note(
            test, why="quarantined-skip", nodes=list(skipped)
        )
    if spec is None:
        return nodes
    if isinstance(spec, int):
        _rng().shuffle(nodes)
        return nodes[:spec]
    if callable(spec):
        return [n for n in nodes if spec(n)]
    return [n for n in spec if n in nodes]


class DBNemesis(Nemesis):
    """Kills/pauses the DB via its Kill/Pause capabilities
    (nemesis/combined.clj:72-100).  fs: kill/start/pause/resume; op
    value selects nodes (see _pick_nodes)."""

    def invoke(self, test: dict, op: Op) -> Op:
        db = test["db"]
        nodes = _pick_nodes(test, op.value)
        method = {
            "kill": "kill",
            "start": "start",
            "pause": "pause",
            "resume": "resume",
        }[op.f]

        if method == "kill":
            fault_ledger.intent(
                test, "process", nodes=[str(n) for n in nodes],
                params={"f": "kill"},
                compensator={"type": "db-start",
                             "nodes": [str(n) for n in nodes]},
                tag="db-kill",
            )
        elif method == "pause":
            fault_ledger.intent(
                test, "process", nodes=[str(n) for n in nodes],
                params={"f": "pause"},
                compensator={"type": "db-resume",
                             "nodes": [str(n) for n in nodes]},
                tag="db-pause",
            )
        elif fault_ledger.heal_guard():
            return op.replace(value="heal abandoned")

        def act(sess: Session, node: str):
            getattr(db, method)(test, sess, node)
            return "done"

        res = on_nodes(test, act, nodes)
        if method == "start":
            fault_ledger.healed(test, tag="db-kill")
        elif method == "resume":
            fault_ledger.healed(test, tag="db-pause")
        return op.replace(value=res)

    def fs(self) -> set:
        return {"kill", "start", "pause", "resume"}


class HammerTime(Nemesis):
    """SIGSTOP/SIGCONT a process by name (nemesis.clj:498-512)."""

    def __init__(self, process_name: str):
        self.process_name = process_name

    def invoke(self, test: dict, op: Op) -> Op:
        sig = {"start": "STOP", "stop": "CONT"}[op.f]
        nodes = _pick_nodes(test, op.value)
        if sig == "STOP":
            fault_ledger.intent(
                test, "process", nodes=[str(n) for n in nodes],
                params={"process": self.process_name, "signal": "STOP"},
                compensator={"type": "sigcont",
                             "process": self.process_name,
                             "nodes": [str(n) for n in nodes]},
                tag="hammer",
            )
        elif fault_ledger.heal_guard():
            return op.replace(value="heal abandoned")

        def act(sess: Session, node: str):
            with sess.su():
                sess.exec_star("pkill", f"-{sig}", "-f", self.process_name)
            return f"SIG{sig}"

        res = on_nodes(test, act, nodes)
        if sig == "CONT":
            fault_ledger.healed(test, tag="hammer")
        return op.replace(value=res)

    def fs(self) -> set:
        return {"start", "stop"}


def node_start_stopper(
    targeter: Callable[[dict, list], Sequence[str]],
    start: Callable[[dict, Session, str], Any],
    stop: Callable[[dict, Session, str], Any],
) -> Nemesis:
    """Generic start/stop fault over targeted nodes
    (nemesis.clj:453-496): `start` breaks a node, `stop` heals it; the
    nemesis remembers which nodes it broke."""

    class StartStopper(Nemesis):
        def __init__(self) -> None:
            self.affected: list = []

        def invoke(self, test: dict, op: Op) -> Op:
            if op.f == "start":
                nodes = list(targeter(test, health.eligible_nodes(test)))
                # The heal is an arbitrary closure — not data-describable,
                # so repair can only report it, not replay it.
                fault_ledger.intent(
                    test, "process", nodes=[str(n) for n in nodes],
                    params={"f": "start"},
                    compensator={
                        "type": "unreplayable",
                        "note": "node_start_stopper closure; re-run its "
                                "stop by hand",
                    },
                    tag="start-stopper",
                )
                res = on_nodes(
                    test, lambda s, n: start(test, s, n), nodes
                )
                self.affected = nodes
                return op.replace(value=res)
            elif op.f == "stop":
                if fault_ledger.heal_guard():
                    return op.replace(value="heal abandoned")
                nodes = self.affected or list(test.get("nodes") or [])
                res = on_nodes(test, lambda s, n: stop(test, s, n), nodes)
                self.affected = []
                fault_ledger.healed(test, tag="start-stopper")
                return op.replace(value=res)
            raise ValueError(f"unknown f {op.f!r}")

        def fs(self) -> set:
            return {"start", "stop"}

    return StartStopper()


# ---------------------------------------------------------------------------
# Clock faults (nemesis/time.clj)
# ---------------------------------------------------------------------------

BUILD_DIR = "/opt/jepsen-tpu"


class ClockNemesis(Nemesis):
    """Bumps, strobes, and resets node wall clocks.  At setup, uploads
    and gcc-compiles the C helpers on every node (nemesis/time.clj:21-67)
    and stops NTP.  fs: bump/strobe/reset/check-offsets.

    Op values: bump {node: delta_ms} or delta_ms for all; strobe
    {"delta": ms, "period": ms, "duration": ms} (+optional "nodes").

    Like the reference (nemesis/time.clj:104-167), every bump/strobe/
    reset completion carries a {"clock-offsets": {node: secs}} map of
    node-clock-minus-control-clock offsets, which ClockPlot graphs."""

    def setup(self, test: dict) -> "ClockNemesis":
        def install(sess: Session, node: str):
            with sess.su():
                sess.exec("mkdir", "-p", BUILD_DIR)
                for src in ("bump-time.c", "strobe-time.c"):
                    local = os.path.join(RESOURCE_DIR, src)
                    sess.upload(local, f"{BUILD_DIR}/{src}")
                    binary = src[:-2]
                    sess.exec(
                        "gcc", "-O2", "-o", f"{BUILD_DIR}/{binary}",
                        f"{BUILD_DIR}/{src}",
                    )
                # Stop time daemons fighting us (time.clj:69-102).
                sess.exec_star("systemctl", "stop", "ntp", "chronyd",
                               "systemd-timesyncd")
            return "ok"

        on_nodes(test, install)
        return self

    def _offsets(self, test: dict, nodes=None) -> dict:
        """Node wall-clock minus control wall-clock, in seconds, per node
        (the reference's current-offset, nemesis/time.clj:104-130)."""
        import time as _time

        def offset(sess: Session, node: str):
            remote = sess.exec("date", "+%s.%N")
            try:
                return float(remote) - _time.time()
            except (TypeError, ValueError):
                return None  # dummy remotes return empty output

        return on_nodes(test, offset, nodes)

    def invoke(self, test: dict, op: Op) -> Op:
        if op.f == "bump":
            spec = op.value
            if not isinstance(spec, dict):
                spec = {n: spec for n in test.get("nodes") or []}

            def bump(sess: Session, node: str):
                # Single positional arg: bump-time parses argv[1] with
                # atoll, so a "--" separator would silently read as 0
                # (exec() passes argv directly — no option parsing, so
                # negative deltas are safe without it).
                delta = spec[node]
                with sess.su():
                    sess.exec(f"{BUILD_DIR}/bump-time", str(delta))
                return delta

            nodes = list(spec.keys())
            fault_ledger.intent(
                test, "clock", nodes=[str(n) for n in nodes],
                params={"f": "bump",
                        "deltas_ms": {str(n): spec[n] for n in nodes}},
                compensator={"type": "clock-reset",
                             "nodes": [str(n) for n in nodes]},
            )
            res = on_nodes(test, bump, nodes)
            return op.replace(value={
                "bumped": res,
                "clock-offsets": self._offsets(test, nodes),
            })
        if op.f == "strobe":
            v = op.value or {}
            nodes = _pick_nodes(test, v.get("nodes"))

            def strobe(sess: Session, node: str):
                with sess.su():
                    sess.exec(
                        f"{BUILD_DIR}/strobe-time",
                        str(v.get("delta", 200)),
                        str(v.get("period", 10)),
                        str(v.get("duration", 1000)),
                    )
                return "strobed"

            fault_ledger.intent(
                test, "clock", nodes=[str(n) for n in nodes],
                params={"f": "strobe", "delta": v.get("delta", 200),
                        "period": v.get("period", 10),
                        "duration": v.get("duration", 1000)},
                compensator={"type": "clock-reset",
                             "nodes": [str(n) for n in nodes]},
            )
            res = on_nodes(test, strobe, nodes)
            return op.replace(value={
                "strobed": res,
                "clock-offsets": self._offsets(test, nodes),
            })
        if op.f == "reset":
            if fault_ledger.heal_guard():
                return op.replace(value="heal abandoned")
            nodes = _pick_nodes(test, op.value)

            def reset(sess: Session, node: str):
                with sess.su():
                    sess.exec("ntpdate", "-b", "pool.ntp.org")
                return "reset"

            res = on_nodes(test, reset, nodes)
            fault_ledger.healed(test, fault="clock")
            return op.replace(value={
                "reset": res,
                "clock-offsets": self._offsets(test, nodes),
            })
        if op.f == "check-offsets":
            return op.replace(
                value={"clock-offsets": self._offsets(test)}
            )
        raise ValueError(f"unknown clock f {op.f!r}")

    def teardown(self, test: dict) -> None:
        # Per-node, best-effort, retried: one unreachable node cannot
        # abort resetting the rest, and a failed reset is stranded clock
        # skew — warn loudly and leave its ledger entries outstanding
        # for `jepsen repair` / the residue sweep.
        if fault_ledger.heal_guard():
            return

        def reset_node(sess: Session) -> None:
            with sess.su():
                sess.exec_star("ntpdate", "-b", "pool.ntp.org")
                # Restart the time daemons setup stopped.
                sess.exec_star("systemctl", "start", "ntp", "chronyd",
                               "systemd-timesyncd")

        failed: list = []
        for node, sess in (test.get("sessions") or {}).items():
            try:
                with_retry(
                    lambda s=sess: reset_node(s),
                    retries=2, backoff_ms=100.0,
                )
            except Exception as e:  # noqa: BLE001 — continue to siblings
                log.warning(
                    "clock reset failed on %s during teardown: %r", node, e
                )
                failed.append(node)
        if failed:
            log.warning(
                "clock skew may be stranded on %s — ledger entries left "
                "outstanding for `jepsen repair`", failed,
            )
        else:
            fault_ledger.healed(test, fault="clock", by="teardown")

    def fs(self) -> set:
        return {"bump", "strobe", "reset", "check-offsets"}


class ClockScrambler(ClockNemesis):
    """The classic coarse clock fault (nemesis.clj:436-451): on
    f="start", bumps every node's clock by an independent uniformly
    random offset within ±dt seconds; f="stop" resets clocks via NTP.
    Inherits ClockNemesis's helper compilation, offset reporting, and
    teardown."""

    def __init__(self, dt_secs: float):
        self.dt_secs = dt_secs

    def invoke(self, test: dict, op: Op) -> Op:
        from .core import _rng

        if op.f == "start":
            dt_ms = int(self.dt_secs * 1000)
            spec = {
                n: _rng().randint(-dt_ms, dt_ms)
                for n in test.get("nodes") or []
            }
            return super().invoke(test, op.replace(f="bump", value=spec)
                                  ).replace(f="start")
        if op.f == "stop":
            return super().invoke(test, op.replace(f="reset", value=None)
                                  ).replace(f="stop")
        raise ValueError(f"unknown clock-scrambler f {op.f!r}")

    def fs(self) -> set:
        return {"start", "stop"}


def clock_scrambler(dt_secs: float) -> ClockScrambler:
    return ClockScrambler(dt_secs)


# ---------------------------------------------------------------------------
# Disk faults
# ---------------------------------------------------------------------------


class TruncateFile(Nemesis):
    """Chops bytes off the end of a file (nemesis.clj:514-548).  Op value:
    {node: {"file": path, "drop": bytes}} or a single spec for all."""

    def invoke(self, test: dict, op: Op) -> Op:
        spec = op.value
        if not isinstance(spec, dict) or "file" in spec:
            spec = {n: spec for n in test.get("nodes") or []}
        fault_ledger.intent(
            test, "file", nodes=[str(n) for n in spec],
            params={"f": "truncate",
                    "files": sorted({str(s.get("file")) for s in
                                     spec.values() if isinstance(s, dict)})},
            compensator={
                "type": "unreplayable",
                "note": "file truncation is unrecoverable — restore the "
                        "file from backup or reprovision the node",
            },
            tag="truncate",
        )

        def trunc(sess: Session, node: str):
            s = spec[node]
            drop = int(s.get("drop", 1))
            path = s["file"]
            with sess.su():
                sess.exec(
                    "truncate", "-c", "-s", f"-{drop}", path
                )
            return {"truncated": path, "drop": drop}

        return op.replace(value=on_nodes(test, trunc, list(spec.keys())))

    def fs(self) -> set:
        return {"truncate"}


class Bitflip(Nemesis):
    """Flips a bit in a file (nemesis.clj:550-597; the reference
    downloads a Go binary — here: dd read, flip in shell, dd write).
    Op value: {node: {"file": path, "probability": p}} or one spec."""

    def invoke(self, test: dict, op: Op) -> Op:
        spec = op.value
        if not isinstance(spec, dict) or "file" in spec:
            spec = {n: spec for n in test.get("nodes") or []}
        fault_ledger.intent(
            test, "file", nodes=[str(n) for n in spec],
            params={"f": "bitflip",
                    "files": sorted({str(s.get("file")) for s in
                                     spec.values() if isinstance(s, dict)})},
            compensator={
                "type": "unreplayable",
                "note": "bitflip corruption is unrecoverable — restore the "
                        "file from backup or reprovision the node",
            },
            tag="bitflip",
        )

        def flip(sess: Session, node: str):
            s = spec[node]
            path = s["file"]
            with sess.su():
                size = int(sess.exec("stat", "-c", "%s", path) or "0")
                if size == 0:
                    return {"flipped": 0}
                offset = _rng().randrange(size)
                bit = 1 << _rng().randrange(8)
                script = (
                    f"b=$(dd if={path} bs=1 skip={offset} count=1 "
                    f"2>/dev/null | od -An -tu1 | tr -d ' '); "
                    f"printf \"\\\\$(printf '%03o' $((b ^ {bit})))\" | "
                    f"dd of={path} bs=1 seek={offset} count=1 "
                    f"conv=notrunc 2>/dev/null"
                )
                sess.exec("bash", "-c", script)
                return {"flipped": 1, "offset": offset, "bit": bit}

        return op.replace(value=on_nodes(test, flip, list(spec.keys())))

    def fs(self) -> set:
        return {"bitflip"}
