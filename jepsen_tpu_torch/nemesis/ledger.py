"""Durable fault ledger: crash-safe journal of live faults + repair.

The port's copy of `jepsen_tpu/nemesis/ledger.py` (no JAX there either).

A run always terminates with a verdict; this module guarantees the
*cluster* can always be put back the way we found it.  Every fault-injecting nemesis action journals a declarative
**intent** record — fault family, target nodes, parameters, and a
data-described *compensator* (heal the net, ``tc qdisc del``, clock
reset + time-daemon restart, daemon restart) — into the run's store dir
**before** touching the cluster, and a **healed** record after its
compensator completes.  Records ride the store's append+fsync block
discipline (`store.format.BlockWriter`, block type `BLOCK_LEDGER`), so
a control-process crash at any instant leaves a readable ledger whose
outstanding entries are exactly the faults still live on the nodes —
the same host-side journaled-side-effect split DrJAX argues for: device
(here: cluster) mutations are described declaratively on the host and
replayable without the process that created them.

Recovery: `core.repair(test_dir)` (CLI: ``jepsen repair``) loads a
crashed run's ledger, reopens sessions, replays outstanding
compensators newest-first, appends healed records for the ones that
succeed, and finishes with `probe_residue` — a per-node sweep of
iptables/blackhole-route/tc/clock state that emits
``nemesis.residue.*`` telemetry counters (surfaced in the checker
results' ``resilience`` block).

Fault hook (mirrors ops/degrade.py's JEPSEN_WGL_FAULT): the
``JEPSEN_NEMESIS_FAULT`` env var names failure sites, comma-separated:

  * ``inject``  — raise after the intent record lands but before the
    cluster is touched (a session dropped mid-inject);
  * ``heal``    — raise at the start of any heal path (a crash
    mid-heal: the fault stays live, the entry stays outstanding);
  * ``repair``  — raise inside `run_compensator` during repair, so a
    repair pass reports that entry failed;
  * ``abandon`` — heal paths silently skip (no compensator, no healed
    record): the in-test stand-in for a control-plane SIGKILL;
  * ``all``     — every raise site above (not ``abandon``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Optional, Sequence

from .. import telemetry
from ..store import format as store_format
from ..utils import with_retry

log = logging.getLogger(__name__)

#: Ledger file name inside a run's store dir, next to test.jtpu.
LEDGER_FILE = "nemesis.ledger"

#: The four fault families the residue probe sweeps for.
FAMILIES = ("partition", "netem", "clock", "process")

FAULT_ENV = "JEPSEN_NEMESIS_FAULT"


class InjectedNemesisFault(RuntimeError):
    """Raised by `maybe_fault` to simulate control-plane failures at
    inject/heal/repair sites."""


def fault_modes() -> set[str]:
    raw = os.environ.get(FAULT_ENV, "")
    return {m.strip() for m in raw.split(",") if m.strip()}


def maybe_fault(site: str) -> None:
    """Raises when JEPSEN_NEMESIS_FAULT names `site` (or "all").  Read
    per call so tests can toggle sites without reimporting."""
    modes = fault_modes()
    if site in modes or "all" in modes:
        raise InjectedNemesisFault(
            f"injected nemesis fault at site {site!r} "
            f"({FAULT_ENV}={os.environ.get(FAULT_ENV)!r})"
        )


def abandoned() -> bool:
    """True when heal paths should be skipped entirely — the SIGKILL
    simulation: the ledger keeps its outstanding entries and the faults
    stay live for `repair` to find."""
    return "abandon" in fault_modes()


def heal_guard() -> bool:
    """The one check every heal path runs first: raises on the "heal"
    fault site, returns True when healing is abandoned (caller returns
    without compensating or journaling)."""
    maybe_fault("heal")
    return abandoned()


# ---------------------------------------------------------------------------
# The ledger itself
# ---------------------------------------------------------------------------


class FaultLedger:
    """Append-only intent/healed journal over one `BlockWriter`.

    The file is created lazily on the first intent, so fault-free runs
    write nothing (the no-overhead contract).  Reopening a ledger with
    a torn tail (crashed writer) truncates back to the last valid block
    via the writer's `_valid_end` recovery, so repair can append fresh
    healed records to a file the dying process half-wrote."""

    def __init__(self, path: str):
        self.path = path
        self._writer: Optional[store_format.BlockWriter] = None
        self._next_id = 1
        self._lock = threading.Lock()

    # -- write side ------------------------------------------------------

    def _open(self) -> store_format.BlockWriter:
        if self._writer is None:
            for rec in read_records(self.path):
                if rec.get("id", 0) >= self._next_id:
                    self._next_id = rec["id"] + 1
            self._writer = store_format.BlockWriter(self.path)
        return self._writer

    def _append(self, rec: dict) -> None:
        w = self._open()
        w.append(store_format.BLOCK_LEDGER, rec)
        w.sync()

    def intent(
        self,
        fault: str,
        *,
        nodes: Optional[Sequence[str]] = None,
        params: Optional[dict] = None,
        compensator: Optional[dict] = None,
        tag: Optional[str] = None,
    ) -> int:
        """Journals one fault intent; returns its entry id.  Call BEFORE
        touching the cluster: the append+fsync must land first, so a
        crash between journal and injection errs toward a spurious
        compensator replay (idempotent) rather than a stranded fault."""
        with self._lock:
            # _open may bump _next_id past prior records on first use.
            self._open()
            eid = self._next_id
            self._next_id += 1
            self._append({
                "rec": "intent",
                "id": eid,
                "fault": fault,
                "tag": tag,
                "nodes": sorted(nodes) if nodes else [],
                "params": params or {},
                "comp": compensator or {"type": "unreplayable"},
                "t": time.time(),
            })
        telemetry.count("nemesis.ledger.intents")
        return eid

    def healed(self, entry_id: int, *, by: str = "run",
               note: Optional[str] = None) -> None:
        """Journals that entry_id's compensator completed.  Call AFTER
        the compensator succeeds, never before."""
        with self._lock:
            rec: dict[str, Any] = {
                "rec": "healed", "id": entry_id, "by": by, "t": time.time(),
            }
            if note:
                rec["note"] = note
            self._append(rec)
        telemetry.count("nemesis.ledger.healed")

    def note(self, why: str, **fields: Any) -> None:
        """Journals an informational record (e.g. the nemesis skipping a
        quarantined node).  Notes carry no compensator and are ignored
        by `outstanding_entries` — pure post-mortem context."""
        with self._lock:
            self._append({
                "rec": "note", "why": why, "t": time.time(), **fields,
            })
        telemetry.count("nemesis.ledger.notes")

    def heal_matching(
        self,
        *,
        fault: Optional[str] = None,
        tag: Optional[str] = None,
        ctype: Optional[str] = None,
        by: str = "run",
    ) -> list[int]:
        """Marks every outstanding entry matching the filters healed
        (a heal like ``net.heal`` or ``iptables -F`` clears the whole
        family at once, not one grudge).  Returns the ids healed."""
        ids = []
        for e in self.outstanding():
            if fault is not None and e.get("fault") != fault:
                continue
            if tag is not None and e.get("tag") != tag:
                continue
            if ctype is not None and (e.get("comp") or {}).get("type") != ctype:
                continue
            ids.append(e["id"])
        for eid in ids:
            self.healed(eid, by=by)
        return ids

    # -- read side -------------------------------------------------------

    def records(self) -> list[dict]:
        with self._lock:
            if self._writer is not None:
                self._writer.f.flush()
        return read_records(self.path)

    def outstanding(self) -> list[dict]:
        return outstanding_entries(self.records())

    def close(self) -> None:
        with self._lock:
            if self._writer is not None:
                self._writer.close()
                self._writer = None


def read_records(path: str) -> list[dict]:
    """All valid ledger records in file order.  A torn/corrupt tail is
    ignored (same `_valid_end` discipline as the test file): everything
    up to the last fsynced block survives a crash."""
    if not os.path.exists(path):
        return []
    size = os.path.getsize(path)
    out: list[dict] = []
    try:
        with open(path, "rb") as f:
            if f.read(len(store_format.MAGIC)) != store_format.MAGIC:
                return []
            while True:
                rec = store_format._read_block(f, size)
                if rec is None:
                    break
                _, btype, payload = rec
                if btype == store_format.BLOCK_LEDGER and isinstance(
                    payload, dict
                ):
                    out.append(payload)
    except OSError as e:  # pragma: no cover - unreadable file
        log.warning("fault ledger %s unreadable: %r", path, e)
    return out


def outstanding_entries(records: list[dict]) -> list[dict]:
    """Intents with no healed record, NEWEST FIRST — the replay order:
    compensate in reverse injection order, the same unwinding a
    correctly exiting run would have performed."""
    healed_ids = {r["id"] for r in records if r.get("rec") == "healed"}
    out = [
        r for r in records
        if r.get("rec") == "intent" and r["id"] not in healed_ids
    ]
    out.sort(key=lambda r: r["id"], reverse=True)
    return out


def ledger_path(test_dir: str) -> str:
    return os.path.join(test_dir, LEDGER_FILE)


def read_outstanding(path: str) -> list[dict]:
    """Unhealed intents at `path`, newest first — the one-call probe
    the monitor's resume path (and its smoke) uses to decide whether a
    crash left fault debt behind."""
    return outstanding_entries(read_records(path))


# ---------------------------------------------------------------------------
# Test-map helpers: every nemesis call site goes through these, so a
# test without a bound ledger (unit tests, library use) pays one dict
# get and nothing else.
# ---------------------------------------------------------------------------


def ledger_of(test: dict) -> Optional[FaultLedger]:
    led = test.get("fault-ledger")
    return led if isinstance(led, FaultLedger) else None


def intent(
    test: dict,
    fault: str,
    *,
    nodes: Optional[Sequence[str]] = None,
    params: Optional[dict] = None,
    compensator: Optional[dict] = None,
    tag: Optional[str] = None,
) -> Optional[int]:
    """Journal an intent (when a ledger is bound), then run the
    mid-inject fault site.  The hook fires even without a ledger so the
    injection paths can be crash-tested in isolation."""
    led = ledger_of(test)
    eid = None
    if led is not None:
        eid = led.intent(
            fault, nodes=nodes, params=params, compensator=compensator,
            tag=tag,
        )
    maybe_fault("inject")
    return eid


def healed(
    test: dict,
    *,
    fault: Optional[str] = None,
    tag: Optional[str] = None,
    ctype: Optional[str] = None,
    entry_id: Optional[int] = None,
    by: str = "run",
) -> list[int]:
    led = ledger_of(test)
    if led is None:
        return []
    if entry_id is not None:
        led.healed(entry_id, by=by)
        return [entry_id]
    return led.heal_matching(fault=fault, tag=tag, ctype=ctype, by=by)


def note(test: dict, why: str, **fields: Any) -> None:
    """Journal an informational note when a ledger is bound; silently a
    no-op otherwise (notes are context, never obligations)."""
    led = ledger_of(test)
    if led is not None:
        led.note(why, **fields)


def net_mech(net: Any) -> str:
    """Names the partition mechanism a live Net uses, so the net-heal
    compensator can be replayed without the object: "iptables",
    "ipfilter", "route", "noop", or "all" (unknown impl: try
    everything)."""
    name = type(net).__name__
    if "Ipfilter" in name:
        return "ipfilter"
    if "Iptables" in name:
        return "iptables"
    if "Route" in name:
        return "route"
    if "Noop" in name:
        return "noop"
    return "all"


# ---------------------------------------------------------------------------
# Compensator execution
# ---------------------------------------------------------------------------

#: Per-node retry policy for compensators: small and bounded — repair
#: must make progress past a dead node, not wait on it.
COMP_RETRIES = 2
COMP_BACKOFF_MS = 100.0


def _heal_net_node(sess: Any, mech: str) -> None:
    if mech in ("iptables", "all"):
        with sess.su():
            sess.exec_star("iptables", "-F", "-w")
            sess.exec_star("iptables", "-X", "-w")
    if mech in ("route", "all"):
        with sess.su():
            sess.exec_star(
                "bash", "-c", "ip route flush type blackhole || true"
            )
    if mech == "ipfilter":
        with sess.su():
            sess.exec_star("ipf", "-Fa")


def _tc_del_node(sess: Any, dev: str) -> None:
    with sess.su():
        # Deleting a nonexistent qdisc exits nonzero; that is the
        # healthy case, so exec_star (never raises on exit codes).
        sess.exec_star("tc", "qdisc", "del", "dev", dev, "root")


def _clock_reset_node(sess: Any) -> None:
    with sess.su():
        sess.exec_star("ntpdate", "-b", "pool.ntp.org")
        # ClockNemesis.setup stopped these; a healed node gets its time
        # daemons back (the "daemon restart" half of the compensator).
        sess.exec_star("systemctl", "start", "ntp", "chronyd",
                       "systemd-timesyncd")


def run_compensator(test: dict, entry: dict) -> dict:
    """Executes one entry's data-described compensator, per-node and
    best-effort: each node gets `with_retry` over transport failures,
    and one unreachable node cannot abort healing the rest.  Returns
    {"ok": bool, "nodes": {node: "ok" | "failed: ..."}}."""
    comp = entry.get("comp") or {}
    ctype = comp.get("type", "unreplayable")
    sessions = test.get("sessions") or {}
    nodes = comp.get("nodes") or entry.get("nodes") or list(sessions.keys())
    results: dict[str, str] = {}

    if ctype == "none":
        return {"ok": True, "nodes": {}}
    if ctype == "unreplayable":
        note = comp.get("note") or "compensator not data-describable"
        return {"ok": False, "nodes": {},
                "error": f"unreplayable: {note}"}

    def node_action(sess: Any, node: str) -> None:
        if ctype == "net-heal":
            _heal_net_node(sess, comp.get("mech", "all"))
        elif ctype == "tc-del":
            _tc_del_node(sess, comp.get("dev", "eth0"))
        elif ctype == "clock-reset":
            _clock_reset_node(sess)
        elif ctype == "sigcont":
            with sess.su():
                sess.exec_star(
                    "pkill", "-CONT", "-f", comp.get("process", "")
                )
        elif ctype == "db-start":
            db = test.get("db")
            if db is None:
                raise RuntimeError("no live db object; pass one to repair")
            db.start(test, sess, node)
        elif ctype == "db-resume":
            db = test.get("db")
            if db is None:
                raise RuntimeError("no live db object; pass one to repair")
            db.resume(test, sess, node)
        elif ctype == "faketime-unwrap":
            from .. import faketime
            cmd = comp.get("cmd")
            if not cmd:
                raise RuntimeError("faketime-unwrap without a cmd")
            with sess.su():
                faketime.unwrap(sess, cmd)
        else:
            raise RuntimeError(f"unknown compensator type {ctype!r}")

    ok = True
    for node in nodes:
        sess = sessions.get(node)
        if sess is None:
            results[node] = "failed: no session"
            ok = False
            continue
        try:
            maybe_fault("repair")
            with_retry(
                lambda s=sess, n=node: node_action(s, n),
                retries=COMP_RETRIES,
                backoff_ms=COMP_BACKOFF_MS,
            )
            results[node] = "ok"
        except Exception as e:  # noqa: BLE001 — continue through siblings
            log.warning(
                "compensator %s for entry %s failed on %s: %r",
                ctype, entry.get("id"), node, e,
            )
            results[node] = f"failed: {type(e).__name__}: {e}"
            ok = False
    if comp.get("mech") == "noop" and ctype == "net-heal":
        # Nothing to undo on a noop net; the loop above was a no-op too.
        ok = True
    return {"ok": ok, "nodes": results}


# ---------------------------------------------------------------------------
# Residue probe sweep
# ---------------------------------------------------------------------------


def _probe_int(sess: Any, script: str) -> int:
    res = sess.exec_star("bash", "-c", script)
    try:
        return int((res.get("out") or "").strip().splitlines()[-1])
    except (ValueError, IndexError):
        return 0


def _probe_node(sess: Any) -> dict:
    """One node's fault residue: leftover iptables DROP rules, blackhole
    routes, tc qdiscs, and wall-clock skew vs the control node.  Every
    probe is best-effort (missing binaries read as clean)."""
    out: dict[str, Any] = {}
    with sess.su():
        out["iptables"] = _probe_int(
            sess,
            "command -v iptables >/dev/null 2>&1 && "
            "iptables -S 2>/dev/null | grep -c -- '-j DROP' || echo 0",
        )
        out["route"] = _probe_int(
            sess,
            "ip route show type blackhole 2>/dev/null | wc -l",
        )
        out["tc"] = _probe_int(
            sess,
            "tc qdisc show 2>/dev/null | grep -cE 'netem|tbf' || echo 0",
        )
    skew = 0.0
    res = sess.exec_star("date", "+%s.%N")
    raw = (res.get("out") or "").strip()
    if raw:
        try:
            skew = abs(float(raw) - time.time())
        except ValueError:
            skew = 0.0
    # Sub-5s offsets are indistinguishable from exec latency + honest
    # drift; the clock faults injected here are >= 100 ms bumps on top
    # of synchronized clocks, and stranded skew is typically seconds+.
    out["clock_skew_s"] = round(skew, 3) if skew >= 5.0 else 0.0
    return out


def probe_residue(
    test: dict, *, ledger: Optional[FaultLedger] = None,
    path: Optional[str] = None,
) -> dict:
    """Sweeps every session-reachable node for fault residue and counts
    what it finds as ``nemesis.residue.<kind>`` telemetry counters
    (which `core.analyze` surfaces in the results' ``resilience``
    block).  Also counts the ledger's outstanding entries.  Returns
    {"clean": bool, "outstanding": n, "nodes": {node: probe}}."""
    sessions = test.get("sessions") or {}
    nodes: dict[str, dict] = {}
    residue_totals: dict[str, float] = {}
    for node, sess in sessions.items():
        try:
            probe = _probe_node(sess)
        except Exception as e:  # noqa: BLE001 — sweep must finish
            log.warning("residue probe on %s failed: %r", node, e)
            nodes[node] = {"error": f"{type(e).__name__}: {e}"}
            telemetry.count("nemesis.residue.unprobed")
            continue
        nodes[node] = probe
        for kind, val in (
            ("iptables", probe["iptables"]),
            ("route", probe["route"]),
            ("tc", probe["tc"]),
            ("clock", 1 if probe["clock_skew_s"] else 0),
        ):
            if val:
                residue_totals[kind] = residue_totals.get(kind, 0) + val
    for kind, val in residue_totals.items():
        telemetry.count(f"nemesis.residue.{kind}", val)

    if ledger is None and path is None:
        led_test = ledger_of(test)
        outstanding = led_test.outstanding() if led_test else []
    elif ledger is not None:
        outstanding = ledger.outstanding()
    else:
        outstanding = outstanding_entries(read_records(path))
    if outstanding:
        telemetry.count("nemesis.residue.outstanding", len(outstanding))

    clean = not residue_totals and not outstanding and not any(
        "error" in p for p in nodes.values()
    )
    return {
        "clean": clean,
        "outstanding": len(outstanding),
        "nodes": nodes,
    }
