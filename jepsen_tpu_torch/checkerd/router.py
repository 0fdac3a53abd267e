"""The checkerd federation router: one address, N daemons, zero lost
verdicts.

The port's copy of `jepsen_tpu/checkerd/router.py`, frame for frame and
journal record for record the reference's: it fronts daemons of either
package, and reopens a ticket journal either package's router wrote.
The router holds no device; each daemon behind it checks on its own
(the card, for the port's `jepsen checkerd --device cuda`).

`jepsen checkerd-router` is a front-end speaking the same framed wire
protocol as a daemon, so clients point at it unchanged (``--remote
router-host:port``).  It adds what a single daemon can't:

* **Placement.**  Each submission is buffered whole, then placed on the
  daemon with the lowest queue depth (the daemon's /metrics gauge, sampled
  via STATS with a short cache) minus a model-cache-affinity bonus: the
  daemon that last checked this canonical model spec has the model
  instance, settle memo and built kernels warm, so equal depths
  break toward it.
* **Failover.**  The router keeps every ticket's raw frames (and, with
  ``--queue``, journals them in checkerd.queue framing).  When a poll
  finds the owning daemon dead — connection refused, reset, or an
  "unknown ticket" from a daemon that restarted without its own journal
  — the buffered frames replay byte-identically against a sibling,
  counted as `router.failover`.  Per-key verdicts are deterministic, so
  the retried result is what the dead daemon would have said.
* **Health.**  Daemons run the same suspect→quarantined→readmitted
  state machine as test nodes (control/health.py): data-path failures
  are passive signals, a stats round-trip is the active probe, and
  quarantined daemons drop out of placement until probes readmit them.
* **Admission.**  ``--tenant-quota`` bounds each tenant's in-flight
  tickets and ``--max-inflight`` bounds the fleet total; a submission
  over either limit gets one deterministic SHED frame with a
  structured RETRY-AFTER at SUBMIT time instead of unbounded router
  memory.  A daemon's own SHED (deadline-aware load shedding,
  checkerd/overload.py) is tried against a sibling first and forwarded
  to the client only when every healthy daemon sheds.  The client
  honors the retry-after (checkerd/client.py ShedByServer) or falls
  back in-process when allowed.

The router submits to daemons on short-lived connections and polls on
fresh ones, so its forwarded SUBMITs carry ``"detached": true`` —
opting out of the daemon's abandon-on-disconnect (server.py), whose
purpose is reclaiming cohort keys from *clients* that vanish.
"""

from __future__ import annotations

import logging
import socketserver
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from .. import telemetry
from ..control.health import monitor_for_targets
from . import ROUTER_PORT, overload
from .client import CheckerdClient, RemoteUnavailable, ShedByServer, fetch_stats
from .journal import QueueJournal, frames_from_record, frames_to_record
from .protocol import (
    F_CHUNK,
    F_COMMIT,
    F_ERROR,
    F_PACKED,
    F_PENDING,
    F_POLL,
    F_RESULT,
    F_RESUME,
    F_RESUME_OK,
    F_SHED,
    F_STATS,
    F_STATS_REPLY,
    F_SUBMIT,
    F_TICKET,
    ProtocolError,
    canonical_spec,
    read_frame,
    write_frame,
)
from .server import MAX_PARKED_SESSIONS

log = logging.getLogger(__name__)

#: How long a daemon's STATS snapshot stays fresh for placement; past
#: this a placement decision re-polls.  Short enough that queue-depth
#: routing tracks bursts, long enough that a poll storm doesn't turn
#: into a stats storm.
STATS_CACHE_S = 1.0

#: Queue-depth equivalent of having the model already cached: the
#: affinity daemon wins placement unless a sibling is this much idler.
AFFINITY_BONUS = 1.0

#: Placement score for a daemon whose stats can't be fetched — still a
#: candidate (the submit attempt is the real probe) but last resort.
UNREACHABLE_DEPTH = 1e6

#: Finished router tickets answer late polls this long (mirrors the
#: scheduler's result TTL), then fall to the lazy sweep.
DONE_TTL_S = 600.0

#: Hard cap on remembered tickets; beyond it the oldest finished ones
#: are dropped (pending tickets are bounded by admission control).
MAX_TICKETS = 4096


class _RSub:
    """One buffered SUBMIT conversation: the raw frames (for replay to
    any daemon) plus the per-key op counts that answer a RESUME."""

    def __init__(self, meta: Any):
        if not isinstance(meta, dict):
            raise ProtocolError("SUBMIT payload must be a dict")
        self.meta = meta
        self.streaming = bool(meta.get("streaming"))
        self.session = meta.get("session") if self.streaming else None
        self.run = str(meta.get("run") or "anonymous")
        self.tenant = str(meta.get("tenant") or self.run)
        self.spec_key = canonical_spec(meta.get("model") or {})
        self.n_keys = int(meta.get("n-keys") or 0)
        self.counts: dict[int, int] = {}
        self.frames: list = [(F_SUBMIT, meta)]

    def add(self, ftype: int, payload: Any) -> None:
        self.frames.append((ftype, payload))
        if ftype == F_CHUNK and isinstance(payload, dict):
            try:
                i = int(payload.get("key"))
            except (TypeError, ValueError) as e:
                raise ProtocolError("CHUNK without a key index") from e
            ops = payload.get("ops")
            self.counts[i] = self.counts.get(i, 0) + (
                len(ops) if isinstance(ops, list) else 0
            )
            if self.streaming and i >= self.n_keys:
                self.n_keys = i + 1

    def received(self) -> dict[str, int]:
        return {str(i): c for i, c in self.counts.items()}


class _TicketRec:
    """One router ticket: where it lives now and the frames to move it."""

    __slots__ = ("ticket", "run", "tenant", "spec_key", "frames", "addr",
                 "daemon_ticket", "result", "done_t", "busy")

    def __init__(self, ticket: str, run: str, spec_key: str, frames: list,
                 tenant: Optional[str] = None):
        self.ticket = ticket
        self.run = run
        self.tenant = tenant or run
        self.spec_key = spec_key
        self.frames = frames
        self.addr: Optional[str] = None
        self.daemon_ticket: Optional[str] = None
        self.result: Optional[dict] = None
        self.done_t: Optional[float] = None
        #: A failover in progress; concurrent pollers wait it out.
        self.busy = False


class Router:
    """Federation state: daemon registry, health, tickets, admission."""

    def __init__(
        self,
        daemons: list[str],
        *,
        tenant_quota: Optional[int] = None,
        max_inflight: Optional[int] = None,
        probe_interval_s: float = 2.0,
        stats_timeout_s: float = 2.0,
        io_timeout_s: float = 60.0,
        queue_path: Optional[str] = None,
    ):
        self.daemons = list(dict.fromkeys(daemons))
        if not self.daemons:
            raise ValueError("router needs at least one daemon address")
        self.tenant_quota = tenant_quota
        self.max_inflight = max_inflight
        self.stats_timeout_s = stats_timeout_s
        self.io_timeout_s = io_timeout_s
        self._lock = threading.Lock()
        self._tickets: dict[str, _TicketRec] = {}  # guarded-by: self._lock
        #: canonical model spec -> the daemon that last checked it (its
        #: model and settle caches are warm for that spec).
        self._affinity: dict[str, str] = {}  # guarded-by: self._lock
        self._stats_cache: dict[str, tuple[float, dict]] = {}  # guarded-by: self._lock
        self.sessions: dict = {}  # guarded-by: self.sessions_lock
        self.sessions_lock = threading.Lock()
        self.n_submits = 0
        self.n_results = 0
        self.n_failovers = 0
        self.n_rejected = 0
        self.n_replayed = 0
        self.shed_by_tenant: dict[str, int] = {}  # guarded-by: self._lock
        self._t0 = time.monotonic()
        self.health = monitor_for_targets(
            self.daemons, self._probe, interval_s=probe_interval_s,
        )
        self.journal = QueueJournal(queue_path) if queue_path else None
        if self.journal is not None:
            self._restore()

    def stop(self) -> None:
        self.health.stop()
        if self.journal is not None:
            self.journal.close()

    # -- daemon health + stats ----------------------------------------------

    def _probe(self, test: dict, addr: Any) -> bool:
        """The active health probe: a STATS round-trip (doubles as a
        placement-gauge refresh when it succeeds)."""
        try:
            st = fetch_stats(str(addr), timeout=self.stats_timeout_s)
        except (RemoteUnavailable, OSError):
            return False
        with self._lock:
            self._stats_cache[str(addr)] = (time.monotonic(), st)
        return True

    def _stats_for(self, addr: str) -> Optional[dict]:
        """The daemon's stats, at most STATS_CACHE_S old; a failed
        fetch is a passive health signal and returns None."""
        now = time.monotonic()
        with self._lock:
            ent = self._stats_cache.get(addr)
        if ent is not None and now - ent[0] <= STATS_CACHE_S:
            return ent[1]
        try:
            st = fetch_stats(addr, timeout=self.stats_timeout_s)
        except RemoteUnavailable:
            self.health.signal(addr, "stats-failed")
            return None
        with self._lock:
            self._stats_cache[addr] = (time.monotonic(), st)
        return st

    # -- placement -----------------------------------------------------------

    def _place(self, spec_key: str, exclude: set) -> str:
        """The daemon to submit to: lowest queue depth wins, the spec's
        affinity daemon gets a bonus, quarantined daemons sit out."""
        cands = [d for d in self.daemons
                 if d not in exclude and not self.health.is_quarantined(d)]
        if not cands:
            raise RemoteUnavailable(
                "no healthy checkerd daemon (all quarantined or already "
                "tried)"
            )
        with self._lock:
            aff = self._affinity.get(spec_key)

        def score(d: str) -> tuple[float, int]:
            st = self._stats_for(d)
            depth = (float(st.get("queue-depth") or 0)
                     if st is not None else UNREACHABLE_DEPTH)
            if d == aff:
                depth -= AFFINITY_BONUS
            return depth, self.daemons.index(d)

        return min(cands, key=score)

    def _replay_to(self, addr: str, frames: list) -> tuple[str, int]:
        """Plays a buffered submission against one daemon; returns its
        (ticket, queue-depth).  A daemon SHED surfaces as ShedByServer
        (raised by CheckerdClient._recv), any other failure as
        RemoteUnavailable."""
        with CheckerdClient(
            addr, connect_timeout=self.stats_timeout_s,
            io_timeout=self.io_timeout_s,
        ) as c:
            for ftype, payload in frames:
                c._send(ftype, payload)
            ftype, payload = c._recv()
            if ftype != F_TICKET:
                raise RemoteUnavailable(f"expected TICKET, got {ftype}")
            return str(payload["ticket"]), int(payload.get("queue-depth") or 0)

    def _send_to_daemon(self, rec: _TicketRec, exclude: set) -> int:
        """Places and submits `rec`, walking siblings on failure;
        returns the accepting daemon's queue depth.  A shedding daemon
        is healthy-but-full: it is skipped without a health signal, and
        when EVERY candidate sheds the last ShedByServer propagates so
        the handler forwards the structured refusal to the client."""
        tried = set(exclude)
        last: Optional[RemoteUnavailable] = None
        while True:
            try:
                addr = self._place(rec.spec_key, tried)
            except RemoteUnavailable as e:
                raise last or e
            try:
                daemon_ticket, depth = self._replay_to(addr, rec.frames)
            except ShedByServer as e:
                last = e
                tried.add(addr)
                telemetry.count("router.daemon-shed")
                log.info("daemon %s shed ticket %s (%s); trying a "
                         "sibling", addr, rec.ticket, e)
                continue
            except RemoteUnavailable as e:
                last = e
                tried.add(addr)
                self.health.signal(addr, "submit-failed")
                telemetry.count("router.daemon-unreachable")
                log.warning("daemon %s refused ticket %s (%s); trying a "
                            "sibling", addr, rec.ticket, e)
                continue
            with self._lock:
                rec.addr = addr
                rec.daemon_ticket = daemon_ticket
                self._affinity[rec.spec_key] = addr
            return depth

    # -- admission -----------------------------------------------------------

    def admission_reason(self, tenant: str) -> Optional[str]:
        """Why this tenant's submission must be shed, or None.
        Deterministic: both bounds are router-local counts, no daemon
        round-trip involved."""
        with self._lock:
            pending = sum(1 for r in self._tickets.values()
                          if r.result is None)
            if (self.max_inflight is not None
                    and pending >= self.max_inflight):
                return (f"fleet at its --max-inflight bound "
                        f"({pending}/{self.max_inflight} tickets in flight)")
            if self.tenant_quota is not None:
                mine = sum(1 for r in self._tickets.values()
                           if r.result is None and r.tenant == tenant)
                if mine >= self.tenant_quota:
                    return (f"tenant {tenant!r} at its --tenant-quota "
                            f"({mine}/{self.tenant_quota} tickets in flight)")
        return None

    def record_shed(self, tenant: str) -> None:
        with self._lock:
            self.n_rejected += 1
            self.shed_by_tenant[tenant] = \
                self.shed_by_tenant.get(tenant, 0) + 1

    # -- the ticket lifecycle ------------------------------------------------

    def submit(self, rsub: _RSub, commit_payload: dict) -> tuple[str, int]:
        """Places one buffered submission; returns (router ticket,
        accepting daemon's queue depth).  Raises RemoteUnavailable when
        no daemon accepts it (the client falls back)."""
        meta = dict(rsub.meta)
        meta["detached"] = True
        frames = [(F_SUBMIT, meta)] + rsub.frames[1:]
        frames.append((F_COMMIT, commit_payload))
        ticket = "r" + uuid.uuid4().hex[:11]
        rec = _TicketRec(ticket, rsub.run, rsub.spec_key, frames,
                         tenant=rsub.tenant)
        self._sweep()
        # Daemon first, then journal, then the TICKET reply: a crash
        # between submit and journal means the client never saw a
        # ticket (safe); a journaled ticket is always pollable after a
        # router restart.
        depth = self._send_to_daemon(rec, exclude=set())
        if self.journal is not None:
            self.journal.record_submit(ticket, {
                "run": rec.run,
                "tenant": rec.tenant,
                "spec-key": rec.spec_key,
                "frames": frames_to_record(frames),
            })
        with self._lock:
            self._tickets[ticket] = rec
            self.n_submits += 1
        telemetry.count("router.submit")
        return ticket, depth

    def poll(self, ticket: str) -> tuple[int, dict]:
        """One poll -> (frame type, payload) for the client."""
        with self._lock:
            rec = self._tickets.get(ticket)
        if rec is None:
            return F_ERROR, {"error": f"unknown ticket {ticket!r}"}
        if rec.result is not None:
            return F_RESULT, rec.result
        if rec.addr is None:
            # Restored from the journal: the first poll re-places it.
            return self._failover(rec, "restored from journal")
        try:
            with CheckerdClient(
                rec.addr, connect_timeout=self.stats_timeout_s,
                io_timeout=self.io_timeout_s,
            ) as c:
                ftype, payload = c.poll(str(rec.daemon_ticket))
        except RemoteUnavailable as e:
            # Dead daemon OR one that restarted without its journal and
            # forgot the ticket — either way the buffered frames move.
            return self._failover(rec, str(e))
        if ftype == F_RESULT:
            self._finish(rec, payload)
            return F_RESULT, payload
        if ftype == F_PENDING:
            return F_PENDING, payload
        return F_ERROR, {"error": f"daemon sent frame type {ftype}"}

    def _finish(self, rec: _TicketRec, result: dict) -> None:
        # Journal before the reply leaves (replay-idempotence rule, as
        # in the scheduler): any verdict a client observed survives a
        # router restart.
        if self.journal is not None:
            self.journal.record_result(rec.ticket, result)
        with self._lock:
            if rec.result is None:
                rec.result = result
                rec.done_t = time.monotonic()
                self.n_results += 1
        telemetry.count("router.result")

    def _failover(self, rec: _TicketRec, why: str) -> tuple[int, dict]:
        with self._lock:
            if rec.busy:
                # Another poller is already moving this ticket.
                return F_PENDING, {"state": "failover", "queue-depth": 0}
            rec.busy = True
            dead = rec.addr
        if dead is not None:
            with self._lock:
                self.n_failovers += 1
            telemetry.count("router.failover")
            self.health.signal(dead, "poll-failed")
            log.warning("daemon %s lost ticket %s (%s); failing over",
                        dead, rec.ticket, why)
        # The client already holds a TICKET for this submission, so the
        # replay must not be deadline-shed by the sibling — an acked
        # ticket yields a verdict, full stop.  Strip the deadline from
        # the replayed SUBMIT (mirrors the scheduler's own journal
        # replay, which never re-sheds).
        if rec.frames and rec.frames[0][0] == F_SUBMIT \
                and isinstance(rec.frames[0][1], dict) \
                and rec.frames[0][1].get("deadline-s") is not None:
            meta = dict(rec.frames[0][1])
            meta.pop("deadline-s", None)
            rec.frames = [(F_SUBMIT, meta)] + rec.frames[1:]
        try:
            depth = self._send_to_daemon(
                rec, exclude={dead} if dead is not None else set(),
            )
        except RemoteUnavailable as e:
            with self._lock:
                rec.busy = False
            return F_ERROR, {
                "error": f"checkerd federation: ticket {rec.ticket} lost "
                         f"({why}) and no healthy sibling accepted it: {e}",
            }
        with self._lock:
            rec.busy = False
        return F_PENDING, {"state": "failover", "queue-depth": depth}

    def _sweep(self) -> None:
        """Lazy eviction at submit time: expired finished tickets go,
        then the oldest finished ones if the map is still over cap."""
        now = time.monotonic()
        with self._lock:
            for t in [t for t, r in self._tickets.items()
                      if r.done_t is not None
                      and now - r.done_t > DONE_TTL_S]:
                del self._tickets[t]
            if len(self._tickets) > MAX_TICKETS:
                done = sorted(
                    (t for t, r in self._tickets.items()
                     if r.result is not None),
                    key=lambda t: self._tickets[t].done_t or 0.0,
                )
                for t in done[:len(self._tickets) - MAX_TICKETS]:
                    del self._tickets[t]

    def _restore(self) -> None:
        """Re-arms journaled tickets after a router restart: finished
        ones answer late polls with the exact journaled bytes,
        unfinished ones re-place on first poll."""
        for ticket, res in self.journal.finished().items():
            rec = _TicketRec(ticket, "replayed", "", [])
            rec.result = res
            rec.done_t = time.monotonic()
            self._tickets[ticket] = rec
        for ticket, sr in self.journal.unfinished().items():
            try:
                frames = frames_from_record(sr.get("frames") or [])
            except (TypeError, ValueError, KeyError) as e:
                telemetry.count("router.replay-failed")
                log.warning("journaled ticket %s unreplayable: %r",
                            ticket, e)
                continue
            rec = _TicketRec(
                ticket, str(sr.get("run") or "anonymous"),
                str(sr.get("spec-key") or ""), frames,
                tenant=str(sr.get("tenant") or "") or None,
            )
            self._tickets[ticket] = rec
            self.n_replayed += 1
            telemetry.count("router.replayed")
        if self._tickets:
            log.info("router journal restored %d finished + %d pending "
                     "tickets", self.n_results, self.n_replayed)

    # -- sessions (streaming resume through the router) ----------------------

    def park(self, rsub: _RSub) -> None:
        with self.sessions_lock:
            self.sessions[rsub.session] = rsub
            while len(self.sessions) > MAX_PARKED_SESSIONS:
                del self.sessions[next(iter(self.sessions))]

    def parked(self, token: Any) -> Optional[_RSub]:
        with self.sessions_lock:
            return self.sessions.get(token)

    def unpark(self, rsub: _RSub) -> None:
        if rsub.session is not None:
            with self.sessions_lock:
                self.sessions.pop(rsub.session, None)

    # -- reporting -----------------------------------------------------------

    def stats(self) -> dict:
        daemons: dict[str, Any] = {}
        for d in self.daemons:
            st = self._stats_for(d)
            daemons[d] = st if st is not None else {"unreachable": True}
        health = self.health.summary()
        depth = sum(
            int(st.get("queue-depth") or 0) for st in daemons.values()
            if isinstance(st, dict) and not st.get("unreachable")
        )
        with self._lock:
            pending = sum(1 for r in self._tickets.values()
                          if r.result is None)
            return {
                "router": True,
                "uptime-s": round(time.monotonic() - self._t0, 3),
                "daemons": daemons,
                "health": health,
                "queue-depth": depth,
                "inflight": pending,
                "submits": self.n_submits,
                "results": self.n_results,
                "failovers": self.n_failovers,
                "admission-rejected": self.n_rejected,
                "shed-by-tenant": dict(self.shed_by_tenant),
                "replayed": self.n_replayed,
                "affinity": dict(self._affinity),
                "quota": {"tenant-quota": self.tenant_quota,
                          "max-inflight": self.max_inflight},
                "queue-journal": (self.journal.stats()
                                  if self.journal is not None else None),
            }


class _RouterHandler(socketserver.StreamRequestHandler):
    """Same conversation shape as the daemon's handler; SUBMIT..COMMIT
    is buffered in the router, placed at COMMIT."""

    def handle(self) -> None:
        router: Router = self.server.router  # type: ignore[attr-defined]
        rsub: Optional[_RSub] = None
        #: A rejected submission's CHUNK/PACKED/COMMIT frames are
        #: swallowed so the single admission ERROR is the only reply.
        rejecting = False
        while True:
            try:
                fr = read_frame(self.rfile)
            except ProtocolError as e:
                self._reply(F_ERROR, {"error": str(e)})
                return
            if fr is None:
                return
            ftype, payload = fr
            try:
                if ftype == F_SUBMIT:
                    rejecting = False
                    meta = payload if isinstance(payload, dict) else {}
                    tenant = str(meta.get("tenant")
                                 or meta.get("run") or "anonymous")
                    reason = router.admission_reason(tenant)
                    if reason is not None:
                        rejecting = True
                        rsub = None
                        router.record_shed(tenant)
                        telemetry.count("router.admission-rejected")
                        log.warning("admission shed for %s: %s",
                                    tenant, reason)
                        # Structured soft refusal, not an ERROR: the
                        # quota is a congestion signal the client can
                        # wait out, not a protocol failure.
                        self._reply(F_SHED, overload.OverloadShed(
                            reason=f"router admission: {reason}",
                            retry_after_s=1.0,
                            tenant=tenant,
                        ).payload())
                    else:
                        rsub = _RSub(payload)
                        if rsub.session:
                            router.park(rsub)
                elif ftype in (F_CHUNK, F_PACKED):
                    if rejecting:
                        continue
                    if rsub is None:
                        raise ProtocolError("CHUNK/PACKED before SUBMIT")
                    rsub.add(ftype, payload)
                elif ftype == F_RESUME:
                    token = (payload.get("session")
                             if isinstance(payload, dict) else None)
                    parked = router.parked(token)
                    if parked is None:
                        self._reply(F_ERROR, {
                            "error": f"unknown session {token!r} (router "
                                     "restarted or session evicted)",
                        })
                    else:
                        rejecting = False
                        rsub = parked
                        self._reply(F_RESUME_OK, {
                            "received": rsub.received(),
                            "n-keys": rsub.n_keys,
                        })
                elif ftype == F_COMMIT:
                    if rejecting:
                        rejecting = False
                        continue
                    if rsub is None:
                        raise ProtocolError("COMMIT before SUBMIT")
                    s, rsub = rsub, None
                    router.unpark(s)
                    try:
                        ticket, depth = router.submit(
                            s, payload if isinstance(payload, dict)
                            else {},
                        )
                    except ShedByServer as e:
                        # Every healthy daemon shed it: forward the
                        # structured refusal so the client can honor
                        # the retry-after.
                        router.record_shed(s.tenant)
                        telemetry.count("router.shed-forwarded")
                        self._reply(F_SHED, e.shed.payload())
                        continue
                    self._reply(F_TICKET, {
                        "ticket": ticket, "queue-depth": depth,
                    })
                elif ftype == F_POLL:
                    rtype, rp = router.poll(str(payload.get("ticket")))
                    self._reply(rtype, rp)
                elif ftype == F_STATS:
                    self._reply(F_STATS_REPLY, router.stats())
                else:
                    self._reply(F_ERROR, {
                        "error": f"unexpected frame type {ftype}",
                    })
            except (ProtocolError, ValueError, RemoteUnavailable) as e:
                rsub = None
                self._reply(F_ERROR, {"error": str(e)})
            except BrokenPipeError:
                return
            except Exception as e:  # noqa: BLE001 — per-connection wall
                log.exception("router handler error")
                rsub = None
                self._reply(F_ERROR, {"error": repr(e)})

    def _reply(self, ftype: int, payload: Any) -> None:
        try:
            write_frame(self.wfile, ftype, payload)
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass


class RouterServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    router: Router


def make_router_server(
    host: str = "127.0.0.1",
    port: int = ROUTER_PORT,
    **router_kw: Any,
) -> RouterServer:
    daemons = router_kw.pop("daemons")
    srv = RouterServer((host, port), _RouterHandler)
    srv.router = Router(daemons, **router_kw)
    return srv


class _RouterMetricsHandler(BaseHTTPRequestHandler):
    """Prometheus scrape surface for the federation: fleet-wide queue
    depth, in-flight tickets, failover/admission counters, and how many
    daemons placement can currently use."""

    router: Router  # bound by make_router_metrics_server

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        if self.path.split("?", 1)[0] not in ("/metrics", "/metrics/"):
            self.send_error(404)
            return
        try:
            st = self.router.stats()
            healthy = sum(
                1 for h in (st.get("health") or {}).values()
                if h.get("state") != "quarantined"
            )
            extra = {
                "router.daemons": len(self.router.daemons),
                "router.daemons-healthy": healthy,
                "router.queue-depth": st.get("queue-depth", 0),
                "router.inflight": st.get("inflight", 0),
                "router.submits": st.get("submits", 0),
                "router.results": st.get("results", 0),
                "router.failovers": st.get("failovers", 0),
                "router.admission-rejected": st.get(
                    "admission-rejected", 0),
                "router.replayed": st.get("replayed", 0),
            }
            extra_labeled = {
                "router.shed": (
                    "tenant", st.get("shed-by-tenant") or {}, "counter"),
            }
            body = telemetry.prometheus_text(
                extra_gauges=extra, extra_labeled=extra_labeled,
            ).encode()
        except Exception as e:  # noqa: BLE001 — a scrape must not 500
            body = f"# metrics error: {e!r}\n".encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args: Any) -> None:
        log.debug("router metrics: " + fmt, *args)


def make_router_metrics_server(
    router: Router, host: str = "127.0.0.1", port: int = 0,
) -> ThreadingHTTPServer:
    handler = type("BoundRouterMetrics", (_RouterMetricsHandler,),
                   {"router": router})
    return ThreadingHTTPServer((host, port), handler)


def serve(
    host: str = "0.0.0.0",
    port: int = ROUTER_PORT,
    *,
    daemons: list[str],
    tenant_quota: Optional[int] = None,
    max_inflight: Optional[int] = None,
    probe_interval_s: float = 2.0,
    metrics_port: Optional[int] = None,
    queue_path: Optional[str] = None,
) -> None:
    """Blocking entrypoint for `jepsen checkerd-router` and `python -m
    jepsen_tpu_torch.checkerd.router`."""
    srv = make_router_server(
        host, port,
        daemons=daemons,
        tenant_quota=tenant_quota,
        max_inflight=max_inflight,
        probe_interval_s=probe_interval_s,
        queue_path=queue_path,
    )
    bound_port = srv.server_address[1]
    msrv = None
    if metrics_port is not None:
        msrv = make_router_metrics_server(srv.router, host, metrics_port)
        threading.Thread(
            target=msrv.serve_forever, name="router-metrics", daemon=True,
        ).start()
        log.info("checkerd-router /metrics on %s:%d",
                 host, msrv.server_address[1])
    log.info("checkerd-router serving on %s:%d -> %s",
             host, bound_port, ", ".join(daemons))
    print(f"checkerd-router serving on {host}:{bound_port} "
          f"-> {', '.join(daemons)}")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        srv.server_close()
        srv.router.stop()
        if msrv is not None:
            msrv.shutdown()
            msrv.server_close()


def main(argv: Optional[list[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="jepsen-tpu-torch-checkerd-router",
        description="federation front-end for a fleet of checkerd "
                    "daemons: queue-depth placement, failover, "
                    "per-tenant admission",
    )
    p.add_argument("--host", "-b", default="0.0.0.0")
    p.add_argument("--port", "-p", type=int, default=ROUTER_PORT)
    p.add_argument(
        "--daemon", "-d", action="append", default=[], metavar="ADDR",
        help="a daemon address (host:port); repeatable",
    )
    p.add_argument(
        "--tenant-quota", type=int, default=None, metavar="N",
        help="max in-flight tickets per run name; over it SUBMIT gets "
        "a deterministic checkerd.admission-rejected error",
    )
    p.add_argument(
        "--max-inflight", type=int, default=None, metavar="N",
        help="max in-flight tickets fleet-wide (bounded queue depth)",
    )
    p.add_argument(
        "--probe-interval", type=float, default=2.0, metavar="S",
        help="health-probe cadence for suspect/quarantined daemons",
    )
    p.add_argument(
        "--metrics-port", type=int, default=ROUTER_PORT + 1, metavar="P",
        help="HTTP port for the Prometheus /metrics scrape surface "
        f"(default {ROUTER_PORT + 1}; -1 disables)",
    )
    p.add_argument(
        "--queue", default=None, metavar="PATH",
        help="crash-safe ticket journal (checkerd.queue framing): a "
        "restarted router keeps answering polls for every journaled "
        "ticket",
    )
    opts = p.parse_args(argv)
    if not opts.daemon:
        p.error("at least one --daemon ADDR is required")
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [%(threadName)s] "
               "%(name)s: %(message)s",
    )
    serve(
        opts.host, opts.port,
        daemons=opts.daemon,
        tenant_quota=opts.tenant_quota,
        max_inflight=opts.max_inflight,
        probe_interval_s=opts.probe_interval,
        metrics_port=None if opts.metrics_port < 0 else opts.metrics_port,
        queue_path=opts.queue,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
