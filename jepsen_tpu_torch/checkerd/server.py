"""The checkerd TCP server: frames in, verdicts out.

The port's copy of `jepsen_tpu/checkerd/server.py`.  One handler thread
per connection parses frames (protocol.py) and talks to the shared
Scheduler; the scheduler's single worker thread owns the card (`device`,
"cuda" unless the caller asks for the CPU; a daemon asked for CUDA with
no card raises at start).  Submissions are connection-scoped state machines
(SUBMIT -> CHUNK*/PACKED* -> COMMIT -> TICKET), polls and stats are
stateless, and any per-connection failure answers with an ERROR frame
instead of touching the daemon.
"""

from __future__ import annotations

import logging
import socketserver
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from . import DEFAULT_PORT
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
    read_frame,
    unpack_key_frame,
    write_frame,
)
from . import overload
from .scheduler import Request, Scheduler
from .. import telemetry

log = logging.getLogger(__name__)

#: Parked streaming sessions the daemon keeps for reconnecting
#: clients; LRU eviction past this (a leaked session must not pin its
#: half-uploaded history forever, and a session that just resumed must
#: not be the one evicted).
MAX_PARKED_SESSIONS = 64

#: Evicted session tokens remembered so a late RESUME gets an honest
#: "evicted" refusal (the client falls back to post-hoc) instead of an
#: indistinguishable "unknown session".
MAX_EVICTED_REMEMBERED = 256


class _Submission:
    """Connection-local accumulation of one SUBMIT conversation."""

    def __init__(self, meta: dict):
        self.meta = meta
        self.n_keys = int(meta.get("n-keys") or 0)
        if not 0 <= self.n_keys <= 1_000_000:
            raise ProtocolError(f"implausible n-keys {self.n_keys}")
        #: A streamed submission (streaming/remote.py) opens with a
        #: DEFERRED key count: chunks grow it as keys first appear and
        #: COMMIT's payload finalizes it.
        self.streaming = bool(meta.get("streaming"))
        #: Client-minted resume token: the submission is parked when
        #: its connection dies and a RESUME re-attaches to it.
        self.session = meta.get("session") if self.streaming else None
        #: Per key: the op dicts as received (the queue journal writes
        #: them as they are) and the Ops built from them chunk by chunk,
        #: so COMMIT, where concurrent submissions queue up against one
        #: another, builds no op.
        self.ops: dict[int, list] = {}
        self.built: dict[int, list] = {}
        self.packs: dict[int, Any] = {}

    def received(self) -> dict[str, int]:
        """Per-key op counts already held — the stable bound a resuming
        client continues from."""
        return {str(i): len(ops) for i, ops in self.ops.items()}

    def _check_key(self, i: Any) -> int:
        i = int(i)
        if self.streaming and self.n_keys <= i < 1_000_000:
            self.n_keys = i + 1
        if not 0 <= i < self.n_keys:
            raise ProtocolError(
                f"key index {i} outside 0..{self.n_keys - 1}"
            )
        return i

    def finalize_keys(self, payload: dict) -> None:
        """Applies COMMIT's `n-keys` override (streamed submissions
        declare the count only once the run ends)."""
        n = payload.get("n-keys") if isinstance(payload, dict) else None
        if n is None:
            return
        n = int(n)
        if not self.n_keys <= n <= 1_000_000:
            raise ProtocolError(
                f"COMMIT n-keys {n} below the {self.n_keys} keys seen"
            )
        self.n_keys = n

    def add_chunk(self, payload: dict) -> None:
        i = self._check_key(payload.get("key"))
        ops = payload.get("ops")
        if not isinstance(ops, list):
            raise ProtocolError("CHUNK without an ops list")
        from ..history.core import Op

        built = [Op.from_dict(o) for o in ops]
        self.ops.setdefault(i, []).extend(ops)
        self.built.setdefault(i, []).extend(built)
        telemetry.count("ingest.decode.ops", len(ops))

    def add_packed(self, data: bytes) -> None:
        from ..history.packed import packed_from_bytes

        i, body = unpack_key_frame(data)
        i = self._check_key(i)
        try:
            self.packs[i] = packed_from_bytes(body)
        except ValueError as e:
            raise ProtocolError(f"key {i}: {e}") from e
        telemetry.count("ingest.decode.packs")
        telemetry.count("ingest.decode.pack-bytes", len(body))

    def build(self, scheduler: Scheduler) -> Request:
        with telemetry.span("ingest.decode.build",
                            keys=len(self.ops) + len(self.packs)):
            return self._build(scheduler)

    def _build(self, scheduler: Scheduler) -> Request:
        from ..history.core import History

        meta = self.meta
        spec = meta.get("model")
        if not isinstance(spec, dict):
            raise ProtocolError("SUBMIT without a model spec")
        # Validates the spec (unknown type -> ValueError -> ERROR frame)
        # and warms the daemon-wide instance before the queue sees it.
        scheduler.model_for(spec)
        subs = {
            # Ops arrive as to_dict() dicts with their original indices;
            # reindex=False keeps them, so per-key certificates cite
            # positions in the submitting run's full history.
            i: History(ops, reindex=False)
            for i, ops in self.built.items()
        }
        return Request(
            run=str(meta.get("run") or "anonymous"),
            model_spec=spec,
            algorithm=str(meta.get("algorithm") or "wgl-tpu"),
            n_keys=self.n_keys,
            budget_s=meta.get("budget-s"),
            time_limit_s=meta.get("time-limit-s"),
            subs=subs,
            wire_ops=self.ops,
            packs=self.packs,
            trace=meta.get("trace"),
            tenant=meta.get("tenant"),
            deadline_s=meta.get("deadline-s"),
        )


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        sched: Scheduler = self.server.scheduler  # type: ignore[attr-defined]
        sub: Optional[_Submission] = None
        conn_id = id(self)
        owned: list[str] = []
        try:
            self._converse(sched, sub, conn_id, owned)
        finally:
            # Disconnect mid-PENDING: a ticket whose submitting
            # connection died with nobody else polling it would keep
            # its keys in the merged cohort forever — cancel it instead
            # (dropped at the next cohort boundary, counted as
            # checkerd.ticket-abandoned).  Streamed tickets are exempt:
            # their poller arrives later on a fresh connection.
            for t in owned:
                sched.abandon(t, conn_id)

    def _converse(
        self,
        sched: Scheduler,
        sub: Optional[_Submission],
        conn_id: int,
        owned: list[str],
    ) -> None:
        while True:
            try:
                fr = read_frame(self.rfile)
            except ProtocolError as e:
                self._reply(F_ERROR, {"error": str(e)})
                return  # stream desynced: close
            if fr is None:
                return
            ftype, payload = fr
            try:
                if ftype == F_SUBMIT:
                    sub = _Submission(payload)
                    if sub.session:
                        # Streamed with a resume token: survive this
                        # connection's death so a RESUME re-attaches.
                        self._park(sub)
                elif ftype == F_CHUNK:
                    self._need(sub, "CHUNK").add_chunk(payload)
                elif ftype == F_PACKED:
                    self._need(sub, "PACKED").add_packed(payload)
                elif ftype == F_RESUME:
                    token = (payload.get("session")
                             if isinstance(payload, dict) else None)
                    parked = self._parked(token)
                    if parked is None:
                        # Honest RESUME refusal: an evicted session is
                        # named as such so the client knows its stream
                        # is unrecoverable and falls back to post-hoc
                        # (never wedges waiting for a bound that will
                        # not come).
                        if self._was_evicted(token):
                            telemetry.count("checkerd.resume-refused")
                            self._reply(F_ERROR, {
                                "error": f"session {token!r} evicted "
                                "(parked-session LRU bound; resume "
                                "refused — submit post-hoc)",
                            })
                        else:
                            self._reply(F_ERROR, {
                                "error": f"unknown session {token!r} "
                                "(daemon restarted or session evicted)",
                            })
                    else:
                        sub = parked
                        self._reply(F_RESUME_OK, {
                            "received": sub.received(),
                            "n-keys": sub.n_keys,
                        })
                elif ftype == F_COMMIT:
                    s = self._need(sub, "COMMIT")
                    s.finalize_keys(payload)
                    req = s.build(sched)
                    sub = None
                    if s.session:
                        self._unpark(s)
                    # Detached submissions (the federation router, which
                    # submits on a short-lived connection and polls on
                    # fresh ones) opt out of abandon-on-disconnect, as
                    # do streamed ones (their poller arrives later).
                    detached = s.streaming or bool(s.meta.get("detached"))
                    try:
                        ticket = sched.submit(
                            req,
                            owner_conn=None if detached else conn_id,
                        )
                    except overload.OverloadShed as shed:
                        # Structured refusal: no ticket was minted or
                        # journaled, so nothing can be silently lost.
                        self._reply(F_SHED, shed.payload())
                        continue
                    if not detached:
                        owned.append(ticket)
                    self._reply(F_TICKET, {
                        "ticket": ticket,
                        "queue-depth": sched.queue_depth(),
                    })
                elif ftype == F_POLL:
                    r = sched.poll(str(payload.get("ticket")), conn_id)
                    if "_error" in r:
                        self._reply(F_ERROR, {"error": r["_error"]})
                    elif r.pop("_pending", None):
                        self._reply(F_PENDING, r)
                    else:
                        self._reply(F_RESULT, r)
                elif ftype == F_STATS:
                    self._reply(F_STATS_REPLY, sched.stats())
                else:
                    self._reply(F_ERROR, {
                        "error": f"unexpected frame type {ftype}",
                    })
            except (ProtocolError, ValueError) as e:
                sub = None
                self._reply(F_ERROR, {"error": str(e)})
            except BrokenPipeError:
                return
            except Exception as e:  # noqa: BLE001 — per-connection wall
                log.exception("checkerd handler error")
                sub = None
                self._reply(F_ERROR, {"error": repr(e)})

    def _need(self, sub: Optional[_Submission], what: str) -> _Submission:
        if sub is None:
            raise ProtocolError(f"{what} before SUBMIT")
        return sub

    def _park(self, sub: _Submission) -> None:
        """Parks (or LRU-touches) a streamed submission.  Eviction is
        least-recently-used — dict insertion order, refreshed on every
        park and resume — bounded by MAX_PARKED_SESSIONS; each victim
        is counted (checkerd.parked-evicted) and remembered so its
        RESUME gets an honest refusal."""
        srv = self.server
        with srv.sessions_lock:  # type: ignore[attr-defined]
            srv.sessions.pop(sub.session, None)  # type: ignore[attr-defined]
            srv.sessions[sub.session] = sub  # type: ignore[attr-defined]
            while len(srv.sessions) > MAX_PARKED_SESSIONS:  # type: ignore[attr-defined]
                victim = next(iter(srv.sessions))  # type: ignore[attr-defined]
                del srv.sessions[victim]  # type: ignore[attr-defined]
                srv.evicted_sessions.append(victim)  # type: ignore[attr-defined]
                telemetry.count("checkerd.parked-evicted")

    def _parked(self, token: Any) -> Optional[_Submission]:
        srv = self.server
        with srv.sessions_lock:  # type: ignore[attr-defined]
            sub = srv.sessions.get(token)  # type: ignore[attr-defined]
            if sub is not None:
                # LRU touch: a resuming session moves to the young end.
                srv.sessions.pop(token, None)  # type: ignore[attr-defined]
                srv.sessions[token] = sub  # type: ignore[attr-defined]
            return sub

    def _was_evicted(self, token: Any) -> bool:
        srv = self.server
        with srv.sessions_lock:  # type: ignore[attr-defined]
            return token in srv.evicted_sessions  # type: ignore[attr-defined]

    def _unpark(self, sub: _Submission) -> None:
        srv = self.server
        with srv.sessions_lock:  # type: ignore[attr-defined]
            srv.sessions.pop(sub.session, None)  # type: ignore[attr-defined]

    def _reply(self, ftype: int, payload: Any) -> None:
        try:
            write_frame(self.wfile, ftype, payload)
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass


class CheckerdServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    scheduler: Scheduler
    #: Parked streaming submissions by resume token (F_RESUME),
    #: LRU-ordered: oldest-touched first.
    sessions: dict
    sessions_lock: threading.Lock
    #: Recently LRU-evicted session tokens (honest RESUME refusals).
    evicted_sessions: Any


def make_server(
    host: str = "127.0.0.1",
    port: int = DEFAULT_PORT,
    *,
    device: Any = "cuda",
    batch_window_s: float = 0.05,
    max_budget_s: Optional[float] = None,
    profile_dir: Optional[str] = None,
    plan_cache_dir: Optional[str] = None,
    queue_path: Optional[str] = None,
    tenant_weights: Optional[dict] = None,
) -> CheckerdServer:
    from collections import deque

    # The scheduler (and its card check) first: a daemon that cannot
    # reach its device never binds the port.
    scheduler = Scheduler(
        device=device,
        batch_window_s=batch_window_s,
        max_budget_s=max_budget_s,
        profile_dir=profile_dir,
        plan_cache_dir=plan_cache_dir,
        queue_path=queue_path,
        tenant_weights=tenant_weights,
    )
    try:
        srv = CheckerdServer((host, port), _Handler)
    except OSError:
        scheduler.stop()
        raise
    srv.sessions = {}
    srv.sessions_lock = threading.Lock()
    srv.evicted_sessions = deque(maxlen=MAX_EVICTED_REMEMBERED)
    srv.scheduler = scheduler
    return srv


class _MetricsHandler(BaseHTTPRequestHandler):
    """Prometheus-text scrape endpoint for the daemon: process
    telemetry plus scheduler gauges (queue depth, utilization,
    profile-record count) and the one-hot chip_health family."""

    scheduler: Scheduler  # class attribute bound by make_metrics_server

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        if self.path.split("?", 1)[0] not in ("/metrics", "/metrics/"):
            self.send_error(404)
            return
        from .. import telemetry
        from ..ops import degrade

        try:
            st = self.scheduler.stats()
            ov = st.get("overload") or {}
            extra = {
                "checkerd.queue-depth": st.get("queue-depth", 0),
                "checkerd.utilization": st.get("utilization", 0.0),
                "checkerd.uptime-s": st.get("uptime-s", 0.0),
                "checkerd.requests": st.get("requests", 0),
                "checkerd.cohorts": st.get("cohorts", 0),
                "checkerd.merge-ratio": st.get("merge-ratio", 0.0),
                "checkerd.profile-records": st.get("profile-records", 0),
                "checkerd.overload.brownout-level":
                    ov.get("brownout-level", 0),
                "checkerd.overload.shed-total": ov.get("shed", 0),
            }
            # Per-tenant admission/fairness families (satellite 3):
            # jepsen_checkerd_shed_total{tenant=...} and the queue-wait
            # p95 gauge per tenant.
            tenants = ov.get("tenants") or {}
            shed_by_tenant = {
                t: d.get("shed", 0) for t, d in tenants.items()
                if d.get("shed")
            }
            wait_p95 = {
                t: d["queue-wait-p95-s"] for t, d in tenants.items()
                if d.get("queue-wait-p95-s") is not None
            }
            extra_labeled = {
                "checkerd.shed": ("tenant", shed_by_tenant, "counter"),
                "checkerd.queue-wait-p95-seconds":
                    ("tenant", wait_p95, "gauge"),
            }
            # SLO sweep on every scrape: the daemon-surface gauges
            # (queue depth, merge ratio) only exist here, so this is
            # where their rules get their samples.
            from ..telemetry import slo

            slo.evaluate(extra, degrade.chip_state())
            body = telemetry.prometheus_text(
                extra_gauges=extra, chip_state=degrade.chip_state(),
                slo_firing=slo.firing_gauges(),
                extra_labeled=extra_labeled,
            ).encode()
        except Exception as e:  # noqa: BLE001 — a scrape must not 500
            # the daemon into a restart loop; answer degraded instead.
            body = f"# metrics error: {e!r}\n".encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args: Any) -> None:
        log.debug("metrics: " + fmt, *args)


def make_metrics_server(
    scheduler: Scheduler, host: str = "127.0.0.1", port: int = 0,
) -> ThreadingHTTPServer:
    """A /metrics HTTP listener bound to `scheduler` (port 0 = ephemeral
    for tests); the caller runs serve_forever in a daemon thread."""
    handler = type("BoundMetrics", (_MetricsHandler,),
                   {"scheduler": scheduler})
    return ThreadingHTTPServer((host, port), handler)


def serve(
    host: str = "0.0.0.0",
    port: int = DEFAULT_PORT,
    *,
    device: Any = "cuda",
    batch_window_s: float = 0.05,
    max_budget_s: Optional[float] = None,
    metrics_port: Optional[int] = None,
    profile_dir: Optional[str] = None,
    plan_cache_dir: Optional[str] = None,
    queue_path: Optional[str] = None,
    tenant_weights: Optional[dict] = None,
) -> None:
    """Blocking entrypoint for `python -m jepsen_tpu_torch.checkerd`."""
    srv = make_server(
        host, port, device=device,
        batch_window_s=batch_window_s, max_budget_s=max_budget_s,
        profile_dir=profile_dir,
        plan_cache_dir=plan_cache_dir,
        queue_path=queue_path,
        tenant_weights=tenant_weights,
    )
    bound_port = srv.server_address[1]
    msrv = None
    if metrics_port is not None:
        msrv = make_metrics_server(srv.scheduler, host, metrics_port)
        threading.Thread(
            target=msrv.serve_forever, name="checkerd-metrics",
            daemon=True,
        ).start()
        log.info("checkerd /metrics on %s:%d",
                 host, msrv.server_address[1])
    log.info("checkerd serving on %s:%d", host, bound_port)
    print(f"checkerd serving on {host}:{bound_port} on "
          f"{srv.scheduler.device} (batch window {batch_window_s}s)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        srv.server_close()
        srv.scheduler.stop()
        if msrv is not None:
            msrv.shutdown()
            msrv.server_close()


def main(argv: Optional[list[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="jepsen-tpu-torch-checkerd",
        description="long-lived linearizability-checker daemon",
    )
    p.add_argument("--host", "-b", default="0.0.0.0")
    p.add_argument("--port", "-p", type=int, default=DEFAULT_PORT)
    p.add_argument(
        "--batch-window", type=float, default=0.05, metavar="S",
        help="seconds to linger after the first queued request so "
        "concurrent runs merge into one cohort (default 0.05)",
    )
    p.add_argument(
        "--max-budget", type=float, default=None, metavar="S",
        help="clamp every request's checker budget to this many "
        "seconds, protecting the pool from pathological histories",
    )
    p.add_argument(
        "--device", default="cuda",
        help="the torch device the daemon checks on (default cuda; the "
        "daemon raises at start when it has no CUDA card)",
    )
    p.add_argument(
        "--metrics-port", type=int, default=DEFAULT_PORT + 1,
        metavar="P",
        help="HTTP port for the Prometheus /metrics scrape surface "
        f"(default {DEFAULT_PORT + 1}; -1 disables)",
    )
    p.add_argument(
        "--profile-dir", default=None, metavar="DIR",
        help="directory for the fleet-wide per-pass cost-profile "
        "store (profiles.jsonl) and postmortem dumps",
    )
    p.add_argument(
        "--plan-cache", default=None, metavar="DIR",
        help="directory for the persistent plan memo: a restarted "
        "daemon re-checking byte-identical histories warm-starts from "
        "it (plan/cache.py)",
    )
    p.add_argument(
        "--queue", default=None, metavar="PATH",
        help="crash-safe queue journal file (checkerd.queue): every "
        "accepted submission and verdict is journaled + fsynced, and "
        "a restarted daemon replays unfinished tickets under their "
        "original ids — zero in-flight verdicts lost",
    )
    p.add_argument(
        "--tenant-weight", action="append", default=[],
        metavar="NAME=W",
        help="fair-queue weight for a tenant (repeatable; default 1.0 "
        "each): service share under saturation is weight-proportional, "
        "never a hard cliff",
    )
    opts = p.parse_args(argv)
    weights: dict[str, float] = {}
    for spec in opts.tenant_weight:
        name, _, w = spec.partition("=")
        try:
            weights[name] = float(w)
        except ValueError:
            p.error(f"--tenant-weight {spec!r}: expected NAME=FLOAT")
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [%(threadName)s] "
               "%(name)s: %(message)s",
    )
    serve(
        opts.host, opts.port, device=opts.device,
        batch_window_s=opts.batch_window, max_budget_s=opts.max_budget,
        metrics_port=None if opts.metrics_port < 0 else opts.metrics_port,
        profile_dir=opts.profile_dir,
        plan_cache_dir=opts.plan_cache,
        queue_path=opts.queue,
        tenant_weights=weights or None,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
