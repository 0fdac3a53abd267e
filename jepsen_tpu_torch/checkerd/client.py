"""The checkerd client: CheckerdClient (wire) and RemoteChecker (Checker).

The port's copy of `jepsen_tpu/checkerd/client.py`; it talks to a
daemon of either package (the wire is the reference's).

RemoteChecker is the drop-in: it wraps an IndependentChecker-over-
Linearizable (or a bare Linearizable), performs the per-key split
client-side — KV payloads don't survive JSON, and keys never need to
cross the wire anyway (protocol.py) — ships op dicts to the daemon, and
reassembles a result shaped exactly like the in-process checker's.  Any
transport failure, unknown-model refusal, or client-side poll timeout
falls back to in-process checking (counted as `checkerd.fallback`), so
pointing a run at a dead daemon costs one connect timeout, never the
verdict.  That is a transport fallback: the checker it falls back to is
the wrapped one, which runs on the card unless it was built for the
CPU, and a device fault there raises as it would in-process.

Budget semantics: the run's `checker_budget` rides the SUBMIT frame and
is enforced server-side per request; RemoteChecker declares
`supervises_children` so check_safe doesn't start a racing client-side
watchdog that would expire first (network overhead) and discard the
server's richer answer.  On fallback the budget applies in-process as
usual.
"""

from __future__ import annotations

import logging
import socket
import time
from typing import Any, Optional

from .. import telemetry
from ..checker.core import Checker, check_safe, merge_valid
from . import overload
from .protocol import (
    F_CHUNK,
    F_COMMIT,
    F_ERROR,
    F_PACKED,
    F_PENDING,
    F_POLL,
    F_RESULT,
    F_SHED,
    F_STATS,
    F_STATS_REPLY,
    F_SUBMIT,
    F_TICKET,
    ProtocolError,
    connect,
    model_to_spec,
    pack_key_frame,
    read_frame,
    write_frame,
)

log = logging.getLogger(__name__)

#: Ops per CHUNK frame (the store's chunk size; one frame stays small
#: enough to stream while a 16k-op key still ships in one piece).
CHUNK_OPS = 16384

#: Poll cadence while waiting on a verdict.
POLL_INTERVAL_S = 0.05

#: Client-side wait ceiling when neither a checker budget nor a time
#: limit bounds the request.
DEFAULT_DEADLINE_S = 3600.0

#: Ceiling on how long a client sleeps honoring a SHED's RETRY-AFTER
#: before moving on (next sibling / in-process fallback); a saturated
#: daemon can ask for patience, not captivity.
MAX_SHED_WAIT_S = 5.0


class RemoteUnavailable(Exception):
    """The daemon can't serve this request: unreachable, refused the
    model, protocol failure, or client-side deadline.  Triggers the
    in-process fallback."""


class ShedByServer(RemoteUnavailable):
    """The admission plane refused the COMMIT with a structured
    RETRY-AFTER (F_SHED) — an honest overload signal, not a failure.
    Subclasses RemoteUnavailable so unaware callers still fall back
    in-process; aware callers honor `retry_after_s` first."""

    def __init__(self, payload: dict):
        self.shed = overload.OverloadShed.from_payload(payload or {})
        super().__init__(
            f"shed by daemon ({self.shed.reason}); retry after "
            f"{self.shed.retry_after_s:.2f}s"
        )

    @property
    def retry_after_s(self) -> float:
        return self.shed.retry_after_s


class CheckerdClient:
    """One connection to a checkerd daemon."""

    def __init__(self, addr: str, *, connect_timeout: float = 3.0,
                 io_timeout: float = 60.0):
        self.addr = addr
        try:
            self.sock = connect(addr, timeout=connect_timeout)
        except OSError as e:
            raise RemoteUnavailable(
                f"checkerd at {addr}: {e}"
            ) from e
        self.sock.settimeout(io_timeout)
        self.rf = self.sock.makefile("rb")
        self.wf = self.sock.makefile("wb")

    def close(self) -> None:
        for f in (self.rf, self.wf, self.sock):
            try:
                f.close()
            except OSError:
                pass

    def __enter__(self) -> "CheckerdClient":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- wire helpers -------------------------------------------------------

    def _send(self, ftype: int, payload: Any) -> None:
        try:
            write_frame(self.wf, ftype, payload)
        except OSError as e:
            raise RemoteUnavailable(f"send failed: {e}") from e

    def _recv(self) -> tuple[int, Any]:
        try:
            self.wf.flush()
            fr = read_frame(self.rf)
        except (OSError, ProtocolError, socket.timeout) as e:
            raise RemoteUnavailable(f"recv failed: {e}") from e
        if fr is None:
            raise RemoteUnavailable("daemon closed the connection")
        if fr[0] == F_ERROR:
            raise RemoteUnavailable(
                f"daemon error: {fr[1].get('error')}"
            )
        if fr[0] == F_SHED:
            telemetry.count("checkerd.shed-received")
            raise ShedByServer(fr[1])
        return fr

    # -- API ----------------------------------------------------------------

    def submit_ops(
        self,
        run: str,
        model_spec: dict,
        subs_ops: list[list[dict]],
        *,
        algorithm: str = "wgl-tpu",
        budget_s: Optional[float] = None,
        time_limit_s: Optional[float] = None,
        trace: Optional[dict] = None,
        tenant: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> str:
        """Submits per-key op-dict lists (submit order = reply order);
        returns the poll ticket.  `trace` is the submitting run's
        telemetry.trace_context(); daemon-side spans for this request
        are stamped with it so they nest under the run's analyze span.
        `deadline_s` is the client's total patience: a daemon that
        predicts it can't answer in time sheds at COMMIT (ShedByServer)
        instead of wasting both sides' budget."""
        self._send(F_SUBMIT, {
            "run": run,
            "model": model_spec,
            "algorithm": algorithm,
            "n-keys": len(subs_ops),
            "packed": False,
            "budget-s": budget_s,
            "time-limit-s": time_limit_s,
            "tenant": tenant,
            "deadline-s": deadline_s,
            "trace": trace,
        })
        for i, ops in enumerate(subs_ops):
            for lo in range(0, len(ops), CHUNK_OPS) or (0,):
                self._send(F_CHUNK, {
                    "key": i, "ops": ops[lo:lo + CHUNK_OPS],
                })
        self._send(F_COMMIT, {})
        ftype, payload = self._recv()
        if ftype != F_TICKET:
            raise RemoteUnavailable(f"expected TICKET, got {ftype}")
        return payload["ticket"]

    def submit_packed(
        self,
        run: str,
        model_spec: dict,
        packs: list,
        *,
        algorithm: str = "wgl-tpu",
        budget_s: Optional[float] = None,
        time_limit_s: Optional[float] = None,
        trace: Optional[dict] = None,
        tenant: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> str:
        """Submits already-packed columnar histories (history/packed.py
        PackedOps) as binary frames — the bulk-transport path."""
        from ..history.packed import packed_to_bytes

        self._send(F_SUBMIT, {
            "run": run,
            "model": model_spec,
            "algorithm": algorithm,
            "n-keys": len(packs),
            "packed": True,
            "budget-s": budget_s,
            "time-limit-s": time_limit_s,
            "tenant": tenant,
            "deadline-s": deadline_s,
            "trace": trace,
        })
        for i, p in enumerate(packs):
            self._send(F_PACKED, pack_key_frame(i, packed_to_bytes(p)))
        self._send(F_COMMIT, {})
        ftype, payload = self._recv()
        if ftype != F_TICKET:
            raise RemoteUnavailable(f"expected TICKET, got {ftype}")
        return payload["ticket"]

    def poll(self, ticket: str) -> tuple[int, dict]:
        self._send(F_POLL, {"ticket": ticket})
        return self._recv()

    def wait(
        self,
        ticket: str,
        *,
        deadline_s: Optional[float] = None,
        interval_s: float = POLL_INTERVAL_S,
    ) -> dict:
        """Polls until RESULT; RemoteUnavailable past the deadline."""
        t0 = time.monotonic()
        while True:
            ftype, payload = self.poll(ticket)
            if ftype == F_RESULT:
                return payload
            if ftype != F_PENDING:
                raise RemoteUnavailable(
                    f"expected PENDING/RESULT, got {ftype}"
                )
            if (deadline_s is not None
                    and time.monotonic() - t0 > deadline_s):
                raise RemoteUnavailable(
                    f"no verdict for ticket {ticket} within "
                    f"{deadline_s} s"
                )
            time.sleep(interval_s)

    def stats(self) -> dict:
        self._send(F_STATS, {})
        ftype, payload = self._recv()
        if ftype != F_STATS_REPLY:
            raise RemoteUnavailable(f"expected STATS_REPLY, got {ftype}")
        return payload


def fetch_stats(addr: str, *, timeout: float = 2.0) -> dict:
    """One-shot stats of a daemon or a router (the router's health
    probe and placement gauge)."""
    with CheckerdClient(addr, connect_timeout=timeout,
                        io_timeout=timeout) as c:
        return c.stats()


class RemoteChecker(Checker):
    """Routes a linearizable check through a checkerd daemon.

    `base` is the checker a plain run would use: an IndependentChecker
    whose base is Linearizable (per-key mode) or a bare Linearizable
    (whole-history mode).  Anything the daemon can't serve — and any
    transport failure — checks in-process via `base` instead.
    """

    #: The daemon applies the checker budget per request; check_safe
    #: must not race a local watchdog against it (Compose-style
    #: exemption, checker/core.py).
    supervises_children = True

    def __init__(
        self,
        base: Checker,
        addr: str,
        *,
        run_id: Optional[str] = None,
        fallback: bool = True,
        connect_timeout: float = 3.0,
        tenant: Optional[str] = None,
    ):
        self.base = base
        #: Admission identity for the daemon's weighted fair queue;
        #: None lets the daemon fall back to the run name.
        self.tenant = tenant
        #: Comma-separated addresses are a failover chain: a dead
        #: daemon's ticket is retried against the next sibling (full
        #: re-submission from the client's own copy of the ops) before
        #: the in-process fallback.  A federation router counts as one
        #: address — it fails over internally with its journaled bytes.
        self.addrs = [a.strip() for a in addr.split(",") if a.strip()]
        self.addr = self.addrs[0] if self.addrs else addr
        self.run_id = run_id
        self.fallback = fallback
        self.connect_timeout = connect_timeout

    # -- checker plumbing ---------------------------------------------------

    def _lin(self):
        from ..checker.linearizable import Linearizable
        from ..parallel.independent import IndependentChecker

        if isinstance(self.base, IndependentChecker) and \
                isinstance(self.base.base, Linearizable):
            return self.base.base, True
        if isinstance(self.base, Linearizable):
            return self.base, False
        return None, False

    def check(self, test: dict, history, opts: dict) -> dict:
        try:
            return self._remote(test, history, opts)
        except RemoteUnavailable as e:
            telemetry.count("checkerd.fallback")
            log.warning(
                "checkerd unavailable (%s); checking in-process", e,
            )
            if not self.fallback:
                return {"valid": "unknown",
                        "error": f"checkerd unavailable: {e}"}
            # In-process fallback keeps full checker_budget semantics:
            # base doesn't supervise children, so check_safe arms the
            # local watchdog from test["checker_budget"].
            res = check_safe(self.base, test, history, opts)
            if isinstance(res, dict):
                res.setdefault("checkerd", {})["fallback"] = str(e)
            return res

    def _remote(self, test: dict, history, opts: dict) -> dict:
        from ..parallel.independent import subhistories

        lin, independent = self._lin()
        if lin is None:
            raise RemoteUnavailable(
                f"base checker {type(self.base).__name__} has no "
                f"remote form"
            )
        model = lin.model or test.get("model")
        if model is None:
            raise RemoteUnavailable("no model to describe to the daemon")
        spec = model_to_spec(model)
        if spec is None:
            raise RemoteUnavailable(
                f"model {type(model).__name__} has no wire spec"
            )

        if independent:
            subs = subhistories(history)
            keys = list(subs)
            if not keys:
                return {"valid": True, "results": {}, "key-count": 0}
            subs_ops = [[o.to_dict() for o in subs[k]] for k in keys]
        else:
            keys = [None]
            subs_ops = [[o.to_dict() for o in history]]

        budget = (test or {}).get("checker_budget")
        run = self.run_id or str((test or {}).get("name") or "run")
        deadline = DEFAULT_DEADLINE_S
        if budget is not None or lin.time_limit_s is not None:
            deadline = (budget or 0.0) + (lin.time_limit_s or 0.0) + 300.0

        # The failover chain: each address gets a full attempt (its own
        # streamed ticket if one exists, else a fresh submission).  A
        # daemon dying mid-wait surfaces as RemoteUnavailable and the
        # next sibling re-checks the same ops — per-key verdicts are
        # deterministic, so the retried result matches what the dead
        # daemon would have returned.  Each address sits behind a
        # process-wide circuit breaker (overload.breaker_for): an
        # address that keeps failing is skipped for a jittered backoff
        # window instead of eating a connect timeout per run, and a
        # half-open probe re-admits it.  An honest SHED is not a
        # failure — the breaker stays closed, the client sleeps out the
        # (bounded) RETRY-AFTER once, retries, then moves on.
        last: Optional[RemoteUnavailable] = None
        payload = None
        served_by = self.addr
        for n, addr in enumerate(self.addrs):
            if n:
                telemetry.count("checkerd.failover")
                log.warning(
                    "checkerd %s failed (%s); retrying ticket against "
                    "sibling %s", self.addrs[n - 1], last, addr,
                )
            br = overload.breaker_for(addr)
            if not br.allow():
                telemetry.count("checkerd.breaker-skip")
                last = RemoteUnavailable(
                    f"circuit open for {addr} (recent failures)"
                )
                continue
            for shed_try in (0, 1):
                try:
                    payload = self._attempt(
                        addr, test, keys, subs_ops, spec, lin,
                        independent, run, budget, deadline,
                    )
                    br.record_success()
                    served_by = addr
                    break
                except ShedByServer as e:
                    # The daemon answered — it's healthy, just full.
                    br.record_success()
                    telemetry.count("checkerd.client-shed")
                    last = e
                    if shed_try == 0:
                        wait = min(e.retry_after_s, MAX_SHED_WAIT_S)
                        log.info(
                            "checkerd %s shed the request; honoring "
                            "retry-after %.2fs", addr, wait,
                        )
                        time.sleep(wait)
                except RemoteUnavailable as e:
                    br.record_failure()
                    last = e
                    break
            if payload is not None:
                break
        if payload is None:
            raise last or RemoteUnavailable("no checkerd address")

        krs = payload.get("key-results") or []
        if len(krs) != len(keys):
            raise RemoteUnavailable(
                f"daemon returned {len(krs)} key results for "
                f"{len(keys)} keys"
            )
        meta = payload.get("checkerd") or {}
        meta["addr"] = served_by
        # Adopt the daemon's spans for this request into our trace, so
        # the run's trace.json (and tools/trace_merge.py) shows the
        # cohort/settle work under the daemon's own pid.
        telemetry.adopt_remote_events(meta.get("spans"),
                                      pid=meta.get("pid"))
        if not independent:
            res = dict(krs[0])
            res["checkerd"] = meta
            return res
        results = dict(zip(keys, krs))
        failures = [k for k, r in results.items()
                    if r.get("valid") is False]
        return {
            "valid": merge_valid(r.get("valid") for r in krs),
            "key-count": len(keys),
            "failures": failures[:32],
            "failure-count": len(failures),
            "results": results,
            "checkerd": meta,
        }

    def _attempt(
        self,
        addr: str,
        test: dict,
        keys: list,
        subs_ops: list,
        spec: dict,
        lin: Any,
        independent: bool,
        run: str,
        budget: Optional[float],
        deadline: float,
    ) -> dict:
        """One full submit-and-wait against one address."""
        # A streaming session may have shipped this exact submission
        # CHUNK-by-CHUNK while the run was still going (streaming/
        # remote.py); consume its ticket instead of re-uploading.
        ticket = None
        sess = (test or {}).get("streaming-session")
        if independent and sess is not None:
            ticket = sess.remote_ticket(
                addr, keys, spec, lin.algorithm, budget,
                lin.time_limit_s,
            )
            if ticket is not None:
                telemetry.count("checkerd.stream-ticket")
                log.info("consuming streamed checkerd ticket %s", ticket)

        with CheckerdClient(
            addr, connect_timeout=self.connect_timeout,
        ) as c:
            if ticket is None:
                ticket = c.submit_ops(
                    run, spec, subs_ops,
                    algorithm=lin.algorithm,
                    budget_s=budget,
                    time_limit_s=lin.time_limit_s,
                    trace=telemetry.trace_context()
                    if telemetry.enabled() else None,
                    tenant=self.tenant,
                    # The client's own wait ceiling rides the SUBMIT so
                    # the daemon can shed at COMMIT instead of checking
                    # into a void nobody is still polling.
                    deadline_s=deadline,
                )
            return c.wait(ticket, deadline_s=deadline)


def wrap_remote(checker: Checker, addr: str, *,
                run_id: Optional[str] = None) -> Checker:
    """Routes every remotable piece of a checker tree through the
    daemon: Linearizable and IndependentChecker-over-Linearizable become
    RemoteChecker; Compose children are wrapped recursively; anything
    else is returned unchanged."""
    from ..checker.core import Compose
    from ..checker.linearizable import Linearizable
    from ..parallel.independent import IndependentChecker

    if isinstance(checker, RemoteChecker):
        return checker
    if isinstance(checker, Compose):
        return Compose({name: wrap_remote(c, addr, run_id=run_id)
                        for name, c in checker.checkers.items()})
    if isinstance(checker, Linearizable):
        return RemoteChecker(checker, addr, run_id=run_id)
    if isinstance(checker, IndependentChecker) and \
            isinstance(checker.base, Linearizable):
        return RemoteChecker(checker, addr, run_id=run_id)
    return checker
