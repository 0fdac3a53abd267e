"""Streamed checkerd upload: ship the history to the daemon WHILE the
run generates it.

The port's copy of `jepsen_tpu/streaming/remote.py`, frame for frame
the reference's, so it feeds a daemon or router of either package.  It
is host code: the daemon it feeds checks on its own device.

Reuses the existing SUBMIT/CHUNK/COMMIT frames (checkerd/protocol.py)
on one long-lived connection: SUBMIT goes out with `streaming: true`
and a deferred key count, routed per-key op dicts ride CHUNK frames as
the run produces them, and COMMIT at finish() carries the final
`n-keys` — by which time the daemon already holds the whole history,
so the ticket is poll-ready almost immediately.  RemoteChecker then
consumes the ticket at analyze (`ticket_for`) instead of re-uploading,
iff the submission it WOULD have made matches what was streamed (same
address, keys, model spec, algorithm, budget); any mismatch or feed
death just means the ordinary post-hoc submission happens — streaming
the upload can cost bandwidth, never the verdict.

Reconnect: the SUBMIT carries a client-minted session token and the
feed retains every op dict it has handed to the socket.  When the
connection dies mid-run, a RESUME on a fresh connection re-attaches to
the daemon's parked submission and learns its stable bound — the
per-key op counts that made it into FULL frames server-side — and the
feed re-sends only each key's tail past that bound
(`wgl.online.remote-resumed`), instead of abandoning the upload and
falling back to a whole-history post-hoc submit.  No encoder interner
state crosses the wire for this: ops mode re-encodes deterministically
daemon-side, so the received-op counts ARE the snapshot.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Optional

from .. import telemetry
from ..history.core import Op

log = logging.getLogger(__name__)

#: Ops accumulated before a CHUNK frame goes out (smaller than the
#: client's bulk CHUNK_OPS: mid-run frames should flow, not pool).
FLUSH_OPS = 1024
#: ...and at least this often while ops trickle.
FLUSH_INTERVAL_S = 0.25


def remote_feed_for(addr: str, test: dict, model: Any) -> Optional["RemoteFeed"]:
    """A RemoteFeed mirroring exactly the submission RemoteChecker
    would make for this test, or None when the checker tree has no
    per-key remotable piece (then there is nothing to stream)."""
    from ..checker.core import Compose
    from ..checker.linearizable import Linearizable
    from ..checkerd.protocol import model_to_spec
    from ..parallel.independent import IndependentChecker

    def find_lin(c: Any) -> Optional[Linearizable]:
        if isinstance(c, IndependentChecker) and \
                isinstance(c.base, Linearizable):
            return c.base
        if isinstance(c, Compose):
            for child in c.checkers.values():
                lin = find_lin(child)
                if lin is not None:
                    return lin
        return None

    lin = find_lin(test.get("checker"))
    if lin is None:
        return None
    spec = model_to_spec(lin.model or model)
    if spec is None:
        return None
    return RemoteFeed(
        addr,
        run=str(test.get("name") or "run"),
        model_spec=spec,
        algorithm=lin.algorithm,
        budget_s=test.get("checker_budget"),
        time_limit_s=lin.time_limit_s,
    )


class RemoteFeed:
    """One streamed submission.  `put(key, op)` from the session's
    checker thread; `commit(keys)` once at finish; `ticket_for(...)`
    from RemoteChecker at analyze."""

    def __init__(self, addr: str, *, run: str, model_spec: dict,
                 algorithm: str, budget_s: Optional[float],
                 time_limit_s: Optional[float]):
        import uuid

        self.addr = addr
        self.run = run
        self.model_spec = model_spec
        self.algorithm = algorithm
        self.budget_s = budget_s
        self.time_limit_s = time_limit_s

        self.dead: Optional[str] = None
        self.ticket: Optional[str] = None
        self.ops_sent = 0
        self.resumes = 0
        self.ops_resent = 0
        #: Resume token minted per feed; the daemon parks the
        #: submission under it when our connection dies.
        self.session = uuid.uuid4().hex
        #: Everything handed to the socket, per key index — the local
        #: half of the resume protocol.  The dicts are the same objects
        #: the queue held, so the cost is one list slot per op.
        self._sent_ops: dict[int, list[dict]] = {}

        self._client = None
        self._keys: list = []            # first-seen order == key index
        self._index: dict = {}
        self._lock = threading.Lock()
        self._queue: list = []           # (key index, op dict)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="streaming-remote", daemon=True
        )
        self._thread.start()

    # -- session side --------------------------------------------------------

    def put(self, key: Any, op: Op) -> None:
        """Enqueues one routed per-key op for upload."""
        i = self._index.get(key)
        if i is None:
            i = self._index[key] = len(self._keys)
            self._keys.append(key)
        with self._lock:
            if self.dead:
                return
            self._queue.append((i, op.to_dict()))
            if len(self._queue) >= FLUSH_OPS:
                self._wake.set()

    def put_many(self, key: Any, ops: list) -> None:
        """put() for a per-key batch: one key lookup, the dict
        conversion outside the lock, one lock acquisition."""
        i = self._index.get(key)
        if i is None:
            i = self._index[key] = len(self._keys)
            self._keys.append(key)
        ods = [(i, op.to_dict()) for op in ops]
        with self._lock:
            if self.dead:
                return
            self._queue.extend(ods)
            if len(self._queue) >= FLUSH_OPS:
                self._wake.set()

    def commit(self, keys: list) -> None:
        """Drains the queue, finalizes the key count, collects the
        ticket.  `keys` is the session's first-seen key order — it must
        match what was streamed or the upload is abandoned."""
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=60.0)
        with self._lock:
            if self.dead:
                return
        if keys != self._keys:
            self._die("key order diverged from the session's")
            return
        try:
            self.ticket = self._commit_once()
        except Exception as e:  # noqa: BLE001
            # One reconnect attempt before giving up: COMMIT rides the
            # resumed connection, which already holds the full upload.
            if self._sent_ops and self._resume(f"{type(e).__name__}: {e}"):
                try:
                    self.ticket = self._commit_once()
                except Exception as e2:  # noqa: BLE001
                    self._die(f"{type(e2).__name__}: {e2}")
                    return
            else:
                self._die(f"{type(e).__name__}: {e}")
                return
        telemetry.count("wgl.online.remote-committed")
        with self._lock:
            sent = self.ops_sent
        log.info("streamed %d ops / %d keys to %s (ticket %s)",
                 sent, len(self._keys), self.addr, self.ticket)

    def _commit_once(self) -> str:
        from ..checkerd.protocol import F_COMMIT, F_TICKET

        self._flush()
        with self._lock:
            c = self._client
        if c is None:
            raise RuntimeError("nothing was streamed")
        c._send(F_COMMIT, {"n-keys": len(self._keys)})
        ftype, payload = c._recv()
        if ftype != F_TICKET:
            raise RuntimeError(f"expected TICKET, got {ftype}")
        return payload["ticket"]

    def ticket_for(self, addr: str, keys: list, model_spec: dict,
                   algorithm: str, budget_s: Any,
                   time_limit_s: Any) -> Optional[str]:
        """The ticket, iff this feed streamed the submission the caller
        is about to make."""
        if self.ticket is None:
            return None
        if (addr, keys, model_spec, algorithm, budget_s, time_limit_s) != \
                (self.addr, self._keys, self.model_spec, self.algorithm,
                 self.budget_s, self.time_limit_s):
            return None
        return self.ticket

    def stats(self) -> dict:
        with self._lock:
            out: dict = {"addr": self.addr, "ops-sent": self.ops_sent,
                         "keys": len(self._keys)}
            if self.ticket is not None:
                out["ticket"] = self.ticket
            if self.resumes:
                out["resumes"] = self.resumes
                out["ops-resent"] = self.ops_resent
            if self.dead:
                out["dead"] = self.dead
        return out

    # -- uploader thread -----------------------------------------------------

    def _die(self, reason: str) -> None:
        with self._lock:
            self.dead = reason
            self._queue = []
            c, self._client = self._client, None
        telemetry.count("wgl.online.remote-dead")
        log.info("streaming upload abandoned (post-hoc submit will "
                 "cover it): %s", reason)
        if c is not None:
            c.close()

    def _ensure_client(self) -> None:
        with self._lock:
            if self._client is not None:
                return
        from ..checkerd import overload
        from ..checkerd.client import CheckerdClient
        from ..checkerd.protocol import F_SUBMIT

        # Same process-wide breaker RemoteChecker consults: a daemon
        # that keeps refusing connections shouldn't cost this feed a
        # connect timeout per flush interval — abandon the stream (the
        # post-hoc submit covers it) until the breaker half-opens.
        br = overload.breaker_for(self.addr)
        if not br.allow():
            telemetry.count("checkerd.breaker-skip")
            raise RuntimeError(
                f"circuit open for {self.addr} (recent failures)"
            )
        try:
            c = CheckerdClient(self.addr)
        except Exception:
            br.record_failure()
            raise
        br.record_success()
        c._send(F_SUBMIT, {
            "run": self.run,
            "model": self.model_spec,
            "algorithm": self.algorithm,
            "n-keys": 0,
            "packed": False,
            "streaming": True,
            "session": self.session,
            "budget-s": self.budget_s,
            "time-limit-s": self.time_limit_s,
            # The run's trace context rides the streamed submission
            # too, so daemon spans for a mid-run feed still nest under
            # the run that generated the ops.
            "trace": telemetry.trace_context()
            if telemetry.enabled() else None,
        })
        c.wf.flush()
        with self._lock:
            self._client = c

    def _flush(self) -> None:
        from ..checkerd.protocol import F_CHUNK

        with self._lock:
            batch, self._queue = self._queue, []
        if not batch:
            return
        # Record intent before the socket sees anything: whatever the
        # send loses, the daemon's RESUME_OK counts tell us where in
        # these lists to restart from.
        for i, od in batch:
            self._sent_ops.setdefault(i, []).append(od)
        self._ensure_client()
        with self._lock:
            c = self._client
        # Coalesce runs of same-key ops into one CHUNK frame each.
        i0, ops = batch[0][0], []
        runs = []
        for i, od in batch:
            if i != i0:
                runs.append((i0, ops))
                i0, ops = i, []
            ops.append(od)
        runs.append((i0, ops))
        with telemetry.span("ingest.frame", frames=len(runs),
                            ops=len(batch)):
            for i, ops in runs:
                c._send(F_CHUNK, {"key": i, "ops": ops})
            c.wf.flush()
        with self._lock:
            self.ops_sent += len(batch)
        telemetry.count("wgl.online.remote-ops", len(batch))
        telemetry.count("ingest.frame.frames", len(runs))
        telemetry.count("ingest.frame.ops", len(batch))

    def _resume(self, why: str) -> bool:
        """Reconnects, re-attaches to the parked daemon-side submission
        via the session token, and re-sends each key's tail past the
        daemon's stable bound.  False means the fallback path (post-hoc
        submit) takes over."""
        from ..checkerd import overload
        from ..checkerd.client import CHUNK_OPS, CheckerdClient
        from ..checkerd.protocol import F_CHUNK, F_RESUME, F_RESUME_OK

        telemetry.count("wgl.online.remote-resume")
        log.info("streamed upload to %s interrupted (%s); resuming "
                 "session %s", self.addr, why, self.session[:8])
        with self._lock:
            c_old, self._client = self._client, None
        if c_old is not None:
            c_old.close()
        br = overload.breaker_for(self.addr)
        if not br.allow():
            telemetry.count("checkerd.breaker-skip")
            log.info("resume of session %s skipped: circuit open for "
                     "%s", self.session[:8], self.addr)
            return False
        c = None
        try:
            c = CheckerdClient(self.addr)
            c._send(F_RESUME, {"session": self.session})
            ftype, payload = c._recv()
            if ftype != F_RESUME_OK:
                raise RuntimeError(f"expected RESUME_OK, got {ftype}")
            received = payload.get("received") or {}
            resent = 0
            for i, ops in sorted(self._sent_ops.items()):
                have = int(received.get(str(i)) or 0)
                for lo in range(have, len(ops), CHUNK_OPS):
                    c._send(F_CHUNK, {
                        "key": i, "ops": ops[lo:lo + CHUNK_OPS],
                    })
                    resent += len(ops[lo:lo + CHUNK_OPS])
            c.wf.flush()
        except Exception as e:  # noqa: BLE001
            br.record_failure()
            if c is not None:
                c.close()
            log.info("resume of session %s failed (%s); abandoning the "
                     "stream", self.session[:8], e)
            return False
        br.record_success()
        with self._lock:
            self._client = c
            self.resumes += 1
            self.ops_resent += resent
        telemetry.count("wgl.online.remote-resumed")
        log.info("resumed session %s: re-sent %d of %d ops",
                 self.session[:8], resent,
                 sum(len(o) for o in self._sent_ops.values()))
        return True

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(FLUSH_INTERVAL_S)
            self._wake.clear()
            with self._lock:
                if self.dead:
                    return
            try:
                self._flush()
            except Exception as e:  # noqa: BLE001
                if self._sent_ops and \
                        self._resume(f"{type(e).__name__}: {e}"):
                    continue
                self._die(f"{type(e).__name__}: {e}")
                return
