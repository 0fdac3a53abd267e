"""Crash-safe checkerd queue journal: zero in-flight verdicts lost.

The port's copy of `jepsen_tpu/checkerd/journal.py`, record for record
the reference's, so a journal written by either package's daemon
replays in the other's.

`checkerd.queue` is an append-only journal in store/format.py framing
(`BLOCK_QUEUE` blocks, append + fsync per record, torn-tail truncation
free from BlockWriter — the same durability contract as the plan
memo).  Three record kinds:

* ``submit``  — one accepted submission, written the moment the
  scheduler admits it (before the TICKET reply leaves the daemon).
  Carries everything needed to rebuild the Request after a crash:
  op dicts per key and packed tensors as base64, so a restarted daemon
  re-forms cohorts through the normal plan compiler and warm-starts
  from the plan memo.
* ``result``  — the finished verdict, journaled BEFORE the request is
  marked done (the replay-idempotence rule: a poll can only ever
  observe a RESULT that is already durable, so replaying the journal
  after a crash reproduces exactly the verdicts clients saw).
* ``abandon`` — a ticket cancelled because its submitting connection
  died mid-PENDING; replay must not resurrect it.

A ticket with a ``submit`` record but no ``result``/``abandon`` is
*unfinished*: the restarted daemon re-queues it under its original
ticket id so a reconnecting client's POLL keeps working.  Fresh
``result`` records survive restart too (late polls get the same bytes);
stale ones are dropped by compaction on open.

The federation router (router.py) keeps its own ticket journal in this
class: `frames_to_record`/`frames_from_record` serialize raw wire
frames (PACKED payloads as base64) so a failed daemon's ticket can be
re-submitted to a sibling byte-identically.
"""

from __future__ import annotations

import base64
import logging
import os
import threading
import time
from typing import Any, Optional

from .. import telemetry
from ..store import format as fmt

log = logging.getLogger(__name__)

QUEUE_FILE = "checkerd.queue"

#: Fault-injection hook: set to "enospc" and every journal append fails
#: like a full --queue disk.  ``file:PATH`` indirects through a file's
#: contents (overload._env_indirect) so a harness toggles the fault in
#: a live child daemon.  Read per append, same pattern as
#: ops/degrade.maybe_fault, so a daemon under test flips behavior
#: without restart.  The append path already treats OSError as a
#: degraded-durability signal (checkerd.queue.append-failed), never a
#: crash.
FAULT_ENV = "JEPSEN_QUEUE_FAULT"


def _maybe_disk_fault() -> None:
    import errno

    from .overload import _env_indirect

    if _env_indirect(os.environ.get(FAULT_ENV)) == "enospc":
        raise OSError(errno.ENOSPC,
                      f"injected disk-full ({FAULT_ENV}=enospc)")

#: Finished-ticket results are kept across restarts this long (matches
#: the scheduler's in-memory _RESULT_TTL_S) so late polls after a crash
#: still see their verdict; older ones fall to compaction.
KEEP_RESULTS_S = 600.0


class QueueJournal:
    """The durable ticket queue.  Thread-safe; one instance per file."""

    def __init__(self, path: str, *, keep_results_s: float = KEEP_RESULTS_S):
        self.path = path
        self.keep_results_s = keep_results_s
        self._lock = threading.Lock()
        self._submits: dict[str, dict] = {}
        self._submit_ts: dict[str, float] = {}
        self._results: dict[str, dict] = {}
        self._result_ts: dict[str, float] = {}
        self._abandoned: set[str] = set()
        self.loaded = 0
        self.appended = 0
        self.torn = False
        self.compacted = 0
        self._writer: Optional[fmt.BlockWriter] = None
        self._load()

    # -- recovery ------------------------------------------------------------

    def _load(self) -> None:
        """Replays the journal, detects a torn tail, compacts dead
        records, and opens the writer (whose constructor truncates any
        torn tail before we append)."""
        size = 0
        if os.path.exists(self.path):
            size = os.path.getsize(self.path)
            try:
                with open(self.path, "rb") as f:
                    if f.read(len(fmt.MAGIC)) == fmt.MAGIC:
                        end = len(fmt.MAGIC)
                        while True:
                            rec = fmt._read_block(f, size)
                            if rec is None:
                                break
                            end = f.tell()
                            _, btype, payload = rec
                            if btype != fmt.BLOCK_QUEUE:
                                continue
                            self._absorb(payload)
                            self.loaded += 1
                        if end < size:
                            self.torn = True
                            telemetry.count("checkerd.queue.torn-tail")
                            log.warning(
                                "queue journal %s: torn tail truncated "
                                "(%d of %d bytes valid)",
                                self.path, end, size,
                            )
            except OSError as e:
                log.warning("queue journal %s unreadable: %r", self.path, e)
        dead = self._drop_stale()
        if dead or self.torn:
            self._compact(size)
        self._writer = fmt.BlockWriter(self.path)

    def _absorb(self, payload: Any) -> None:
        if not isinstance(payload, dict):
            return
        kind = payload.get("rec")
        ticket = payload.get("ticket")
        if not isinstance(ticket, str):
            return
        if kind == "submit" and isinstance(payload.get("req"), dict):
            self._submits[ticket] = payload["req"]
            self._submit_ts[ticket] = float(payload.get("ts") or 0.0)
        elif kind == "result" and isinstance(payload.get("result"), dict):
            self._results[ticket] = payload["result"]
            self._result_ts[ticket] = float(payload.get("ts") or 0.0)
        elif kind == "abandon":
            self._abandoned.add(ticket)

    def _drop_stale(self) -> int:
        """Removes abandoned tickets and expired results from the
        in-memory view; returns how many records compaction can shed
        (finished tickets' submit records are dead weight too — the
        result alone answers late polls)."""
        now = time.time()
        dead = 0
        for t in self._abandoned:
            if self._submits.pop(t, None) is not None:
                self._submit_ts.pop(t, None)
                dead += 1
        dead += len(self._abandoned)
        self._abandoned.clear()
        for t in [t for t, ts in self._result_ts.items()
                  if now - ts > self.keep_results_s]:
            del self._results[t]
            del self._result_ts[t]
            dead += 1
        for t in [t for t in self._results if t in self._submits]:
            del self._submits[t]
            self._submit_ts.pop(t, None)
            dead += 1
        return dead

    def _compact(self, old_size: int) -> None:
        """Rewrites the journal with only live records (unfinished
        submits + fresh results), atomically via tmp + rename."""
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(fmt.MAGIC)
                for t, req in self._submits.items():
                    # Original submit time, not now(): compaction must
                    # never grow a record (torn-tail truncation promises
                    # size monotonically shrinks) and the ts is the
                    # submission's, not the rewrite's.
                    f.write(fmt.frame(fmt.BLOCK_QUEUE, {
                        "rec": "submit", "ticket": t, "req": req,
                        "ts": self._submit_ts.get(t, 0.0),
                    }))
                for t, res in self._results.items():
                    f.write(fmt.frame(fmt.BLOCK_QUEUE, {
                        "rec": "result", "ticket": t, "result": res,
                        "ts": self._result_ts.get(t, 0.0),
                    }))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self.compacted += 1
            telemetry.count("checkerd.queue.compacted")
            log.info("queue journal %s compacted (%d -> %d bytes)",
                     self.path, old_size, os.path.getsize(self.path))
        except OSError as e:
            log.warning("queue journal compaction failed: %r", e)
            try:
                os.unlink(tmp)
            except OSError as e2:
                log.debug("queue journal tmp cleanup failed: %r", e2)

    # -- the append path -----------------------------------------------------

    def _append(self, payload: dict) -> bool:
        with self._lock:
            if self._writer is None:
                return False
            try:
                _maybe_disk_fault()
                self._writer.append(fmt.BLOCK_QUEUE, payload)
                self._writer.sync()
                self.appended += 1
            except (OSError, TypeError, ValueError) as e:
                telemetry.count("checkerd.queue.append-failed")
                log.warning("queue journal append failed: %r", e)
                return False
        telemetry.count("checkerd.queue.append")
        return True

    def record_submit(self, ticket: str, req: dict) -> bool:
        """Journals one accepted submission.  Must complete before the
        TICKET reply: a ticket the client can poll is a ticket the
        journal can replay."""
        now = round(time.time(), 3)
        with self._lock:
            self._submits[ticket] = req
            self._submit_ts[ticket] = now
        return self._append({
            "rec": "submit", "ticket": ticket, "req": req, "ts": now,
        })

    def record_result(self, ticket: str, result: dict) -> bool:
        """Journals the verdict.  Must complete before the request is
        marked done (the replay-idempotence rule)."""
        now = round(time.time(), 3)
        with self._lock:
            self._results[ticket] = result
            self._result_ts[ticket] = now
            self._submits.pop(ticket, None)
            self._submit_ts.pop(ticket, None)
        return self._append({
            "rec": "result", "ticket": ticket, "result": result, "ts": now,
        })

    def record_abandon(self, ticket: str) -> bool:
        with self._lock:
            self._submits.pop(ticket, None)
            self._submit_ts.pop(ticket, None)
        return self._append({
            "rec": "abandon", "ticket": ticket, "ts": round(time.time(), 3),
        })

    # -- the replay view -----------------------------------------------------

    def unfinished(self) -> dict[str, dict]:
        """ticket -> submit record for every accepted submission with
        no durable verdict — what a restarted daemon must re-queue."""
        with self._lock:
            return dict(self._submits)

    def finished(self) -> dict[str, dict]:
        """ticket -> result for verdicts that must answer late polls."""
        with self._lock:
            return dict(self._results)

    def stats(self) -> dict:
        with self._lock:
            return {
                "path": self.path,
                "loaded": self.loaded,
                "appended": self.appended,
                "unfinished": len(self._submits),
                "finished": len(self._results),
                "torn-tail": self.torn,
                "compactions": self.compacted,
            }

    def close(self) -> None:
        with self._lock:
            if self._writer is not None:
                try:
                    self._writer.close()
                except OSError as e:
                    log.debug("queue journal close failed: %r", e)
                self._writer = None


# ---------------------------------------------------------------------------
# Request <-> record codecs (scheduler side)
# ---------------------------------------------------------------------------


def request_to_record(req: Any) -> dict:
    """Serializes a scheduler Request to a JSON-able journal record.
    Ops keep their original indices (reindex=False on replay) so
    replayed certificates cite the same history positions; packed
    tensors ride as base64 of the columnar wire bytes."""
    from ..history.packed import packed_to_bytes

    return {
        "run": req.run,
        "model": req.model_spec,
        "algorithm": req.algorithm,
        "n-keys": req.n_keys,
        "budget-s": req.budget_s,
        "time-limit-s": req.time_limit_s,
        "tenant": req.tenant,
        # The deadline is relative to the ORIGINAL submission; a
        # replayed request is already admitted, so replay never
        # re-sheds it — the field rides along for forensics only.
        "deadline-s": req.deadline_s,
        "trace": req.trace,
        "subs": {
            str(i): req.wire_ops.get(i) or h.to_dicts()
            for i, h in req.subs.items()
        },
        "packs": {
            str(i): base64.b64encode(packed_to_bytes(p)).decode("ascii")
            for i, p in req.packs.items()
        },
    }


def request_from_record(rec: dict) -> Any:
    """Rebuilds a Request from a journal record (raises on a corrupt
    record; the caller skips and counts it)."""
    from ..history.core import History
    from ..history.packed import packed_from_bytes
    from .scheduler import Request

    subs = {
        int(i): History(ops, reindex=False)
        for i, ops in (rec.get("subs") or {}).items()
    }
    packs = {
        int(i): packed_from_bytes(base64.b64decode(b64))
        for i, b64 in (rec.get("packs") or {}).items()
    }
    return Request(
        run=str(rec.get("run") or "anonymous"),
        model_spec=rec.get("model") or {},
        algorithm=str(rec.get("algorithm") or "wgl-tpu"),
        n_keys=int(rec.get("n-keys") or 0),
        budget_s=rec.get("budget-s"),
        time_limit_s=rec.get("time-limit-s"),
        subs=subs,
        packs=packs,
        trace=rec.get("trace"),
        tenant=rec.get("tenant"),
    )


# ---------------------------------------------------------------------------
# Wire-frame <-> record codecs (router side)
# ---------------------------------------------------------------------------


def frames_to_record(frames: list) -> list:
    """Serializes captured wire frames ((ftype, payload) pairs; PACKED
    payloads are raw bytes) for the router's journal, so a dead
    daemon's ticket replays byte-identically against a sibling."""
    out = []
    for ftype, payload in frames:
        if isinstance(payload, (bytes, bytearray)):
            out.append({
                "t": int(ftype),
                "b64": base64.b64encode(bytes(payload)).decode("ascii"),
            })
        else:
            out.append({"t": int(ftype), "p": payload})
    return out


def frames_from_record(entries: list) -> list:
    frames = []
    for e in entries:
        if "b64" in e:
            frames.append((int(e["t"]), base64.b64decode(e["b64"])))
        else:
            frames.append((int(e["t"]), e.get("p")))
    return frames
