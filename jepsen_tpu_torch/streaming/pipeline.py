"""The double-buffered online checking session.

The port of `jepsen_tpu/streaming/pipeline.py`.  Dataflow::

    producer threads                   checker thread (daemon)
    ────────────────                   ───────────────────────
    feed(op) ──► buffer A              buffer B ──► ingest
                 (append under lock)     │  per-key PackedBuilder
                                         │  quiet keys -> stream witness
                  swap every             │  batch (device)
                  ~50 ms / 2048 ops ◄────┘  big streams -> frontier
                                            advance (device)

One buffer fills on the producer side while the checker thread routes,
packs and checks the other's ops on the device, so the producer never
waits on checking.

Verdicts are recorded against the packed digest of the key's history at
proof time (`parallel.independent._settle_digest`).  The post-hoc
checkers re-pack each key and take a verdict only when the digests
match: a key that received ops after its proof is proven again or falls
back, never served stale.  A dropped proof evicts its settle-memo entry
(`invalidate_settle_memo`).

Faults.  A host fault on the checker thread (a KV op in single-stream
mode, a bug) breaks the session as in the reference: feed() stops
taking ops and the post-hoc checkers find no verdicts.  A fault of the
card or of a kernel (`degrade.is_device_fault`) is not hidden that way:
the thread keeps it, feed() stops taking ops, and finish() raises it.
finish() joins the checker thread before it finalizes on the caller's
thread, and raises if the thread does not stop, so two threads never
touch the packers or launch on the card at once.

Counts "online_rechecks" and "online_consumed" in `device.counters`
(the frontiers count theirs), and the reference's `wgl.online.*`
telemetry; finish() writes the "frontier" profile record.  Each
stream batch takes its segment and restart knobs from the cost
model (`choose_stream_knobs`) and the finalize its chunk rows
(`choose_finalize_chunk_rows`); untrained, or with `JEPSEN_PLAN=0`,
both are the hand formulas.  With a `remote` feed (streaming/remote.py
`RemoteFeed`) the session mirrors each key's routed ops to a checkerd
daemon or router as it ingests them, and commits the upload at
finish().  Not ported: the SLO and time-series hooks.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Optional, Union

import torch

from .. import device as _device
from .. import telemetry
from ..history.core import Op
from ..history.packed import PackedBuilder
from ..models.base import PackedModel
from ..ops import degrade
from ..telemetry import profile
from .frontier import FrontierCarry

log = logging.getLogger(__name__)

#: Swap the buffers at least this often even when the run is slow...
SWAP_INTERVAL_S = 0.05
#: ...and as soon as this many ops are waiting.
SWAP_OPS = 2048
#: Single-stream mode: re-plan and advance the frontier only after this
#: many new rows (each advance plans the whole prefix on the host, so
#: this bounds planning to O(n^2 / ADVANCE_ROWS)).
ADVANCE_ROWS = 32768
#: Keyed mode: a key past this many rows leaves the batched whole-key
#: rechecks for a FrontierCarry of its own.
FRONTIER_ROWS = 65536
#: Keyed mode: a still-growing key is proven again only once it has
#: this many rows more than at its last proof.
RECHECK_MIN_ROWS = 256
#: How long finish() waits for the checker thread to stop.
JOIN_TIMEOUT_S = 60.0


class DoubleBuffer:
    """The producer half of the pipeline: `put` appends to the filling
    list, `take` swaps it out whole, under one lock."""

    __slots__ = ("_lock", "_filling")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._filling: list = []

    def put(self, item: Any) -> int:
        with self._lock:
            self._filling.append(item)
            return len(self._filling)

    def take(self) -> list:
        with self._lock:
            batch, self._filling = self._filling, []
            return batch


class StreamingSession:
    """Online checker for one run.  `feed(op)` from the producer;
    `finish()` once the run ends (drains, finalizes, measures the
    verdict lag); `consume(key, digest)` from the post-hoc checkers.

    The mode comes from the first client invoke: a `KV` payload means a
    keyed (independent) workload, with per-key packers and batched
    stream-witness proofs; anything else one stream, checked by one
    incremental `FrontierCarry`.  Device work runs on `device` (the
    card by default; raises at once when CUDA is asked for but
    missing)."""

    MODE_KEYED = "keyed"
    MODE_SINGLE = "single"

    def __init__(
        self,
        pm: PackedModel,
        *,
        swap_interval_s: float = SWAP_INTERVAL_S,
        swap_ops: int = SWAP_OPS,
        advance_rows: int = ADVANCE_ROWS,
        recheck_min_rows: int = RECHECK_MIN_ROWS,
        device: Union[str, torch.device, None] = "cuda",
        remote: Optional[Any] = None,
        run_id: str = "run",
    ):
        self.pm = pm
        self.dev = _device.resolve(device)
        self.swap_interval_s = swap_interval_s
        self.swap_ops = swap_ops
        self.advance_rows = advance_rows
        self.recheck_min_rows = recheck_min_rows
        self.run_id = run_id

        self.mode: Optional[str] = None
        self.finished = False
        self.broken = False
        self.broken_reason: Optional[str] = None
        self.verdict_lag_s: Optional[float] = None
        #: a device fault the checker thread met, raised by finish()
        self.fault: Optional[BaseException] = None

        self._buf = DoubleBuffer()
        self._wake = threading.Event()
        self._stop = threading.Event()

        #: ops seen before the first client invoke (mode unknown),
        #: replayed ahead of the batch that decides the mode
        self._carry: list = []
        # keyed mode
        self._pending: dict = {}       # process -> key (in-flight route)
        self._packers: dict = {}      # key -> PackedBuilder
        self._changed: dict = {}       # key -> True (ops since last check)
        self._checked_rows: dict = {}  # key -> n_rows at last attempt
        self._frontiers: dict = {}     # key -> FrontierCarry (big keys)
        self._fr_rows: dict = {}       # key -> n_rows at last advance
        # single mode
        self._packer: Optional[PackedBuilder] = None
        self._frontier: Optional[FrontierCarry] = None
        self._adv_rows = 0

        #: key (None for a single stream) -> {"digest", "res"}
        self._verdicts: dict = {}
        #: key -> digest of the pack at its last witness attempt: the
        #: witness is deterministic, so finalize skips a key whose pack
        #: has not changed since (an invalid key would otherwise run its
        #: stream restart again inside the verdict lag)
        self._attempted: dict = {}
        #: most rows one mid-run stream batch carried; finalize batches
        #: to half of it
        self._stream_rows_hwm = 0

        self._ops_ingested = 0
        self._swaps = 0
        self._rechecks = 0
        self._checks = 0  # stream-witness batches

        #: streaming/remote.py RemoteFeed, already configured to mirror
        #: the submission RemoteChecker would make, or None.
        self._remote = remote

        self._thread = threading.Thread(
            target=self._loop, name="streaming-checker", daemon=True)
        self._thread.start()

    # -- producer side -------------------------------------------------------

    def feed(self, op: Op) -> None:
        """Appends one journal op; cheap and non-blocking."""
        if self.broken or self.finished or self.fault is not None:
            return
        if self._buf.put(op) >= self.swap_ops:
            self._wake.set()

    # -- checker thread -------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.swap_interval_s)
            self._wake.clear()
            batch = self._buf.take()
            if not batch:
                continue
            try:
                self._ingest(batch)
            except Exception as e:  # noqa: BLE001 — the thread's boundary
                if degrade.is_device_fault(e):
                    log.error("streaming checker: device fault",
                              exc_info=True)
                    self.fault = e
                    return
                self._break(f"{type(e).__name__}: {e}", e)

    def _break(self, reason: str,
               exc: Optional[BaseException] = None) -> None:
        self.broken = True
        self.broken_reason = reason
        telemetry.count("wgl.online.broken")
        log.warning("streaming session broken, falling back post-hoc: %s",
                    reason, exc_info=exc)

    def _ingest(self, batch: list) -> None:
        self._swaps += 1
        self._ops_ingested += len(batch)
        telemetry.count("wgl.online.ops-ingested", len(batch))
        with telemetry.span("wgl.online.swap", ops=len(batch)):
            if self.mode is None:
                if self._carry:
                    batch = self._carry + batch
                    self._carry = []
                self._detect_mode(batch)
            if self.mode == self.MODE_KEYED:
                self._ingest_keyed(batch)
            elif self.mode == self.MODE_SINGLE:
                self._ingest_single(batch)
            else:
                # No client invoke yet: hold the ops, in order, until
                # the mode-deciding invoke lands.
                self._carry = batch

    def _detect_mode(self, batch: list) -> None:
        from ..parallel.independent import KV

        for op in batch:
            if op.is_invoke and op.is_client_op:
                self.mode = (self.MODE_KEYED if isinstance(op.value, KV)
                             else self.MODE_SINGLE)
                log.info("streaming session: %s mode", self.mode)
                if self.mode == self.MODE_SINGLE:
                    self._packer = PackedBuilder(self.pm.encode)
                    self._frontier = FrontierCarry(self.pm, device=self.dev)
                return

    # -- keyed (independent) mode --------------------------------------------

    def _route(self, o: Op):
        """`parallel.independent.subhistories` one op at a time — the
        same pending map, KV unwrap and drops — so each key's op
        sequence (and so its digest) is what the post-hoc checker
        derives from the whole history."""
        from ..parallel.independent import KV

        val = o.value
        if isinstance(val, KV):
            if o.is_invoke:
                self._pending[o.process] = val.key
            else:
                self._pending.pop(o.process, None)
            return val.key, o.replace(value=val.value)
        if not o.is_invoke and o.process in self._pending:
            return self._pending.pop(o.process), o.replace(value=val)
        return None, None

    def _ingest_keyed(self, batch: list) -> None:
        # Route one op at a time (the pending map is sequential), then
        # append each touched key's ops in one columnar call.
        routed_by_key: dict = {}
        for op in batch:
            k, routed = self._route(op)
            if routed is not None:
                routed_by_key.setdefault(k, []).append(routed)
        for k, rops in routed_by_key.items():
            b = self._packers.get(k)
            if b is None:
                b = self._packers[k] = PackedBuilder(self.pm.encode)
            b.append_many(rops)
            if self._remote is not None:
                self._remote.put_many(k, rops)
        for k in routed_by_key:
            self._changed[k] = True
            v = self._verdicts.pop(k, None)
            if v is not None:
                # The key grew past its proof: the verdict, and its
                # memoized copy, describe a history that no longer is.
                self._invalidate(v["digest"])
                self._rechecks += 1
                _device.count("online_rechecks")
                telemetry.count("wgl.online.rechecks")
        self._advance_big_keys(routed_by_key)
        self._check_quiet_keys()

    def _invalidate(self, digest: str) -> None:
        from ..parallel.independent import invalidate_settle_memo

        invalidate_settle_memo(digest)

    def _advance_big_keys(self, touched: dict) -> None:
        """Keys too large for whole-key rechecks carry a frontier of
        their own, advanced as their stable prefix grows."""
        for k in touched:
            b = self._packers[k]
            if b.n_rows < FRONTIER_ROWS:
                continue
            fr = self._frontiers.get(k)
            if fr is None:
                fr = self._frontiers[k] = FrontierCarry(self.pm,
                                                        device=self.dev)
                self._fr_rows[k] = 0
                telemetry.count("wgl.online.key-frontiers")
            if fr.dead:
                continue
            if b.n_rows - self._fr_rows[k] >= self.advance_rows:
                packed, s = b.snapshot()
                fr.advance(packed, s)
                self._fr_rows[k] = b.n_rows

    def _check_quiet_keys(self) -> None:
        """Runs every changed key with nothing in flight through one
        stream-witness pass and records its proof by digest."""
        quiet = []
        for k in list(self._changed):
            b = self._packers[k]
            if k in self._frontiers:
                continue  # frontier keys conclude at finish()
            if b.in_flight > 0:
                continue
            if (k in self._checked_rows and
                    b.n_rows - self._checked_rows[k] < self.recheck_min_rows):
                continue
            quiet.append(k)
        if not quiet:
            return
        packs = []
        for k in quiet:
            packs.append(self._packers[k].snapshot()[0])
            self._checked_rows[k] = self._packers[k].n_rows
            del self._changed[k]
        self._stream_batch(quiet, packs)

    def _stream_batch(self, keys: list, packs: list) -> None:
        """One stream-witness pass over per-key packs; proofs recorded
        against each pack's digest."""
        from ..ops.wgl_stream import check_wgl_witness_stream
        from ..parallel.independent import _memo_put, _settle_digest
        from ..plan import costmodel

        self._checks += 1
        telemetry.count("wgl.online.keys-checked", len(keys))
        digests = [_settle_digest(p, self.pm) for p in packs]
        rows = sum(int(p.n) for p in packs)
        self._stream_rows_hwm = max(self._stream_rows_hwm, rows)
        knobs, _ = costmodel.choose_stream_knobs(len(packs), rows)
        verdicts = check_wgl_witness_stream(
            packs, self.pm, device=self.dev, segment_keys=knobs["segment"],
            max_restarts=knobs["max_restarts"])
        for k, d, v in zip(keys, digests, verdicts):
            self._attempted[k] = d
            if v is True:
                res = {"valid": True, "algorithm": "wgl-online"}
                self._verdicts[k] = {"digest": d, "res": res}
                _memo_put(d, res)

    # -- single-stream mode ---------------------------------------------------

    def _ingest_single(self, batch: list) -> None:
        from ..parallel.independent import KV

        if any(isinstance(op.value, KV) for op in batch):
            self._break("KV op in single-stream mode")
            return
        b = self._packer
        b.append_many(batch)
        fr = self._frontier
        if not fr.dead and b.n_rows - self._adv_rows >= self.advance_rows:
            packed, s = b.snapshot()
            fr.advance(packed, s)
            self._adv_rows = b.n_rows

    # -- completion ------------------------------------------------------------

    def finish(self) -> dict:
        """Stops the checker thread, drains the last buffer, runs the
        final proofs and measures the verdict lag (last op to last
        online verdict).  Idempotent.  Raises a device fault the
        session met, and raises RuntimeError if the checker thread does
        not stop within JOIN_TIMEOUT_S."""
        if self.finished:
            if self.fault is not None:
                raise self.fault
            return self.stats()
        t0 = time.monotonic()
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=JOIN_TIMEOUT_S)
        if self._thread.is_alive():
            raise RuntimeError(
                f"streaming checker thread still running after "
                f"{JOIN_TIMEOUT_S} s; not finalizing beside it")
        self.finished = True
        if self.fault is not None:
            raise self.fault
        if not self.broken:
            try:
                # The session's cost record: the final drain's device
                # work folds in through the span hook; the mid-run
                # frontier time rides as a feature.
                with profile.capture(
                        "frontier", device=self.dev,
                        keys=len(self._packers) or 1,
                        ops=int(self._ops_ingested)) as _pf:
                    _pf.knob(mode=self.mode, advance_rows=self.advance_rows)
                    batch = self._buf.take()
                    if batch:
                        self._ingest(batch)
                    self._finalize()
                    frontiers = list(self._frontiers.values())
                    if self._frontier is not None:
                        frontiers.append(self._frontier)
                    _pf.feature(checks=self._checks, device_s=round(
                        sum(fr.device_s for fr in frontiers), 6))
                    _pf.outcome = {"proven": len(self._verdicts)}
            except Exception as e:  # noqa: BLE001 — as the checker thread
                if degrade.is_device_fault(e):
                    self.fault = e
                    raise
                self._break(f"{type(e).__name__}: {e}", e)
        if self._remote is not None:
            self._remote.commit(list(self._packers))
        self.verdict_lag_s = time.monotonic() - t0
        telemetry.gauge("wgl.online.verdict-lag-s", self.verdict_lag_s)
        # Also into the quantile ring, which the SLO p95 rule and the
        # /metrics summary family read, and the verdict-lag SLO samples
        # the gauge now.  Both are side output around no device work: a
        # failure is logged, never raised.
        try:
            from ..telemetry import slo, timeseries

            timeseries.observe("wgl.online.verdict-lag-s",
                               self.verdict_lag_s)
            slo.evaluate()
        except Exception:  # noqa: BLE001 — observability is side output
            log.warning("verdict-lag observation at finish failed",
                        exc_info=True)
        return self.stats()

    def _finalize(self) -> None:
        from ..parallel.independent import _memo_put, _settle_digest

        if self.mode == self.MODE_SINGLE:
            final = self._packer.finish()
            if self._frontier.finalize(final) is True:
                res = {"valid": True, "algorithm": "wgl-online",
                       "op-count": int(final.n)}
                d = _settle_digest(final, self.pm)
                self._verdicts[None] = {"digest": d, "res": res}
                _memo_put(d, res)
            return
        if self.mode != self.MODE_KEYED:
            return
        # Close every packer: in-flight ops become indeterminate rows,
        # as pack_history will see them post-hoc.
        finals = {k: b.finish() for k, b in self._packers.items()}
        self._changed.clear()
        # Frontier keys first: their carry covers most blocks already.
        for k, fr in self._frontiers.items():
            if fr.finalize(finals[k]) is True:
                d = _settle_digest(finals[k], self.pm)
                res = {"valid": True, "algorithm": "wgl-online"}
                self._verdicts[k] = {"digest": d, "res": res}
                _memo_put(d, res)
        # One last stream pass over every unproven key, on the final
        # packs.  A key proven while quiet has its final digest already;
        # a key whose final pack equals its last attempt would only
        # repeat the same answer.
        rest, packs = [], []
        for k in self._packers:
            if k in self._verdicts or k in self._frontiers:
                continue
            if self._attempted.get(k) == _settle_digest(finals[k], self.pm):
                continue
            rest.append(k)
            packs.append(finals[k])
        # Batches of half the mid-run high-water mark, or, with a
        # trained model covering the shapes, the model's pick
        # (plan/costmodel.py choose_finalize_chunk_rows).
        from ..plan import costmodel

        cap, cap_src = costmodel.choose_finalize_chunk_rows(
            len(rest), sum(p.n for p in packs), self._stream_rows_hwm)
        telemetry.count(f"wgl.plan.finalize-chunk-{cap_src}")
        i = 0
        while i < len(rest):
            j, rows = i, 0
            while j < len(rest) and (j == i or rows + packs[j].n <= cap):
                rows += packs[j].n
                j += 1
            self._stream_batch(rest[i:j], packs[i:j])
            i = j

    # -- consumers -------------------------------------------------------------

    def consume(self, key: Any, digest: str) -> Optional[dict]:
        """The online verdict for `key` (None for a single stream), iff
        its proof covers exactly the packed history whose digest the
        caller derived; else None."""
        v = self._verdicts.get(key)
        if v is None or v["digest"] != digest:
            return None
        _device.count("online_consumed")
        telemetry.count("wgl.online.consumed")
        return dict(v["res"])

    def remote_ticket(self, addr: str, keys: list, model_spec: Any,
                      algorithm: str, budget_s: Any,
                      time_limit_s: Any) -> Optional[str]:
        """The checkerd ticket for this run's streamed upload, iff the
        upload completed and covered the same keys and settings the
        caller would submit: RemoteChecker then skips re-uploading a
        history the daemon already holds."""
        if self._remote is None:
            return None
        return self._remote.ticket_for(addr, keys, model_spec, algorithm,
                                       budget_s, time_limit_s)

    @property
    def proven(self) -> int:
        return len(self._verdicts)

    def stats(self) -> dict:
        """The session's summary (the reference's results["streaming"])."""
        out = {
            "mode": self.mode,
            "ops-ingested": self._ops_ingested,
            "swaps": self._swaps,
            "keys": (len(self._packers) if self.mode == self.MODE_KEYED
                     else (1 if self._packer is not None else 0)),
            "proven-online": len(self._verdicts),
            "rechecks": self._rechecks,
            "verdict-lag-s": self.verdict_lag_s,
        }
        if self.broken:
            out["broken"] = self.broken_reason
        fr = self._frontier
        if fr is not None:
            out["frontier"] = {
                "blocks": fr.blocks_done, "bars": fr.bars_done,
                "chunks": fr.chunks, "device-s": fr.device_s,
                "plan-s": fr.plan_s, "dead": fr.dead_reason,
            }
        if self._frontiers:
            out["key-frontiers"] = len(self._frontiers)
        if self._remote is not None:
            out["remote"] = self._remote.stats()
        return out
