"""The checkerd cohort scheduler: cross-run merge onto one card.

The port's copy of `jepsen_tpu/checkerd/scheduler.py`.  One worker
thread owns the card.  It pops the queue, waits one batch window so
concurrent runs' submissions land, then takes every queued request
*compatible* with the head (same model spec, algorithm, and budgets —
budgets gate compatibility so a tight-budget request never rides a
cohort that outlives it) and checks them as ONE merged cohort through
the checking plan (parallel/independent.py._check_linearizable, and
plan/compiler.py run_packs for wire-packed submissions): every key of
every request becomes a (ticket, key-index) entry in one subs map, so
the stream witness's sweep kernel, the refutation screens, the batched
BFS and the settle memo amortize across runs exactly as they do across
keys.

Budgets: a request's `budget-s` (the run's checker_budget) bounds its
cohort's wall clock via utils.timeout — on expiry the worker abandons
the check thread (check_safe semantics) and every member request
reports per-key "unknown".  The abandoned thread may still be launching
on the card while the next cohort starts; the two share nothing but
the thread-safe settle memo, launch counters and `exact_float32`'s
lock, so the next cohort's verdicts are its own.  A non-positive budget
is already expired and short-circuits deterministically.

No fallback hides the card: a cohort whose check raises — a device
fault, a kernel fault, the card running out of memory after the
halved retry — ends every member request with the error result
("unknown" naming the error), never with a CPU verdict.  The
reference's legacy-ladder net and its catch-all around the stream
witness do not exist here: the plan is the port's only route.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Any, Optional

from collections import Counter

import torch

from .. import telemetry
from ..checker.core import merge_valid
from ..telemetry import flight, profile
from ..utils import timeout as _timeout
from . import overload

_BLOWN = object()

#: Done requests linger for late polls; a sweep drops them after this.
_RESULT_TTL_S = 600.0
#: Hard cap on remembered tickets (done ones evict oldest-first).
_MAX_TICKETS = 4096


def _count_ops(subs: dict, packs: dict) -> int:
    """Total op count of a submission (latency-estimator feature);
    best-effort — a shape the codecs don't expose counts as zero."""
    n = 0
    for h in subs.values():
        try:
            n += len(h)
        except TypeError:
            pass
    for p in packs.values():
        try:
            n += int(p.n)
        except (AttributeError, TypeError, ValueError):
            pass
    return n


class Request:
    """One run's submitted history: per-key subhistories (ops mode)
    and/or packed tensors (packed mode), plus check parameters."""

    def __init__(
        self,
        *,
        run: str,
        model_spec: dict,
        algorithm: str = "wgl-tpu",
        n_keys: int = 0,
        budget_s: Optional[float] = None,
        time_limit_s: Optional[float] = None,
        subs: Optional[dict[int, Any]] = None,
        wire_ops: Optional[dict[int, list]] = None,
        packs: Optional[dict[int, Any]] = None,
        trace: Optional[dict] = None,
        tenant: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ):
        from .protocol import canonical_spec

        self.run = run
        self.model_spec = model_spec
        self.algorithm = algorithm
        self.n_keys = n_keys
        self.budget_s = budget_s
        self.time_limit_s = time_limit_s
        self.subs = subs or {}
        #: The op dicts of `subs` as they came over the wire, when they
        #: did: the queue journal writes these instead of re-encoding.
        self.wire_ops = wire_ops or {}
        self.packs = packs or {}
        #: Fair-queueing identity: explicit SUBMIT "tenant" when given,
        #: else the run name (matching the router's quota identity).
        self.tenant = str(tenant or run or "anonymous")
        #: Client deadline in seconds from submission; the admission
        #: plane sheds early (overload.py) when the predicted verdict
        #: latency plus queue wait cannot meet it.  None = never shed.
        self.deadline_s = (float(deadline_s)
                           if isinstance(deadline_s, (int, float))
                           and deadline_s > 0 else None)
        self.n_ops = _count_ops(self.subs, self.packs)
        #: The submitting run's trace context ({"trace-id",
        #: "parent-span"}) — deliberately NOT part of `compat`: a
        #: cohort merges requests from different traces, and each
        #: request's copy of the cohort spans is stamped with its own.
        self.trace = trace if isinstance(trace, dict) else None
        #: Cohort-compatibility key: requests merge iff this matches.
        self.compat = canonical_spec({
            "model": canonical_spec(model_spec),
            "algorithm": algorithm,
            "budget-s": budget_s,
            "time-limit-s": time_limit_s,
        })
        self.ticket: str = ""
        self.state = "new"  # queued | running | done
        self.result: Optional[dict] = None
        self.submitted_t = 0.0
        self.started_t = 0.0
        self.done_t = 0.0
        #: Disconnect-abandonment bookkeeping (non-streaming tickets
        #: only): the submitting connection's id, whether any OTHER
        #: connection has polled this ticket (then the submitter dying
        #: must not cancel it), and whether it is condemned — condemned
        #: tickets drop out of the queue at the next cohort boundary.
        self.owner_conn: Optional[int] = None
        self.adopted = False
        self.abandoned = False


class Scheduler:
    def __init__(
        self,
        *,
        device: Any = "cuda",
        batch_window_s: float = 0.05,
        max_budget_s: Optional[float] = None,
        profile_dir: Optional[str] = None,
        plan_cache_dir: Optional[str] = None,
        queue_path: Optional[str] = None,
        tenant_weights: Optional[dict[str, float]] = None,
        fair_quantum: float = overload.DEFAULT_QUANTUM,
    ):
        from ..ops import degrade

        # The card first: a daemon asked for CUDA with no card raises
        # here, before it accepts anything.
        self.device: torch.device = degrade.check_card(device)
        self.batch_window_s = batch_window_s
        self.max_budget_s = max_budget_s
        if profile_dir:
            # The daemon's own fleet-wide profile store + postmortem
            # dir: every cohort's pass records aggregate here.
            profile.set_store(profile_dir)
            flight.set_dir(profile_dir)
        if plan_cache_dir:
            # Daemon warm start: the plan memo journal, so a restarted
            # checkerd re-checking byte-identical histories skips
            # settled work (plan/cache.py).
            from ..plan import cache as plan_cache

            plan_cache.configure(plan_cache_dir)
        self._cond = threading.Condition()
        #: Deficit-round-robin per-tenant queues (overload.py) — the
        #: FIFO list's replacement.  Guarded by self._cond like it was.
        self._fq = overload.FairQueue(
            quantum=fair_quantum, weights=tenant_weights,
        )
        #: Verdict-latency estimator feeding deadline-aware shedding.
        self.estimator = overload.LatencyEstimator()
        #: Per-tenant service record (queue-wait p95, served/shed).
        self.tenant_stats = overload.TenantStats()
        self.n_shed = 0
        self._tickets: dict[str, Request] = {}
        #: canonical model spec -> live Model instance.  THE warm path:
        #: one instance per spec for the daemon's lifetime means one
        #: interner and digest-stable settle-memo keys across every run
        #: that ever submits that model.
        self._models: dict[str, Any] = {}
        self._stop = False
        self._t0 = time.monotonic()
        self._busy_s = 0.0
        self.n_requests = 0
        self.n_keys_total = 0
        self.n_cohorts = 0
        self.n_cohorts_merged = 0
        self.n_requests_merged = 0
        self._lat_count = 0
        self._lat_total = 0.0
        self._lat_max = 0.0
        self._lat_last = 0.0
        self._runs: dict[str, dict[str, Any]] = {}
        self.n_abandoned = 0
        self.n_replayed = 0
        #: Durable queue: every accepted submission journals before its
        #: TICKET leaves, every verdict journals before the request is
        #: marked done, and a restarted daemon re-queues what's left
        #: (checkerd/journal.py).  None = the old in-memory-only queue.
        self.journal = None
        if queue_path:
            from .journal import QueueJournal

            self.journal = QueueJournal(queue_path)
            self._replay_journal()
        self._thread = threading.Thread(
            target=self._loop, name="checkerd-worker", daemon=True
        )
        self._thread.start()

    def _replay_journal(self) -> None:
        """Restores journal state before the worker starts: finished
        tickets re-answer late polls with their journaled bytes
        (replay idempotence); unfinished ones re-queue under their
        ORIGINAL ticket ids and re-form cohorts through the normal
        worker path — the plan compiler and the plan memo make the
        re-check a warm start."""
        import logging

        from .journal import request_from_record

        log = logging.getLogger(__name__)
        now = time.monotonic()
        for ticket, res in self.journal.finished().items():
            req = Request(run="replayed", model_spec={})
            req.ticket = ticket
            req.state = "done"
            req.result = res
            req.n_keys = len(res.get("key-results") or [])
            req.submitted_t = req.done_t = now
            with self._cond:
                self._tickets[ticket] = req
        for ticket, rec in self.journal.unfinished().items():
            try:
                req = request_from_record(rec)
            except Exception as e:  # noqa: BLE001 — one corrupt record
                # must not stop the rest of the replay.
                telemetry.count("checkerd.queue.replay-failed")
                log.warning("queue replay: ticket %s unrecoverable: %r",
                            ticket, e)
                continue
            req.ticket = ticket
            req.submitted_t = now
            req.state = "queued"
            with self._cond:
                self._tickets[ticket] = req
                self._fq.push(req)
                self.n_requests += 1
                self.n_keys_total += req.n_keys
                self._run_entry_locked(req.run)["submitted"] += 1
                self.n_replayed += 1
            telemetry.count("checkerd.queue.replayed")
        if self.n_replayed or self._tickets:
            log.info("queue replay: %d unfinished re-queued, %d finished "
                     "results restored", self.n_replayed,
                     len(self._tickets) - self.n_replayed)

    # -- admission ----------------------------------------------------------

    def submit(self, req: Request, *, owner_conn: Optional[int] = None) -> str:
        """Admits one request, or raises overload.OverloadShed — BEFORE
        any ticket is minted or journaled, so a shed is never an acked
        submission (the no-silent-loss invariant is trivial for sheds:
        there is nothing to lose)."""
        now = time.monotonic()
        with self._cond:
            self._maybe_shed_locked(req)
            req.ticket = uuid.uuid4().hex[:12]
            req.submitted_t = now
            req.state = "queued"
            req.owner_conn = owner_conn
            self._sweep_locked(now)
            self._tickets[req.ticket] = req
            self._fq.push(req)
            self.n_requests += 1
            self.n_keys_total += req.n_keys
            r = self._run_entry_locked(req.run)
            r["submitted"] += 1
            self._cond.notify_all()
        if self.journal is not None:
            # Durability before acknowledgement: the TICKET reply only
            # leaves after this returns, so every pollable ticket is a
            # replayable ticket.  (Journaled outside _cond — an fsync
            # must not stall pollers.)
            from .journal import request_to_record

            self.journal.record_submit(req.ticket, request_to_record(req))
        if telemetry.enabled():
            telemetry.count("checkerd.requests")
            telemetry.count("checkerd.keys", req.n_keys)
        return req.ticket

    def _maybe_shed_locked(self, req: Request) -> None:
        """Deadline-aware admission (overload.py): raises OverloadShed
        when the predicted verdict latency plus the current queue wait
        cannot meet the request's client deadline.  Requests without a
        deadline are never shed — they queue like they always did."""
        if req.deadline_s is None:
            return
        queued_keys = sum(r.n_keys for r in self._fq.requests())
        wait_s = self.estimator.queue_wait_s(queued_keys)
        check_s = self.estimator.predict_s(req.n_keys, req.n_ops)
        estimate = (wait_s + check_s) * overload.brownout().shed_factor()
        if estimate <= req.deadline_s:
            return
        self.n_shed += 1
        self.tenant_stats.record_shed(req.tenant)
        telemetry.count("checkerd.overload.shed")
        telemetry.count("checkerd.overload.shed-deadline")
        raise overload.OverloadShed(
            f"predicted verdict latency {estimate:.2f}s exceeds the "
            f"{req.deadline_s:.2f}s client deadline "
            f"(queue wait ~{wait_s:.2f}s over {queued_keys} keys)",
            retry_after_s=max(0.5, wait_s),
            tenant=req.tenant,
            estimate_s=estimate,
            deadline_s=req.deadline_s,
        )

    def poll(self, ticket: str, conn_id: Optional[int] = None) -> dict:
        """A POLL reply payload: PENDING-shaped while queued/running,
        the RESULT payload once done, or an error marker."""
        with self._cond:
            req = self._tickets.get(ticket)
            if req is None:
                return {"_error": f"unknown ticket {ticket!r}"}
            if (conn_id is not None and req.owner_conn is not None
                    and conn_id != req.owner_conn):
                # Someone other than the submitting connection wants
                # this verdict: the submitter dying no longer abandons
                # the ticket.
                req.adopted = True
            if req.state == "done" and req.result is not None:
                return dict(req.result)
            return {
                "_pending": True,
                "state": req.state,
                "queue-depth": len(self._fq),
            }

    def abandon(self, ticket: str, conn_id: Optional[int] = None) -> bool:
        """Cancels a still-queued ticket whose submitting connection
        died mid-PENDING, so its keys drop out at the next cohort
        boundary instead of riding the merged cohort forever.  Running
        or done tickets are left alone (their work is already spent or
        delivered), and so are adopted tickets — some other connection
        is waiting on them."""
        with self._cond:
            req = self._tickets.get(ticket)
            if req is None or req.state != "queued" or req.abandoned:
                return False
            if conn_id is not None and (req.owner_conn != conn_id
                                        or req.adopted):
                return False
            req.abandoned = True
            self.n_abandoned += 1
        telemetry.count("checkerd.ticket-abandoned")
        if self.journal is not None:
            self.journal.record_abandon(ticket)
        return True

    def model_for(self, spec: dict) -> Any:
        """The daemon-wide model instance for a spec (building it on
        first sight — which also validates the spec for the submitter's
        ERROR frame)."""
        from .protocol import canonical_spec, model_from_spec

        key = canonical_spec(spec)
        with self._cond:
            m = self._models.get(key)
            if m is None:
                m = model_from_spec(spec)
                self._models[key] = m
            return m

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._fq)

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=5.0)
        if self.journal is not None:
            self.journal.close()

    # -- bookkeeping --------------------------------------------------------

    def _run_entry_locked(self, run: str) -> dict[str, Any]:
        r = self._runs.get(run)
        if r is None:
            r = self._runs[run] = {
                "submitted": 0, "done": 0, "merged": 0,
                "last-latency-s": None,
            }
        return r

    def _sweep_locked(self, now: float) -> None:
        dead = [
            t for t, r in self._tickets.items()
            if r.state == "done" and now - r.done_t > _RESULT_TTL_S
        ]
        for t in dead:
            del self._tickets[t]
        while len(self._tickets) >= _MAX_TICKETS:
            victim = next(
                (t for t, r in self._tickets.items() if r.state == "done"),
                None,
            )
            if victim is None:
                break  # all live; admission still proceeds
            del self._tickets[victim]

    def stats(self) -> dict:
        """JSON-able fleet stats for STATS frames and the /fleet page."""
        with self._cond:
            now = time.monotonic()
            uptime = max(now - self._t0, 1e-9)
            queued: dict[str, int] = {}
            running: dict[str, int] = {}
            for r in self._fq.requests():
                queued[r.run] = queued.get(r.run, 0) + 1
            for r in self._tickets.values():
                if r.state == "running":
                    running[r.run] = running.get(r.run, 0) + 1
            runs = {}
            for run, d in self._runs.items():
                runs[run] = {
                    **d,
                    "queued": queued.get(run, 0),
                    "running": running.get(run, 0),
                }
            fair = self._fq.snapshot()
            tenants = self.tenant_stats.snapshot()
            for t, fq in fair.items():
                tenants.setdefault(t, {}).update(fq)
            out = {
                "uptime-s": round(uptime, 3),
                "queue-depth": len(self._fq),
                "overload": {
                    "brownout-level": overload.brownout().level,
                    "shed": self.n_shed,
                    "quantum": self._fq.quantum,
                    "weights": dict(self._fq.weights),
                    "tenants": tenants,
                },
                "requests": self.n_requests,
                "keys": self.n_keys_total,
                "cohorts": self.n_cohorts,
                "cohorts-merged": self.n_cohorts_merged,
                "requests-merged": self.n_requests_merged,
                "merge-ratio": round(
                    self.n_requests_merged / self.n_requests, 4
                ) if self.n_requests else 0.0,
                "busy-s": round(self._busy_s, 3),
                "utilization": round(self._busy_s / uptime, 4),
                "verdict-latency": {
                    "count": self._lat_count,
                    "mean-s": round(
                        self._lat_total / self._lat_count, 4
                    ) if self._lat_count else None,
                    "max-s": round(self._lat_max, 4),
                    "last-s": round(self._lat_last, 4),
                },
                "models-cached": len(self._models),
                "abandoned": self.n_abandoned,
                "replayed": self.n_replayed,
                "runs": runs,
            }
        out["queue-journal"] = (
            self.journal.stats() if self.journal is not None else None
        )
        out["devices"] = _device_info(self.device)
        # The hand kernels' launch counts in this process (ops/kernels.py
        # `launches`, 0 at the daemon's start): a client reads them to
        # show that its checks went through the card's kernels.
        from ..ops import kernels

        out["launches"] = kernels.launch_counts()
        # Observability surface: the degrade ladder's last chip probe
        # verdict and the fleet-wide profile-store aggregate (the
        # daemon's store accumulates a record per pass across every
        # run that ever submitted — the ROADMAP-3 training set).
        from ..ops import degrade

        out["chip-health"] = degrade.chip_state()
        out["profile-records"] = profile.count_records()
        out["profile-by-pass"] = profile.by_pass()
        # Roofline summary over the store's recent tail: per-pass
        # achieved-vs-peak medians (telemetry/roofline.py), capped so a
        # long-lived daemon's STATS stays O(tail) not O(history).
        try:
            from ..telemetry import roofline

            p = profile.store_path()
            recs = profile.read(p)[-2000:] if p else []
            out["roofline"] = roofline.summarize(recs) if recs else None
        except Exception:  # noqa: BLE001 — STATS must never fail on
            # an advisory summary
            out["roofline"] = None
        # Plan-layer health: routing flag, persistent cache hit rates,
        # and which passes the cost model covers — the /fleet plan
        # panel renders this block.
        from .. import plan as _plan
        from ..plan import cache as plan_cache
        from ..plan import costmodel

        out["plan"] = {
            "enabled": _plan.enabled(),
            "cache": plan_cache.stats(),
            "costmodel": costmodel.model_info(),
        }
        return out

    # -- the worker ---------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not len(self._fq) and not self._stop:
                    self._cond.wait(0.5)
                    # Idle samples let the brownout ladder de-escalate
                    # (sample() takes no scheduler lock; _cond is ours).
                    overload.brownout().sample(
                        len(self._fq), overload.process_rss_mb(),
                    )
                if self._stop:
                    return
            if self.batch_window_s > 0:
                # The merge window: concurrent runs submitting "at the
                # same time" land in one cohort instead of racing the
                # worker's pop.
                time.sleep(self.batch_window_s)
            with self._cond:
                # The cohort boundary is where abandoned tickets leave:
                # their keys never join the merged subs map, so a dead
                # client can't burn cohort budget.
                condemned = self._fq.drop_abandoned()
                if condemned:
                    now = time.monotonic()
                    for r in condemned:
                        r.state = "done"
                        r.done_t = now
                        r.result = {
                            "valid": "unknown",
                            "error": "checkerd: ticket abandoned "
                                     "(submitting connection died "
                                     "before the cohort formed)",
                            "key-results": [{
                                "valid": "unknown",
                                "error": "checkerd: ticket abandoned",
                            }] * r.n_keys,
                            "checkerd": {"ticket": r.ticket,
                                         "abandoned": True},
                        }
                if not len(self._fq):
                    continue
                # Deficit round-robin picks the head (the fairness
                # decision); compatible requests from EVERY tenant then
                # ride the cohort — the merge amortizes device work, so
                # joining costs the fleet nothing, and take_compat
                # charges each tenant's deficit for its own keys.
                head = self._fq.next_head()
                if head is None:
                    continue
                group = [head] + self._fq.take_compat(head.compat)
                now = time.monotonic()
                for r in group:
                    r.state = "running"
                    r.started_t = now
            # One pressure sample per cohort: queue depth + RSS drive
            # the brownout ladder the plan compiler consults.
            overload.brownout().sample(
                self.queue_depth(), overload.process_rss_mb(),
            )
            t_run = time.monotonic()
            try:
                self._check_group(group)
            except Exception as e:  # noqa: BLE001 — a cohort crash must
                # not kill the daemon; every member ends with the error
                # result (a device fault included: never a CPU verdict).
                err = {
                    "valid": "unknown",
                    "error": f"checkerd cohort failed: {e!r}",
                }
                for r in group:
                    if r.result is None:
                        r.result = {
                            "valid": "unknown",
                            "key-results": [dict(err)] * r.n_keys,
                            "checkerd": {"error": err["error"]},
                        }
            dt = time.monotonic() - t_run
            # Feed the deadline-shed estimator with what this cohort
            # actually cost per key (observed fallback when the plan
            # cost model is untrained).
            self.estimator.observe(sum(r.n_keys for r in group), dt)
            if self.journal is not None:
                # The replay-idempotence rule: a verdict is durable
                # BEFORE any poll can observe state "done", so a crash
                # between here and the mark-done below re-serves the
                # same bytes instead of re-checking.
                for r in group:
                    if r.result is not None:
                        self.journal.record_result(r.ticket, r.result)
            with self._cond:
                self._busy_s += dt
                self.n_cohorts += 1
                if len({r.run for r in group}) > 1:
                    self.n_cohorts_merged += 1
                    self.n_requests_merged += len(group)
                now = time.monotonic()
                for r in group:
                    r.state = "done"
                    r.done_t = now
                    lat = now - r.submitted_t
                    self._lat_count += 1
                    self._lat_total += lat
                    self._lat_max = max(self._lat_max, lat)
                    self._lat_last = lat
                    e = self._run_entry_locked(r.run)
                    e["done"] += 1
                    e["last-latency-s"] = round(lat, 4)
                    if len(group) > 1:
                        e["merged"] += 1
                    self.tenant_stats.observe_wait(
                        r.tenant, r.started_t - r.submitted_t,
                    )
                self._cond.notify_all()
            if telemetry.enabled():
                telemetry.count("checkerd.cohorts")
                if len(group) > 1:
                    telemetry.count("checkerd.cohorts-merged")

    def _check_group(self, group: list[Request]) -> None:
        from ..checker.linearizable import Linearizable
        from ..ops import degrade
        from ..parallel.independent import IndependentChecker
        from ..plan.compiler import run_packs

        head = group[0]
        model = self.model_for(head.model_spec)
        budget = head.budget_s
        if budget is not None and self.max_budget_s is not None:
            budget = min(budget, self.max_budget_s)
        elif budget is None:
            budget = self.max_budget_s

        merged_subs = {
            (r.ticket, i): h for r in group for i, h in r.subs.items()
        }
        merged_packs = {
            (r.ticket, i): p for r in group for i, p in r.packs.items()
        }

        lin = Linearizable(
            model, head.algorithm, time_limit_s=head.time_limit_s,
            device=self.device,
        )
        chk = IndependentChecker(lin, device=self.device)
        test = {"model": model}

        def run_cohort() -> tuple[dict, list]:
            out: dict[Any, dict] = {}
            with degrade.capture() as steps:
                if merged_subs:
                    out.update(chk._check_linearizable(
                        test, merged_subs, {}, self.device, Counter()))
                if merged_packs:
                    # The port's packs ladder is the compiled plan alone.
                    out.update(run_packs(
                        merged_packs, model, lin,
                        deadline=None if budget is None
                        else time.monotonic() + budget,
                    ))
            return out, list(steps)

        blown = False
        merged: dict[Any, dict] = {}
        steps: list = []
        merged_runs_pre = len({r.run for r in group})
        # Span capture window: everything the cohort records between
        # mark and the capture below ships back to each member request
        # (stamped with ITS trace context) so the submitting run's
        # trace shows the daemon-side work.  The single worker thread
        # serializes cohorts, so the global window is cohort-exact.
        mark = telemetry.event_mark()
        t_check = time.monotonic()
        with telemetry.span(
            "checkerd.cohort",
            runs=merged_runs_pre, requests=len(group),
            keys=sum(r.n_keys for r in group),
        ):
            if budget is not None and budget <= 0:
                blown = True
            elif budget is not None:
                got = _timeout(budget * 1000.0, run_cohort,
                               default=_BLOWN)
                if got is _BLOWN:
                    blown = True
                else:
                    merged, steps = got
            else:
                merged, steps = run_cohort()
        check_s = time.monotonic() - t_check
        cohort_spans = telemetry.events_between(mark)
        # A long-lived daemon must not saturate the trace-event cap:
        # each cohort's events are shipped then dropped.
        telemetry.trim_events(mark)
        if blown:
            flight.note("checkerd-budget-exceeded",
                        budget_s=budget,
                        runs=[r.run for r in group])
            flight.dump("checkerd-budget-exceeded")
            if telemetry.enabled():
                telemetry.count("checkerd.budget-exceeded")

        unknown = {
            "valid": "unknown",
            "error": f"checkerd: {budget} s request budget exhausted; "
                     f"cohort abandoned (checker_budget semantics)",
        }
        merged_runs = len({r.run for r in group})
        cohort_keys = sum(r.n_keys for r in group)
        for r in group:
            krs = []
            for i in range(r.n_keys):
                kr = merged.get((r.ticket, i))
                krs.append(dict(unknown) if kr is None and blown
                           else kr if kr is not None
                           else {"valid": "unknown",
                                 "error": "checkerd: key missing from "
                                          "cohort result"})
            meta = {
                "ticket": r.ticket,
                "merged-runs": merged_runs,
                "cohort-requests": len(group),
                "cohort-keys": cohort_keys,
                "queue-wait-s": round(r.started_t - r.submitted_t, 4),
                "check-s": round(check_s, 4),
            }
            if cohort_spans:
                # Each request gets its own stamped copy: the spans
                # carry the SUBMITTER's trace id / parent span, so the
                # client adopts them straight into its trace and
                # trace_merge.py nests them under its analyze span.
                spans = []
                for ev in cohort_spans:
                    e = dict(ev)
                    attrs = dict(e.get("attrs") or {})
                    if r.trace:
                        if r.trace.get("trace-id"):
                            attrs["trace_id"] = r.trace["trace-id"]
                        if r.trace.get("parent-span"):
                            attrs["parent_span"] = r.trace["parent-span"]
                    if attrs:
                        e["attrs"] = attrs
                    spans.append(e)
                meta["spans"] = spans
                meta["pid"] = os.getpid()
            if blown:
                meta["budget-exceeded"] = True
            if steps:
                meta["degradations"] = steps
            # Death-state summary for remote forensics: which keys went
            # bad and how, without the client digging through every
            # key-result.  The full certificates / deepest configs ride
            # in krs themselves, so client-side dossiers are built from
            # the same bytes an in-process check would have produced.
            bad = {
                str(i): {
                    "valid": kr.get("valid"),
                    "algorithm": kr.get("algorithm"),
                    "reason": kr.get("unknown-reason") or kr.get("error"),
                }
                for i, kr in enumerate(krs)
                if isinstance(kr, dict)
                and kr.get("valid") in (False, "unknown")
            }
            if bad:
                meta["forensics"] = {
                    "bad-keys": bad, "count": len(bad),
                }
            r.result = {
                "valid": merge_valid(k.get("valid") for k in krs)
                if krs else True,
                "key-results": krs,
                "checkerd": meta,
            }


def _device_info(dev: torch.device) -> dict:
    """The device this daemon owns: {"count", "platform": "gpu", "kind":
    the card's name} on a card, platform and kind "cpu" on the CPU;
    never raises (stats must work whatever the card does)."""
    if dev.type != "cuda":
        return {"count": 1, "platform": "cpu", "kind": "cpu"}
    try:
        return {"count": torch.cuda.device_count(), "platform": "gpu",
                "kind": torch.cuda.get_device_name(dev)}
    except Exception as e:  # noqa: BLE001
        return {"count": 0, "platform": "gpu", "kind": None,
                "error": repr(e)}
