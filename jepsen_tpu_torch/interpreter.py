"""The interpreter: turns a generator into an executed history.

The port's copy of `jepsen_tpu/interpreter.py` (no JAX there either).

Equivalent of jepsen/generator/interpreter.clj:
one OS thread per logical worker (`spawn-worker` :102-167), a
size-1 in-queue per worker plus one shared completion queue, and a
single-threaded hot loop (:184-337) that owns ALL scheduling state:

  * poll completions; stamp index+time; free the thread; fold the event
    into the generator; on client :info crashes, rotate to a fresh
    process id (context with_next_process, :245-249);
  * else ask the generator for an op: None drains the workers and ends
    the run; PENDING re-polls at 1 ms (`max-pending-interval`,
    :169-173); future ops sleep-poll until due; due ops are stamped,
    recorded as invocations, and handed to their worker.

Client workers re-open their client whenever the op's process differs
from the one their current client was opened for (ClientWorker
:36-70); failures to open complete the op as :fail with a no-client
error.  Worker exceptions become indeterminate :info completions
(:145-160) rather than crashing the run.
"""

from __future__ import annotations

import logging
import queue
import threading
import time as time_mod
from typing import Any, Callable, Optional

from . import client as jepsen_client
from . import telemetry
from .telemetry import flight
from .client import Client
from .control import health
from .control.core import RemoteDisconnected
from .generator import (
    PENDING,
    Context,
    friendly_exceptions,
    gen_op,
    gen_update,
    validate,
)
from .history import FAIL, INFO, INVOKE, NEMESIS, History, Op
from .nemesis import Nemesis
from .utils import Deadline, relative_time_nanos, with_relative_time

log = logging.getLogger(__name__)

#: How long to wait, in seconds, before rechecking a PENDING generator
#: (interpreter.clj:169-173: 1 ms).
MAX_PENDING_INTERVAL = 0.001

#: Poison pill telling a worker to exit.
_EXIT = object()


def _journal(op: Op) -> bool:
    """Should this op be recorded?  :sleep and :log are scheduling
    artifacts, not history events (interpreter.clj:176-181)."""
    return op.type not in ("sleep", "log")


class Worker:
    """One logical worker: a thread pulling ops from a private queue and
    pushing completions to the shared queue (interpreter.clj:22-34)."""

    def __init__(self, id: Any, completions: "queue.SimpleQueue[Op]"):
        self.id = id
        # SimpleQueue: C-implemented, far lighter than queue.Queue's
        # lock/condition machinery on the per-op handoff path.  The
        # reference's capacity-1 bound (ArrayBlockingQueue 1) needs no
        # enforcement here: the scheduler only hands an op to a FREE
        # worker, so at most one op (plus the exit sentinel) is ever
        # in flight.
        self.in_queue: "queue.SimpleQueue[Any]" = queue.SimpleQueue()
        self.completions = completions
        # Watchdog protocol (run()'s per-op deadlines).  `supervised` is
        # set by run() only when the test carries op/drain timeouts, so
        # the unsupervised per-op path costs one attribute check.  The
        # lock makes "push the completion" and "mark abandoned" mutually
        # exclusive: either the push lands (and `pushes` records it) or
        # the abandoned worker stays silent forever — the scheduler never
        # sees a completion for an op it already timed out.
        self.supervised = False
        self.abandoned = False
        self.pushes = 0
        self.lock = threading.Lock()
        self.thread = threading.Thread(
            target=self._run, name=f"jepsen-worker-{id}", daemon=True
        )

    def start(self) -> None:
        self.thread.start()

    def submit(self, op: Op) -> None:
        self.in_queue.put(op)

    def exit(self) -> None:
        self.in_queue.put(_EXIT)

    def join(self, timeout: Optional[float] = None) -> None:
        self.thread.join(timeout)

    def _run(self) -> None:
        while True:
            op = self.in_queue.get()
            if op is _EXIT:
                self._cleanup()
                return
            try:
                # Special op types the worker handles itself
                # (interpreter.clj:126-136).
                if op.type == "sleep":
                    time_mod.sleep(op.value or 0)
                    completion = op
                elif op.type == "log":
                    log.info("%s", op.value)
                    completion = op
                elif telemetry.enabled():
                    # The gate keeps the disabled per-op path free of
                    # even the attrs-dict build.
                    with telemetry.span("interpreter.op", f=str(op.f)):
                        completion = self.transact(op)
                else:
                    completion = self.transact(op)
            except Exception as e:  # noqa: BLE001 — worker must not die
                log.debug("worker %s: %s crashed: %r", self.id, op.f, e)
                completion = op.complete(
                    INFO, error=f"{type(e).__name__}: {e}"
                )
            if not self.supervised:
                self.completions.put(completion)
            else:
                with self.lock:
                    if self.abandoned:
                        # The scheduler already completed this op as a
                        # timeout and replaced us; a late completion now
                        # would double-count.  Exit silently.
                        self._cleanup()
                        return
                    self.pushes += 1
                    self.completions.put(completion)

    def transact(self, op: Op) -> Op:
        raise NotImplementedError

    def _cleanup(self) -> None:
        pass


#: Open-failure backoff: first retry waits this long, doubling per
#: consecutive failure up to the cap.  Keeps a dead node from hot-looping
#: opens even when health quarantine is disabled, while staying well
#: under any realistic op cadence once the node recovers.
OPEN_BACKOFF_BASE_S = 0.05
OPEN_BACKOFF_CAP_S = 1.0


class ClientWorker(Worker):
    """Wraps a Client; re-opens it when the op's process changes
    (interpreter.clj:36-70)."""

    def __init__(
        self, id: Any, completions: "queue.SimpleQueue[Op]", test: dict
    ):
        super().__init__(id, completions)
        self.test = test
        proto = test["client"]
        # Contract violations must become per-op :info completions, not
        # hot-loop crashes: auto-wrap like the reference
        # (interpreter.clj:31 client/validate).
        if not isinstance(proto, jepsen_client.Validate):
            proto = jepsen_client.validate(proto)
        self.prototype: Client = proto
        self.process: Any = None
        self.client: Optional[Client] = None
        # A worker is pinned to one node for its whole life, even as its
        # process id rotates across crashes (interpreter.clj:87-89).
        nodes = test.get("nodes") or [None]
        self.node: Any = nodes[id % len(nodes)] if isinstance(id, int) else None
        # Open-failure backoff state: seconds for the NEXT wait, and the
        # monotonic instant before which we won't attempt another open.
        self._open_backoff_s = 0.0
        self._open_not_before = 0.0

    def _drop_client(self) -> None:
        if self.client is not None:
            try:
                self.client.close(self.test)
            except Exception as e:  # noqa: BLE001
                log.debug("worker %s: close failed: %r", self.id, e)
            self.client = None

    def transact(self, op: Op) -> Op:
        if self.node is not None and health.is_quarantined(
            self.test, self.node
        ):
            # Fast-fail: invoke never reached the node, so :fail is
            # sound, and we pay no open/op timeout against the corpse.
            # Drop the stale client so re-admission reopens a fresh one.
            self._drop_client()
            self.process = op.process
            return op.complete(
                FAIL, error=f"node {self.node} quarantined"
            )
        if (
            self.client is not None
            and self.process != op.process
            and not self.client.reusable(self.test)
        ):
            self._drop_client()
        if self.client is None:
            wait = self._open_not_before - time_mod.monotonic()
            if wait > 0:
                time_mod.sleep(wait)
            try:
                self.client = self.prototype.open(self.test, self.node)
                self._open_backoff_s = 0.0
            except Exception as e:  # noqa: BLE001
                # Can't even get a client: the op certainly didn't run
                # (interpreter.clj:47-58).  Back off before the next
                # attempt so a dead node can't hot-loop opens, and feed
                # the health monitor its passive signal.
                telemetry.count("client.open.failed")
                health.signal(self.test, self.node, "open-failed")
                self._open_backoff_s = min(
                    max(self._open_backoff_s * 2, OPEN_BACKOFF_BASE_S),
                    OPEN_BACKOFF_CAP_S,
                )
                self._open_not_before = (
                    time_mod.monotonic() + self._open_backoff_s
                )
                self.process = op.process
                return op.complete(
                    FAIL, error=f"no client: {type(e).__name__}: {e}"
                )
        self.process = op.process
        try:
            return self.client.invoke(self.test, op)
        except (RemoteDisconnected, ConnectionError):
            # The transport died mid-op: indeterminate for the op (the
            # worker loop completes it :info) but a clear health signal.
            health.signal(self.test, self.node, "disconnect")
            raise

    def _cleanup(self) -> None:
        if self.client is not None:
            try:
                self.client.close(self.test)
            except Exception as e:  # noqa: BLE001
                log.debug("worker %s: close failed: %r", self.id, e)
            self.client = None


class NemesisWorker(Worker):
    """Applies ops to the test's nemesis; the nemesis object is shared
    and long-lived (interpreter.clj:92-100)."""

    def __init__(self, id: Any, completions: "queue.SimpleQueue[Op]",
                 test: dict):
        super().__init__(id, completions)
        self.test = test
        self.nemesis: Nemesis = test["nemesis"]

    def transact(self, op: Op) -> Op:
        out = self.nemesis.invoke(self.test, op)
        # Contract guard, mirroring the client path's Validate: the
        # completion must keep the invocation's process and f, or the
        # hot loop can't route it; and nemesis completions are
        # indeterminate by convention — never a second :invoke.
        if out.process != op.process or out.f != op.f:
            out = out.replace(process=op.process, f=op.f)
        if out.type == INVOKE:
            out = out.replace(type=INFO)
        return out


def spawn_worker(test: dict, completions: "queue.SimpleQueue[Op]",
                 id: Any) -> Worker:
    """interpreter.clj:102-167."""
    if id == NEMESIS:
        return NemesisWorker(id, completions, test)
    return ClientWorker(id, completions, test)


def run(
    test: dict,
    *,
    writer: Optional[Callable[[Op], None]] = None,
) -> History:
    """Runs the test's generator to completion against its client and
    nemesis, returning the dense-index history
    (interpreter.clj:184-337).  `writer`, if given, is called with every
    op as it is recorded — the incremental history persistence hook
    (store format streaming, interpreter.clj:251-253, 303-308)."""
    ctx = Context.for_test(test)
    gen = validate(friendly_exceptions(test["generator"]))

    # Supervision knobs.
    # op_timeout: seconds a single client/nemesis op may run before the
    # scheduler completes it as indeterminate :info, abandons the stuck
    # worker thread, and rotates in a fresh worker under the same id.
    # drain_timeout: global deadline on the end-of-run drain, so a hung
    # straggler can't keep the run from producing a savable history.
    op_timeout: Optional[float] = test.get("op_timeout")
    drain_timeout: Optional[float] = test.get("drain_timeout", op_timeout)
    supervised = op_timeout is not None or drain_timeout is not None

    completions: "queue.SimpleQueue[Op]" = queue.SimpleQueue()
    workers: dict[Any, Worker] = {
        thread: spawn_worker(test, completions, thread)
        for thread in ctx.all_threads()
    }
    for w in workers.values():
        w.supervised = supervised
        w.start()

    ops: list[Op] = []

    def record(op: Op) -> None:
        ops.append(op)
        if writer is not None:
            writer(op)

    op_index = 0
    outstanding = 0
    poll_timeout = 0.0  # seconds; 0 = don't block

    #: thread -> (invocation, monotonic deadline, worker pushes at submit).
    #: Populated only when supervised; the unsupervised hot path touches
    #: it behind a single None/bool check.
    in_flight: dict[Any, tuple[Op, float, int]] = {}
    drain_deadline: Optional[Deadline] = None

    def abandon(thread: Any, pushes0: int) -> bool:
        """Marks a worker abandoned unless its completion already landed
        in the queue; returns True when we own the op's completion."""
        w = workers[thread]
        with w.lock:
            if w.pushes > pushes0:
                return False  # real completion racing in; let it flow
            w.abandoned = True
        return True

    with with_relative_time():
        try:
            while True:
                completion: Optional[Op] = None
                try:
                    if poll_timeout > 0:
                        completion = completions.get(timeout=poll_timeout)
                    else:
                        completion = completions.get_nowait()
                except queue.Empty:
                    completion = None

                if completion is not None:
                    now = relative_time_nanos()
                    thread = ctx.process_to_thread(completion.process)
                    if supervised:
                        in_flight.pop(thread, None)
                    journal = _journal(completion)
                    if journal:
                        completion = completion.replace(
                            index=op_index, time=now
                        )
                        op_index += 1
                    ctx = ctx.free_thread(now, thread)
                    gen = gen_update(gen, test, ctx, completion)
                    # A crashed client process is gone forever; rotate in a
                    # fresh process id (interpreter.clj:245-249).
                    if completion.is_info and thread != NEMESIS:
                        ctx = ctx.with_next_process(thread)
                    if journal:
                        record(completion)
                    outstanding -= 1
                    poll_timeout = 0.0
                    continue

                if in_flight:
                    # Watchdog: any in-flight op past its deadline is
                    # completed here as indeterminate :info, its stuck
                    # worker abandoned, and a fresh worker rotated in
                    # under the same id (the process rotation below
                    # makes the replacement open a fresh client).
                    now_mono = time_mod.monotonic()
                    for thread, (op, dl, pushes0) in list(in_flight.items()):
                        if now_mono < dl:
                            continue
                        del in_flight[thread]
                        if not abandon(thread, pushes0):
                            continue
                        log.warning(
                            "op timeout: worker %s stuck in %r for > %g s; "
                            "abandoning thread and rotating process",
                            thread, op.f, op_timeout,
                        )
                        telemetry.count("interpreter.op-timeouts")
                        flight.note("op-timeout", thread=thread,
                                    f=str(op.f), timeout_s=op_timeout)
                        flight.dump("op-timeout")
                        stuck_node = getattr(workers[thread], "node", None)
                        if stuck_node is not None:
                            health.signal(test, stuck_node, "op-timeout")
                        now = relative_time_nanos()
                        timed_out = op.complete(
                            INFO,
                            error=f"op timed out after {op_timeout} s",
                        ).replace(index=op_index, time=now)
                        op_index += 1
                        ctx = ctx.free_thread(now, thread)
                        gen = gen_update(gen, test, ctx, timed_out)
                        if thread != NEMESIS:
                            ctx = ctx.with_next_process(thread)
                        record(timed_out)
                        outstanding -= 1
                        nw = spawn_worker(test, completions, thread)
                        nw.supervised = True
                        nw.start()
                        workers[thread] = nw

                now = relative_time_nanos()
                ctx = ctx.with_time(now)
                res = gen_op(gen, test, ctx)

                if res is None:
                    if outstanding > 0:
                        # Generator exhausted but ops are in flight: block
                        # for their completions (interpreter.clj:266-273).
                        if supervised:
                            if drain_deadline is None:
                                drain_deadline = Deadline(drain_timeout)
                            elif drain_deadline.expired() and in_flight:
                                # Drain deadline blown: mark every
                                # straggler indeterminate so the run still
                                # ends with a complete, savable history.
                                now = relative_time_nanos()
                                for thread, (op, _dl, pushes0) in list(
                                    in_flight.items()
                                ):
                                    del in_flight[thread]
                                    if not abandon(thread, pushes0):
                                        continue
                                    log.warning(
                                        "drain timeout: worker %s never "
                                        "completed %r; marking "
                                        "indeterminate", thread, op.f,
                                    )
                                    telemetry.count(
                                        "interpreter.drain-timeouts"
                                    )
                                    straggler = op.complete(
                                        INFO,
                                        error="indeterminate: drain "
                                        f"deadline ({drain_timeout} s) "
                                        "expired",
                                    ).replace(index=op_index, time=now)
                                    op_index += 1
                                    ctx = ctx.free_thread(now, thread)
                                    record(straggler)
                                    outstanding -= 1
                        poll_timeout = MAX_PENDING_INTERVAL
                        continue
                    break

                op, gen2 = res
                if op is PENDING:
                    poll_timeout = MAX_PENDING_INTERVAL
                    continue

                if op.time > now:
                    # Not due yet: wait on completions until it is
                    # (interpreter.clj:294-300).
                    poll_timeout = min(
                        (op.time - now) / 1e9, MAX_PENDING_INTERVAL * 10
                    )
                    continue

                # Due: journal the invocation (sleep/log ops occupy their
                # worker but stay out of the history,
                # interpreter.clj:176-181) and dispatch it.
                if _journal(op):
                    op = op.replace(index=op_index, time=now)
                    op_index += 1
                    record(op)
                else:
                    op = op.replace(time=now)
                gen = gen_update(gen2, test, ctx, op)
                thread = ctx.process_to_thread(op.process)
                ctx = ctx.busy_thread(now, thread)
                if supervised and _journal(op):
                    # sleep/log ops run in-worker, are bounded by
                    # construction, and never journal — exempt.
                    w = workers[thread]
                    in_flight[thread] = (
                        op,
                        time_mod.monotonic() + op_timeout
                        if op_timeout is not None
                        else float("inf"),
                        w.pushes,
                    )
                workers[thread].submit(op)
                outstanding += 1
                poll_timeout = 0.0
        finally:
            for w in workers.values():
                w.exit()
            for w in workers.values():
                # An abandoned worker is wedged inside its op and will
                # only see the exit pill if that op ever returns; don't
                # burn 10 s per straggler on a daemon thread.
                w.join(timeout=0.1 if w.abandoned else 10.0)

    telemetry.count("interpreter.ops-journaled", op_index)
    telemetry.gauge("interpreter.workers", len(workers))
    return History(ops, reindex=False)
