"""Pure-functional operation generators.

The port's copy of `jepsen_tpu/generator/core.py` (no JAX there either).

Equivalent of jepsen/generator.clj: a
generator is an immutable value asked for operations by the interpreter.
`gen_op(gen, test, ctx)` yields `(op, gen')` where op is an Op or
PENDING, or None when exhausted; `gen_update(gen, test, ctx, event)`
folds an invocation/completion event back into the generator.

Default implementations (generator.clj:561-642):
  * None         — exhausted.
  * dict         — a one-shot op template: fills type/process/time from
                   the context (fill_in_op, generator.clj:500-537).
  * callable     — called (with (test, ctx) or no args) to produce a
                   generator; exhausted generators re-invoke the fn.
  * list/tuple   — runs each element generator in order; updates go to
                   the head.
  * DelayedGen   — evaluated lazily once, first time it could yield.
  * PromiseGen   — PENDING until delivered.

The full combinator catalogue of SURVEY.md §2.2 follows.  Randomness
(soonest-tie-breaking, mix, stagger) flows through a module RNG seedable
via set_rng_seed for deterministic tests (the reference rebinds
rand-int with seed 45100, generator/test.clj:40-52).
"""

from __future__ import annotations

import random
from typing import Any, Callable, Optional, Sequence

from ..history.core import Op
from .context import Context, all_but, make_thread_filter

# ---------------------------------------------------------------------------
# Protocol
# ---------------------------------------------------------------------------


class _Pending:
    _instance: "_Pending | None" = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "PENDING"


#: Sentinel: the generator may yield an op later, but not now.
PENDING = _Pending()

_rng = random.Random()


def set_rng_seed(seed: Optional[int]) -> None:
    """Seeds generator-internal randomness (tie-breaking, mix, stagger)
    for reproducible schedules."""
    global _rng
    _rng = random.Random(seed)


def get_rng() -> random.Random:
    """The module RNG; nemesis partition choices draw from it too, so a
    single set_rng_seed reproduces the whole run."""
    return _rng


class Generator:
    """Base class for explicit generators.  Subclasses are immutable:
    op/update return fresh instances."""

    def op(self, test: dict, ctx: Context):
        """-> (op_or_PENDING, gen') | None."""
        raise NotImplementedError

    def update(self, test: dict, ctx: Context, event: Op) -> "Generator":
        return self


def gen_op(gen: Any, test: dict, ctx: Context):
    """Protocol dispatch for `op` over raw values and Generators."""
    if gen is None:
        return None
    if isinstance(gen, Generator):
        return gen.op(test, ctx)
    return _coerce(gen).op(test, ctx)


def gen_update(gen: Any, test: dict, ctx: Context, event: Op):
    """Protocol dispatch for `update`."""
    if gen is None:
        return None
    if isinstance(gen, Generator):
        return gen.update(test, ctx, event)
    return _coerce(gen).update(test, ctx, event)


def _coerce(gen: Any) -> Generator:
    if isinstance(gen, Generator):
        return gen
    if isinstance(gen, dict):
        return MapGen(gen)
    if callable(gen):
        return FnGen(gen)
    if isinstance(gen, (list, tuple)):
        return SeqGen.of(gen)
    raise TypeError(f"{gen!r} is not a generator")


def fill_in_op(op: dict, ctx: Context):
    """Fills :type (invoke), :process (some free process), and :time
    (context time) into an op template; PENDING if no process is free
    (generator.clj:500-537).  Unknown keys land in Op.ext."""
    p = ctx.some_free_process()
    if p is None:
        return PENDING
    ext = {
        k: v
        for k, v in op.items()
        if k not in ("time", "type", "process", "f", "value")
    }
    return Op(
        type=op.get("type", "invoke"),
        f=op.get("f"),
        value=op.get("value"),
        process=op.get("process", p),
        time=op.get("time", ctx.time),
        index=-1,
        ext=ext,
    )


# ---------------------------------------------------------------------------
# Default implementations
# ---------------------------------------------------------------------------


class MapGen(Generator):
    """A dict is a one-shot op template (generator.clj:566-570)."""

    __slots__ = ("template",)

    def __init__(self, template: dict):
        self.template = template

    def op(self, test, ctx):
        op = fill_in_op(self.template, ctx)
        return (op, self if op is PENDING else None)

    def __repr__(self) -> str:
        return f"MapGen({self.template!r})"


class FnGen(Generator):
    """A function produces a generator when called; that generator runs
    to exhaustion, then the function is called again
    (generator.clj:536-558)."""

    __slots__ = ("f", "_arity2")

    def __init__(self, f: Callable):
        self.f = f
        try:
            import inspect

            n = len(inspect.signature(f).parameters)
        except (TypeError, ValueError):
            n = 0
        self._arity2 = n >= 2

    def op(self, test, ctx):
        produced = self.f(test, ctx) if self._arity2 else self.f()
        if produced is None:
            return None
        return gen_op([produced, self], test, ctx)

    def __repr__(self) -> str:
        return f"FnGen({self.f!r})"


class SeqGen(Generator):
    """Runs element generators in order; updates reach the head only
    (generator.clj:584-612)."""

    __slots__ = ("head", "rest")

    def __init__(self, head: Any, rest: tuple):
        self.head = head
        self.rest = rest

    @staticmethod
    def of(items: Sequence) -> "SeqGen | None":
        items = tuple(items)
        if not items:
            return None
        return SeqGen(items[0], items[1:])

    def op(self, test, ctx):
        head, rest = self.head, self.rest
        while True:
            r = gen_op(head, test, ctx)
            if r is not None:
                op, g2 = r
                if rest:
                    return (op, SeqGen(g2, rest))
                return (op, g2)
            if not rest:
                return None
            head, rest = rest[0], rest[1:]

    def update(self, test, ctx, event):
        return SeqGen(gen_update(self.head, test, ctx, event), self.rest)

    def __repr__(self) -> str:
        return f"SeqGen({self.head!r} +{len(self.rest)})"


class DelayedGen(Generator):
    """Evaluates a thunk to a generator the first time it could produce
    an op (Clojure delay semantics, generator.clj:374-377)."""

    __slots__ = ("thunk", "_cell")

    def __init__(self, thunk: Callable[[], Any]):
        self.thunk = thunk
        self._cell: list = [False, None]

    def _force(self):
        if not self._cell[0]:
            self._cell[0] = True
            self._cell[1] = self.thunk()
        return self._cell[1]

    def op(self, test, ctx):
        return gen_op(self._force(), test, ctx)

    def update(self, test, ctx, event):
        return self


def delayed(thunk: Callable[[], Any]) -> DelayedGen:
    return DelayedGen(thunk)


class PromiseGen(Generator):
    """PENDING until delivered, then acts as the delivered generator
    (promise semantics, generator.clj:622-642)."""

    __slots__ = ("_box",)

    def __init__(self, box: Optional[list] = None):
        self._box = box if box is not None else [False, None]

    def deliver(self, gen: Any) -> None:
        self._box[1] = gen
        self._box[0] = True

    @property
    def realized(self) -> bool:
        return self._box[0]

    def op(self, test, ctx):
        if not self._box[0]:
            return (PENDING, self)
        return gen_op(self._box[1], test, ctx)

    def update(self, test, ctx, event):
        return self


def promise() -> PromiseGen:
    return PromiseGen()


# ---------------------------------------------------------------------------
# Wrappers: validate / exceptions / trace / map / filter
# ---------------------------------------------------------------------------

VALID_OP_TYPES = ("invoke", "info", "sleep", "log")


class InvalidOp(Exception):
    pass


class Validate(Generator):
    """Checks well-formedness of emitted ops: proper tuple shape, known
    type, numeric time, a process that is actually free
    (generator.clj:644-699)."""

    __slots__ = ("gen",)

    def __init__(self, gen: Any):
        self.gen = gen

    def op(self, test, ctx):
        r = gen_op(self.gen, test, ctx)
        if r is None:
            return None
        if not (isinstance(r, tuple) and len(r) == 2):
            raise InvalidOp(
                f"generator should return (op, gen') or None, got {r!r}"
            )
        op, g2 = r
        if op is not PENDING:
            problems = []
            if not isinstance(op, Op):
                problems.append("should be PENDING or an Op")
            else:
                if op.type not in VALID_OP_TYPES:
                    problems.append(
                        f"type should be one of {VALID_OP_TYPES}, was {op.type!r}"
                    )
                if not isinstance(op.time, (int, float)):
                    problems.append("time should be a number")
                if op.process is None:
                    problems.append("no process")
                else:
                    thread = ctx.process_to_thread(op.process)
                    if thread is None or not ctx.thread_free(thread):
                        problems.append(f"process {op.process!r} is not free")
            if problems:
                raise InvalidOp(
                    f"invalid op {op!r} from generator {self.gen!r}: "
                    + "; ".join(problems)
                )
        return (op, Validate(g2))

    def update(self, test, ctx, event):
        return Validate(gen_update(self.gen, test, ctx, event))


def validate(gen: Any) -> Validate:
    return Validate(gen)


class FriendlyExceptions(Generator):
    """Wraps op/update exceptions with generator + context detail
    (generator.clj:701-741)."""

    __slots__ = ("gen",)

    def __init__(self, gen: Any):
        self.gen = gen

    def op(self, test, ctx):
        try:
            r = gen_op(self.gen, test, ctx)
        except Exception as e:
            raise RuntimeError(
                f"Generator threw when asked for an operation.\n"
                f"Generator: {self.gen!r}\nContext: {ctx!r}"
            ) from e
        if r is None:
            return None
        op, g2 = r
        return (op, FriendlyExceptions(g2))

    def update(self, test, ctx, event):
        try:
            return FriendlyExceptions(gen_update(self.gen, test, ctx, event))
        except Exception as e:
            raise RuntimeError(
                f"Generator threw when updated with {event!r}.\n"
                f"Generator: {self.gen!r}\nContext: {ctx!r}"
            ) from e


def friendly_exceptions(gen: Any) -> FriendlyExceptions:
    return FriendlyExceptions(gen)


class Trace(Generator):
    """Logs every op/update (generator.clj:743-786)."""

    __slots__ = ("k", "gen")

    def __init__(self, k: Any, gen: Any):
        self.k = k
        self.gen = gen

    def op(self, test, ctx):
        import logging

        log = logging.getLogger("jepsen.generator")
        r = gen_op(self.gen, test, ctx)
        log.info("%s op ctx=%r -> %r", self.k, ctx, r[0] if r else None)
        if r is None:
            return None
        op, g2 = r
        return (op, Trace(self.k, g2))

    def update(self, test, ctx, event):
        import logging

        logging.getLogger("jepsen.generator").info(
            "%s update event=%r", self.k, event
        )
        return Trace(self.k, gen_update(self.gen, test, ctx, event))


def trace(k: Any, gen: Any) -> Trace:
    return Trace(k, gen)


class OpMap(Generator):
    """Transforms emitted ops with f (generator.clj:790-813)."""

    __slots__ = ("f", "gen")

    def __init__(self, f: Callable[[Op], Op], gen: Any):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        r = gen_op(self.gen, test, ctx)
        if r is None:
            return None
        op, g2 = r
        return (op if op is PENDING else self.f(op), OpMap(self.f, g2))

    def update(self, test, ctx, event):
        return OpMap(self.f, gen_update(self.gen, test, ctx, event))


def op_map(f: Callable[[Op], Op], gen: Any) -> OpMap:
    return OpMap(f, gen)


def f_map(fmap: dict, gen: Any) -> OpMap:
    """Renames op :f values through a mapping — composing generators for
    composed nemeses (generator.clj:813-833)."""
    return OpMap(lambda op: op.replace(f=fmap.get(op.f, op.f)), gen)


class OpFilter(Generator):
    """Passes only ops matching pred; PENDING/None pass through
    (generator.clj:835-848)."""

    __slots__ = ("pred", "gen")

    def __init__(self, pred: Callable[[Op], bool], gen: Any):
        self.pred = pred
        self.gen = gen

    def op(self, test, ctx):
        gen = self.gen
        while True:
            r = gen_op(gen, test, ctx)
            if r is None:
                return None
            op, g2 = r
            if op is PENDING or self.pred(op):
                return (op, OpFilter(self.pred, g2))
            gen = g2

    def update(self, test, ctx, event):
        return OpFilter(self.pred, gen_update(self.gen, test, ctx, event))


def op_filter(pred: Callable[[Op], bool], gen: Any) -> OpFilter:
    return OpFilter(pred, gen)


class OnUpdate(Generator):
    """Custom update handler: (f this test ctx event) -> generator
    (generator.clj:850-865)."""

    __slots__ = ("f", "gen")

    def __init__(self, f: Callable, gen: Any):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        r = gen_op(self.gen, test, ctx)
        if r is None:
            return None
        op, g2 = r
        return (op, OnUpdate(self.f, g2))

    def update(self, test, ctx, event):
        return self.f(self, test, ctx, event)


def on_update(f: Callable, gen: Any) -> OnUpdate:
    return OnUpdate(f, gen)


# ---------------------------------------------------------------------------
# Thread routing
# ---------------------------------------------------------------------------


class OnThreads(Generator):
    """Restricts a generator to threads matching pred; the inner
    generator sees a context filtered to those threads
    (generator.clj:867-892)."""

    __slots__ = ("pred", "ctx_filter", "gen")

    def __init__(self, pred: Any, gen: Any, ctx_filter=None):
        self.pred = pred
        self.ctx_filter = ctx_filter or make_thread_filter(pred)
        self.gen = gen

    def op(self, test, ctx):
        r = gen_op(self.gen, test, self.ctx_filter(ctx))
        if r is None:
            return None
        op, g2 = r
        return (op, OnThreads(self.pred, g2, self.ctx_filter))

    def update(self, test, ctx, event):
        thread = ctx.process_to_thread(event.process)
        p = self.pred
        matches = p(thread) if callable(p) else thread in p
        if matches:
            return OnThreads(
                self.pred,
                gen_update(self.gen, test, self.ctx_filter(ctx), event),
                self.ctx_filter,
            )
        return self


def on_threads(pred: Any, gen: Any) -> OnThreads:
    return OnThreads(pred, gen)


on = on_threads


def clients(client_gen: Any, nemesis_gen: Any = None):
    """Routes ops to client threads only; with a second argument, also
    routes a nemesis generator to the nemesis (generator.clj:1125-1136)."""
    cg = on_threads(all_but("nemesis"), client_gen)
    if nemesis_gen is None:
        return cg
    return any_gen(cg, nemesis(nemesis_gen))


def nemesis(nemesis_gen: Any, client_gen: Any = None):
    """Routes ops to the nemesis thread only; with a second argument,
    also routes a client generator to clients (generator.clj:1138-1147)."""
    ng = on_threads({"nemesis"}, nemesis_gen)
    if client_gen is None:
        return ng
    return any_gen(ng, clients(client_gen))


# ---------------------------------------------------------------------------
# Choice: any / mix / each-thread / reserve
# ---------------------------------------------------------------------------


def soonest_op_map(m1: Optional[dict], m2: Optional[dict]) -> Optional[dict]:
    """Picks whichever {op, weight, ...} map happens sooner; PENDING
    loses to a real op; time ties break randomly, weighted
    (generator.clj:894-938)."""
    if m1 is None:
        return m2
    if m2 is None:
        return m1
    op1, op2 = m1["op"], m2["op"]
    if op1 is PENDING:
        return m2
    if op2 is PENDING:
        return m1
    t1, t2 = op1.time, op2.time
    if t1 == t2:
        w1 = m1.get("weight", 1)
        w2 = m2.get("weight", 1)
        chosen = m1 if _rng.randrange(w1 + w2) < w1 else m2
        return {**chosen, "weight": w1 + w2}
    return m1 if t1 < t2 else m2


class AnyGen(Generator):
    """Ops from whichever generator is soonest; updates go to all
    (generator.clj:940-965)."""

    __slots__ = ("gens",)

    def __init__(self, gens: tuple):
        self.gens = gens

    def op(self, test, ctx):
        soonest = None
        for i, g in enumerate(self.gens):
            r = gen_op(g, test, ctx)
            if r is not None:
                soonest = soonest_op_map(
                    soonest, {"op": r[0], "gen": r[1], "i": i}
                )
        if soonest is None:
            return None
        gens = list(self.gens)
        gens[soonest["i"]] = soonest["gen"]
        return (soonest["op"], AnyGen(tuple(gens)))

    def update(self, test, ctx, event):
        return AnyGen(
            tuple(gen_update(g, test, ctx, event) for g in self.gens)
        )


def any_gen(*gens: Any):
    if not gens:
        return None
    if len(gens) == 1:
        return gens[0]
    return AnyGen(tuple(gens))


class EachThread(Generator):
    """An independent copy of the generator per thread; each copy's
    context contains just that thread (generator.clj:967-1021)."""

    __slots__ = ("fresh", "filters", "gens")

    def __init__(self, fresh: Any, filters: Optional[dict] = None, gens: Optional[dict] = None):
        self.fresh = fresh
        self.filters = filters
        self.gens = gens or {}

    def _filters(self, ctx: Context) -> dict:
        # Lazily compiled once and shared across evolved instances, like
        # the reference's context-filters promise (generator.clj:967-978).
        if self.filters is None:
            self.filters = {
                t: make_thread_filter({t}, ctx) for t in ctx.all_threads()
            }
        return self.filters

    def op(self, test, ctx):
        filters = self._filters(ctx)
        soonest = None
        for thread in ctx.free_threads():
            g = self.gens.get(thread, self.fresh)
            r = gen_op(g, test, filters[thread](ctx))
            if r is not None:
                soonest = soonest_op_map(
                    soonest, {"op": r[0], "gen": r[1], "thread": thread}
                )
        if soonest is not None:
            gens = dict(self.gens)
            gens[soonest["thread"]] = soonest["gen"]
            return (soonest["op"], EachThread(self.fresh, filters, gens))
        if ctx.free_thread_count() != ctx.all_thread_count():
            return (PENDING, self)  # busy threads may free up later
        return None  # every thread exhausted

    def update(self, test, ctx, event):
        filters = self._filters(ctx)
        thread = ctx.process_to_thread(event.process)
        if thread is None or thread not in filters:
            return self
        g = self.gens.get(thread, self.fresh)
        g2 = gen_update(g, test, filters[thread](ctx), event)
        gens = dict(self.gens)
        gens[thread] = g2
        return EachThread(self.fresh, filters, gens)


def each_thread(gen: Any) -> EachThread:
    return EachThread(gen)


class Reserve(Generator):
    """Statically partitions threads into ranges, each with its own
    generator, plus a default for the rest (generator.clj:1023-1121).
    Ranges weight soonest-ties by their size."""

    __slots__ = ("ranges", "filters", "gens")

    def __init__(self, ranges: tuple, filters: tuple, gens: tuple):
        self.ranges = ranges       # tuple of frozensets of threads
        self.filters = filters     # one per range + default last
        self.gens = gens           # one per range + default last

    def op(self, test, ctx):
        soonest = None
        for i, threads in enumerate(self.ranges):
            r = gen_op(self.gens[i], test, self.filters[i](ctx))
            if r is not None:
                soonest = soonest_op_map(
                    soonest,
                    {"op": r[0], "gen": r[1], "weight": len(threads), "i": i},
                )
        dctx = self.filters[-1](ctx)
        r = gen_op(self.gens[-1], test, dctx)
        if r is not None:
            soonest = soonest_op_map(
                soonest,
                {
                    "op": r[0],
                    "gen": r[1],
                    "weight": dctx.all_thread_count(),
                    "i": len(self.ranges),
                },
            )
        if soonest is None:
            return None
        gens = list(self.gens)
        gens[soonest["i"]] = soonest["gen"]
        return (soonest["op"], Reserve(self.ranges, self.filters, tuple(gens)))

    def update(self, test, ctx, event):
        thread = ctx.process_to_thread(event.process)
        i = len(self.ranges)
        for j, threads in enumerate(self.ranges):
            if thread in threads:
                i = j
                break
        gens = list(self.gens)
        gens[i] = gen_update(gens[i], test, self.filters[i](ctx), event)
        return Reserve(self.ranges, self.filters, tuple(gens))


def reserve(*args: Any) -> Reserve:
    """reserve(5, write_gen, 10, cas_gen, read_gen): the first 5 threads
    run write_gen, the next 10 run cas_gen, everyone else the default."""
    if len(args) % 2 != 1:
        raise ValueError("reserve takes count/gen pairs plus a default gen")
    default = args[-1]
    pairs = list(zip(args[:-1:2], args[1:-1:2]))
    ranges = []
    gens = []
    n = 0
    for count, g in pairs:
        ranges.append(frozenset(range(n, n + count)))
        gens.append(g)
        n += count
    all_reserved = frozenset().union(*ranges) if ranges else frozenset()
    filters = tuple(make_thread_filter(r) for r in ranges) + (
        make_thread_filter(lambda t: t not in all_reserved),
    )
    return Reserve(tuple(ranges), filters, tuple(gens) + (default,))


class Mix(Generator):
    """A uniformly random mixture of generators; exhausted members are
    removed (generator.clj:1151-1196).  Ignores updates."""

    __slots__ = ("i", "gens")

    def __init__(self, i: int, gens: tuple):
        self.i = i
        self.gens = gens

    def op(self, test, ctx):
        gens = self.gens
        i = self.i
        while gens:
            r = gen_op(gens[i], test, ctx)
            if r is not None:
                op, g2 = r
                new = list(gens)
                new[i] = g2
                return (op, Mix(_rng.randrange(len(new)), tuple(new)))
            gens = gens[:i] + gens[i + 1 :]
            if gens:
                i = _rng.randrange(len(gens))
        return None


def mix(gens: Sequence) -> Optional[Mix]:
    gens = tuple(gens)
    if not gens:
        return None
    return Mix(_rng.randrange(len(gens)), gens)


# ---------------------------------------------------------------------------
# Bounding: limit / repeat / cycle / process-limit / time-limit
# ---------------------------------------------------------------------------


class Limit(Generator):
    """At most n ops (generator.clj:1199-1205)."""

    __slots__ = ("remaining", "gen")

    def __init__(self, remaining: int, gen: Any):
        self.remaining = remaining
        self.gen = gen

    def op(self, test, ctx):
        if self.remaining <= 0:
            return None
        r = gen_op(self.gen, test, ctx)
        if r is None:
            return None
        op, g2 = r
        return (op, Limit(self.remaining - 1, g2))

    def update(self, test, ctx, event):
        return Limit(self.remaining, gen_update(self.gen, test, ctx, event))


def limit(n: int, gen: Any) -> Limit:
    return Limit(n, gen)


def once(gen: Any) -> Limit:
    return Limit(1, gen)


def log(msg: str) -> dict:
    """An op that logs a message (generator.clj:1210-1214)."""
    return {"type": "log", "value": msg}


class Repeat(Generator):
    """Repeats the underlying generator's next op forever (or n times);
    the underlying generator state does not advance
    (generator.clj:1216-1240)."""

    __slots__ = ("remaining", "gen")

    def __init__(self, remaining: int, gen: Any):
        self.remaining = remaining  # -1 = infinite
        self.gen = gen

    def op(self, test, ctx):
        if self.remaining == 0:
            return None
        r = gen_op(self.gen, test, ctx)
        if r is None:
            return None
        op, _ = r
        return (op, Repeat(max(-1, self.remaining - 1), self.gen))

    def update(self, test, ctx, event):
        return Repeat(self.remaining, gen_update(self.gen, test, ctx, event))


def repeat(gen: Any, n: int = -1) -> Repeat:
    return Repeat(n, gen)


class Cycle(Generator):
    """Resets the generator to its original value when exhausted
    (generator.clj:1242-1270)."""

    __slots__ = ("remaining", "original", "gen")

    def __init__(self, remaining: int, original: Any, gen: Any):
        self.remaining = remaining
        self.original = original
        self.gen = gen

    def op(self, test, ctx):
        remaining, gen = self.remaining, self.gen
        while remaining != 0:
            r = gen_op(gen, test, ctx)
            if r is not None:
                op, g2 = r
                return (op, Cycle(remaining, self.original, g2))
            remaining -= 1
            gen = self.original
        return None

    def update(self, test, ctx, event):
        return Cycle(
            self.remaining,
            self.original,
            gen_update(self.gen, test, ctx, event),
        )


def cycle(gen: Any, n: int = -1) -> Cycle:
    return Cycle(n, gen, gen)


class ProcessLimit(Generator):
    """Stops once ops would involve more than n distinct processes
    (generator.clj:1272-1296) — bounds knossos search width from
    crashed-process churn."""

    __slots__ = ("n", "procs", "gen")

    def __init__(self, n: int, procs: frozenset, gen: Any):
        self.n = n
        self.procs = procs
        self.gen = gen

    def op(self, test, ctx):
        r = gen_op(self.gen, test, ctx)
        if r is None:
            return None
        op, g2 = r
        if op is PENDING:
            return (op, ProcessLimit(self.n, self.procs, g2))
        procs = self.procs | frozenset(ctx.all_processes())
        if len(procs) > self.n:
            return None
        return (op, ProcessLimit(self.n, procs, g2))

    def update(self, test, ctx, event):
        return ProcessLimit(
            self.n, self.procs, gen_update(self.gen, test, ctx, event)
        )


def process_limit(n: int, gen: Any) -> ProcessLimit:
    return ProcessLimit(n, frozenset(), gen)


def secs_to_nanos(s: float) -> int:
    return int(s * 1_000_000_000)


class TimeLimit(Generator):
    """Emits ops for dt seconds after its first op
    (generator.clj:1298-1322)."""

    __slots__ = ("limit", "cutoff", "gen")

    def __init__(self, limit: int, cutoff: Optional[int], gen: Any):
        self.limit = limit
        self.cutoff = cutoff
        self.gen = gen

    def op(self, test, ctx):
        r = gen_op(self.gen, test, ctx)
        if r is None:
            return None
        op, g2 = r
        if op is PENDING:
            return (op, TimeLimit(self.limit, self.cutoff, g2))
        cutoff = self.cutoff if self.cutoff is not None else op.time + self.limit
        if op.time >= cutoff:
            return None
        return (op, TimeLimit(self.limit, cutoff, g2))

    def update(self, test, ctx, event):
        return TimeLimit(
            self.limit, self.cutoff, gen_update(self.gen, test, ctx, event)
        )


def time_limit(dt_secs: float, gen: Any) -> TimeLimit:
    return TimeLimit(secs_to_nanos(dt_secs), None, gen)


# ---------------------------------------------------------------------------
# Timing: stagger / delay / sleep
# ---------------------------------------------------------------------------


class Stagger(Generator):
    """Schedules ops at uniformly random intervals in [0, 2*dt) — a
    total-rate spacing across all threads (generator.clj:1324-1377)."""

    __slots__ = ("dt", "next_time", "gen")

    def __init__(self, dt: int, next_time: Optional[int], gen: Any):
        self.dt = dt
        self.next_time = next_time
        self.gen = gen

    def op(self, test, ctx):
        r = gen_op(self.gen, test, ctx)
        if r is None:
            return None
        op, g2 = r
        if op is PENDING:
            return (op, self)
        next_time = self.next_time if self.next_time is not None else ctx.time
        if next_time <= op.time:
            return (op, Stagger(self.dt, op.time + _rng.randrange(max(1, self.dt)), g2))
        return (
            op.replace(time=next_time),
            Stagger(self.dt, next_time + _rng.randrange(max(1, self.dt)), g2),
        )

    def update(self, test, ctx, event):
        return Stagger(
            self.dt, self.next_time, gen_update(self.gen, test, ctx, event)
        )


def stagger(dt_secs: float, gen: Any) -> Stagger:
    return Stagger(secs_to_nanos(2 * dt_secs), None, gen)


class Delay(Generator):
    """Emits ops exactly dt apart (catching up if behind)
    (generator.clj:1379-1426)."""

    __slots__ = ("dt", "next_time", "gen")

    def __init__(self, dt: int, next_time: Optional[int], gen: Any):
        self.dt = dt
        self.next_time = next_time
        self.gen = gen

    def op(self, test, ctx):
        r = gen_op(self.gen, test, ctx)
        if r is None:
            return None
        op, g2 = r
        if op is PENDING:
            return (op, Delay(self.dt, self.next_time, g2))
        next_time = self.next_time if self.next_time is not None else op.time
        op = op.replace(time=max(op.time, next_time))
        return (op, Delay(self.dt, op.time + self.dt, g2))

    def update(self, test, ctx, event):
        return Delay(
            self.dt, self.next_time, gen_update(self.gen, test, ctx, event)
        )


def delay(dt_secs: float, gen: Any) -> Delay:
    return Delay(secs_to_nanos(dt_secs), None, gen)


def sleep(dt_secs: float) -> dict:
    """Exactly one special op making its receiving process do nothing
    for dt seconds; the worker sleeps and the op is excluded from the
    journal (generator.clj:1428-1432, interpreter.clj:129-131,
    :176-181).  Use repeat(sleep(10)) to sleep repeatedly."""
    return {"type": "sleep", "value": dt_secs}


# ---------------------------------------------------------------------------
# Phasing: synchronize / phases / then / until-ok / flip-flop / cycle-times
# ---------------------------------------------------------------------------


class Synchronize(Generator):
    """PENDING until every thread is free, then becomes the wrapped
    generator (generator.clj:1434-1450)."""

    __slots__ = ("gen",)

    def __init__(self, gen: Any):
        self.gen = gen

    def op(self, test, ctx):
        if ctx.free_thread_count() == ctx.all_thread_count():
            return gen_op(self.gen, test, ctx)
        return (PENDING, self)

    def update(self, test, ctx, event):
        return Synchronize(gen_update(self.gen, test, ctx, event))


def synchronize(gen: Any) -> Synchronize:
    return Synchronize(gen)


def phases(*gens: Any) -> list:
    """Each generator runs to completion, with a barrier between phases
    (generator.clj:1452-1457)."""
    return [Synchronize(g) for g in gens]


def then(a: Any, b: Any) -> list:
    """b, then (after a barrier) a — argument order matches the
    reference's ->>-friendly `then` (generator.clj:1459-1468)."""
    return [b, Synchronize(a)]


class UntilOk(Generator):
    """Emits ops until one completes :ok (generator.clj:1470-1500)."""

    __slots__ = ("gen", "done", "active")

    def __init__(self, gen: Any, done: bool = False, active: frozenset = frozenset()):
        self.gen = gen
        self.done = done
        self.active = active

    def op(self, test, ctx):
        if self.done:
            return None
        r = gen_op(self.gen, test, ctx)
        if r is None:
            return None
        op, g2 = r
        if op is PENDING:
            return (op, UntilOk(g2, self.done, self.active))
        return (op, UntilOk(g2, self.done, self.active | {op.process}))

    def update(self, test, ctx, event):
        g2 = gen_update(self.gen, test, ctx, event)
        p = event.process
        if p in self.active:
            if event.type == "ok":
                return UntilOk(g2, True, self.active - {p})
            if event.type in ("info", "fail"):
                return UntilOk(g2, self.done, self.active - {p})
        return UntilOk(g2, self.done, self.active)


def until_ok(gen: Any) -> UntilOk:
    return UntilOk(gen)


class FlipFlop(Generator):
    """Alternates between generators; stops when any is exhausted
    (generator.clj:1502-1516).  Ignores updates."""

    __slots__ = ("gens", "i")

    def __init__(self, gens: tuple, i: int):
        self.gens = gens
        self.i = i

    def op(self, test, ctx):
        r = gen_op(self.gens[self.i], test, ctx)
        if r is None:
            return None
        op, g2 = r
        gens = list(self.gens)
        gens[self.i] = g2
        return (op, FlipFlop(tuple(gens), (self.i + 1) % len(gens)))


def flip_flop(a: Any, b: Any) -> FlipFlop:
    return FlipFlop((a, b), 0)


class CycleTimes(Generator):
    """Rotates between generators on a timed schedule
    (generator.clj:1518-1608)."""

    __slots__ = ("period", "t0", "intervals", "cutoffs", "gens")

    def __init__(self, period, t0, intervals, cutoffs, gens):
        self.period = period
        self.t0 = t0
        self.intervals = intervals
        self.cutoffs = cutoffs
        self.gens = gens

    def op(self, test, ctx):
        now = ctx.time
        t0 = self.t0 if self.t0 is not None else now
        in_period = (now - t0) % self.period
        cycle_start = now - in_period
        i = 0
        while i < len(self.cutoffs) and in_period >= self.cutoffs[i]:
            i += 1
        t = cycle_start + sum(self.intervals[:i])
        # Walk windows until one contains the op; t grows every step, so
        # this terminates for any positive period.
        while True:
            interval = self.intervals[i]
            t_end = t + interval
            r = gen_op(self.gens[i], test, ctx.with_time(max(now, t)))
            if r is None:
                return None
            op, g2 = r
            gens = list(self.gens)
            gens[i] = g2
            nxt = CycleTimes(self.period, t0, self.intervals, self.cutoffs, tuple(gens))
            if op is PENDING:
                return (PENDING, nxt)
            if op.time < t_end:
                return (op, nxt)
            i = (i + 1) % len(self.gens)
            t = t_end

    def update(self, test, ctx, event):
        return CycleTimes(
            self.period,
            self.t0,
            self.intervals,
            self.cutoffs,
            tuple(gen_update(g, test, ctx, event) for g in self.gens),
        )


def cycle_times(*specs: Any) -> Optional[CycleTimes]:
    """cycle_times(5, writes, 10, reads): writes for 5 s, reads for
    10 s, repeating.  State persists across rotations."""
    if not specs:
        return None
    if len(specs) % 2 != 0:
        raise ValueError("cycle_times takes duration, generator pairs")
    intervals = tuple(secs_to_nanos(d) for d in specs[::2])
    gens = tuple(specs[1::2])
    cutoffs = []
    acc = 0
    for iv in intervals:
        acc += iv
        cutoffs.append(acc)
    return CycleTimes(acc, None, intervals, tuple(cutoffs[:-1] or cutoffs), gens)


def concat(*gens: Any) -> list:
    """Sequential composition — a list is already a generator
    (generator.clj:798-803)."""
    return list(gens)
