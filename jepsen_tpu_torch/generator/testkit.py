"""Deterministic generator simulation — the generator test kit.

The port's copy of `jepsen_tpu/generator/testkit.py` (no JAX there either).

Equivalent of jepsen/generator/test.clj:
`simulate` executes a generator against a synthetic completion function
with a fixed RNG seed (45100) and a simulated clock, without real
clients; `quick`, `perfect`, `perfect_info`, `imperfect` are canned
completion models.  This is how every combinator gets unit-tested
(generator_test.clj pattern, SURVEY.md §4.2).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..history.core import Op
from .context import Context
from .core import PENDING, Validate, gen_op, gen_update, set_rng_seed

RAND_SEED = 45100

#: How long perfect operations take, in nanos (generator/test.clj:132).
PERFECT_LATENCY = 10


def n_plus_nemesis_context(n: int) -> Context:
    return Context.for_test({"concurrency": n})


def default_context() -> Context:
    """Two worker threads plus a nemesis (generator/test.clj:25-28)."""
    return n_plus_nemesis_context(2)


def simulate(
    gen: Any,
    complete_fn: Callable[[Context, Op], Op],
    ctx: Optional[Context] = None,
    test: Optional[dict] = None,
    max_ops: int = 1_000_000,
) -> list[Op]:
    """Simulates the full history a generator would produce, given a
    function from (ctx, invocation) to the completion op
    (generator/test.clj:54-113).  Returns invocations and completions
    with indices stripped."""
    set_rng_seed(RAND_SEED)
    ctx = ctx if ctx is not None else default_context()
    test = test or {}
    ops: list[Op] = []
    in_flight: list[Op] = []  # sorted by time
    g = Validate(gen)

    while len(ops) < max_ops:
        r = gen_op(g, test, ctx)
        if r is None:
            ops.extend(in_flight)
            break
        invoke, g2 = r
        if invoke is not PENDING and (
            not in_flight or invoke.time <= in_flight[0].time
        ):
            # Emit the invocation: advance clock, mark busy, update gen,
            # schedule its completion.
            thread = ctx.process_to_thread(invoke.process)
            ctx = ctx.busy_thread(max(ctx.time, invoke.time), thread)
            g = gen_update(g2, test, ctx, invoke)
            complete = complete_fn(ctx, invoke)
            in_flight.append(complete)
            in_flight.sort(key=lambda o: o.time)
            ops.append(invoke)
        else:
            # Pending or future invocation: complete something first.
            if not in_flight:
                raise RuntimeError(
                    f"generator pending but nothing in flight: {g!r}"
                )
            op = in_flight.pop(0)
            thread = ctx.process_to_thread(op.process)
            ctx = ctx.free_thread(op.time, thread)
            g = gen_update(g, test, ctx, op)
            if thread != "nemesis" and op.type == "info":
                ctx = ctx.with_next_process(thread)
            ops.append(op)
    return [o.replace(index=-1) for o in ops]


def invocations(ops: list[Op]) -> list[Op]:
    return [o for o in ops if o.type == "invoke"]


def quick_ops(gen: Any, ctx: Optional[Context] = None) -> list[Op]:
    """Every op succeeds instantly with zero latency."""
    return simulate(gen, lambda c, inv: inv.replace(type="ok"), ctx=ctx)


def quick(gen: Any, ctx: Optional[Context] = None) -> list[Op]:
    return invocations(quick_ops(gen, ctx))


def perfect_ops(gen: Any, ctx: Optional[Context] = None) -> list[Op]:
    """Every op succeeds in 10 ns; returns the full history."""
    return simulate(
        gen,
        lambda c, inv: inv.replace(type="ok", time=inv.time + PERFECT_LATENCY),
        ctx=ctx,
    )


def perfect(gen: Any, ctx: Optional[Context] = None) -> list[Op]:
    return invocations(perfect_ops(gen, ctx))


def perfect_info(gen: Any, ctx: Optional[Context] = None) -> list[Op]:
    """Every op crashes with :info in 10 ns; returns invocations."""
    return invocations(
        simulate(
            gen,
            lambda c, inv: inv.replace(
                type="info", time=inv.time + PERFECT_LATENCY
            ),
            ctx=ctx,
        )
    )


def imperfect(gen: Any, ctx: Optional[Context] = None) -> list[Op]:
    """Threads rotate fail -> info -> ok completions, 10 ns each;
    returns the full history."""
    state: dict = {}
    nxt = {None: "fail", "fail": "info", "info": "ok", "ok": "fail"}

    def complete(c: Context, inv: Op) -> Op:
        t = c.process_to_thread(inv.process)
        state[t] = nxt[state.get(t)]
        return inv.replace(type=state[t], time=inv.time + PERFECT_LATENCY)

    return simulate(gen, complete)
