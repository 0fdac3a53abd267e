"""Per-key generator lifting — `jepsen.independent`'s generator side.

The port's copy of `jepsen_tpu/generator/independent.py` (no JAX there either).

Equivalent of jepsen/independent.clj:37-257:
`sequential_generator` runs one key's generator at a time;
`concurrent_generator` splits worker threads into groups of n, each
group working a key to exhaustion before taking the next.  Op values are
wrapped in KV tuples; the checker side (parallel/independent.py) splits
the history back out per key and shards the checking across the TPU
mesh.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional, Sequence

from ..parallel.independent import KV
from .context import Context, make_thread_filter
from .core import (
    PENDING,
    Generator,
    clients,
    gen_op,
    gen_update,
    op_map,
    soonest_op_map,
)


def tuple_gen(k: Any, gen: Any):
    """Wraps a generator so invoke values become [k v] tuples
    (independent.clj:101-109)."""
    return op_map(
        lambda op: op.replace(value=KV(k, op.value))
        if op.type == "invoke"
        else op,
        gen,
    )


def sequential_generator(keys: Iterable[Any], fgen: Callable[[Any], Any]) -> list:
    """One key at a time: exhaust (fgen k1), then (fgen k2), ...
    (independent.clj:37-53)."""
    return [tuple_gen(k, fgen(k)) for k in keys]


class ConcurrentGenerator(Generator):
    """Thread groups of n, each working one key at a time
    (independent.clj:109-230).  Wrap with gen.clients() via
    concurrent_generator() — the nemesis is excluded by design."""

    def __init__(
        self,
        n: int,
        fgen: Callable[[Any], Any],
        keys: tuple,
        gens: Optional[tuple] = None,
        group_threads: Optional[tuple] = None,
        thread_group: Optional[dict] = None,
        filters: Optional[tuple] = None,
    ):
        self.n = n
        self.fgen = fgen
        self.keys = keys
        self.gens = gens
        self.group_threads = group_threads
        self.thread_group = thread_group
        self.filters = filters

    def _init_groups(self, ctx: Context):
        """Lazily partitions sorted threads into groups of n
        (independent.clj:55-99)."""
        threads = sorted(ctx.all_threads(), key=lambda t: (isinstance(t, str), t))
        count = len(threads)
        if self.n > count:
            raise ValueError(
                f"{count} worker threads can't run keys with {self.n}-thread "
                f"groups; raise concurrency to at least {self.n}"
            )
        if count % self.n != 0:
            raise ValueError(
                f"{count} threads don't divide into groups of {self.n}; "
                f"make concurrency a multiple of {self.n}"
            )
        groups = tuple(
            frozenset(threads[i : i + self.n])
            for i in range(0, count, self.n)
        )
        thread_group = {t: g for g, ts in enumerate(groups) for t in ts}
        filters = tuple(make_thread_filter(ts, ctx) for ts in groups)
        return groups, thread_group, filters

    def op(self, test, ctx):
        group_threads = self.group_threads
        thread_group = self.thread_group
        filters = self.filters
        if group_threads is None:
            group_threads, thread_group, filters = self._init_groups(ctx)

        keys = self.keys
        gens = self.gens
        if gens is None:
            g_count = len(group_threads)
            gens = tuple(
                tuple_gen(k, self.fgen(k)) for k in keys[:g_count]
            )
            gens += (None,) * (g_count - len(gens))
            keys = keys[g_count:]

        free_groups = {thread_group[t] for t in ctx.free_threads() if t in thread_group}

        gens = list(gens)
        soonest = None
        for group in free_groups:
            while True:
                g = gens[group]
                if g is None:
                    break
                r = gen_op(g, test, filters[group](ctx))
                if r is not None:
                    op, g2 = r
                    soonest = soonest_op_map(
                        soonest,
                        {
                            "op": op,
                            "group": group,
                            "gen": g2,
                            "weight": len(group_threads[group]),
                        },
                    )
                    break
                # Group's key exhausted: take the next key, or park.
                if keys:
                    k, keys = keys[0], keys[1:]
                    gens[group] = tuple_gen(k, self.fgen(k))
                else:
                    gens[group] = None

        nxt = ConcurrentGenerator(
            self.n,
            self.fgen,
            keys,
            tuple(gens),
            group_threads,
            thread_group,
            filters,
        )
        if soonest is not None and soonest["op"] is not None:
            gens[soonest["group"]] = soonest["gen"]
            nxt = ConcurrentGenerator(
                self.n,
                self.fgen,
                keys,
                tuple(gens),
                group_threads,
                thread_group,
                filters,
            )
            return (soonest["op"], nxt)
        # Busy groups may still produce ops later.
        if any(g is not None for g in gens):
            return (PENDING, nxt)
        return None

    def update(self, test, ctx, event):
        if self.thread_group is None or self.gens is None:
            return self
        thread = ctx.process_to_thread(event.process)
        group = self.thread_group.get(thread)
        if group is None:
            return self
        # Unlift the tuple so the per-key generator sees its own value.
        ev = event
        if isinstance(event.value, KV):
            ev = event.replace(value=event.value.value)
        gens = list(self.gens)
        gens[group] = gen_update(gens[group], test, ctx, ev)
        return ConcurrentGenerator(
            self.n,
            self.fgen,
            self.keys,
            tuple(gens),
            self.group_threads,
            self.thread_group,
            self.filters,
        )


def concurrent_generator(n: int, keys: Sequence[Any], fgen: Callable[[Any], Any]):
    """n threads per group, each group working one key at a time; clients
    only (independent.clj:232-257)."""
    if n <= 0 or not isinstance(n, int):
        raise ValueError("group size must be a positive integer")
    return clients(ConcurrentGenerator(n, fgen, tuple(keys)))
