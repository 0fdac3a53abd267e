"""Immutable generator scheduling context.

The port's copy of `jepsen_tpu/generator/context.py` (no JAX there either).

Equivalent of jepsen/generator/context.clj
(+ its translation_table.clj): the context tracks the logical time, which
threads exist, which are free, and which process each thread is running.
Thread names are the ints 0..concurrency-1 plus "nemesis"
(context.clj:258-286); each thread initially runs itself as a process,
and a crashed thread's next process id is old + concurrency
(context.clj:240-256).

TPU-era design notes: the reference uses java BitSets + a Bifurcan map;
Python's arbitrary-width ints *are* immutable bitsets with O(1)
clone-free and/or, so thread sets here are plain ints — `free_mask` bit
i set means thread index i is free.  Precompiled thread filters
(make_thread_filter, context.clj:311-358) are just `& mask`.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

NEMESIS = "nemesis"


def _mask_bits(mask: int) -> Iterable[int]:
    """Indices of set bits, ascending."""
    while mask:
        b = mask & -mask
        yield b.bit_length() - 1
        mask ^= b


class Context:
    """Immutable scheduler state.  All mutation methods return new
    contexts; bit-mask fields make that cheap."""

    __slots__ = (
        "time",
        "next_thread_index",
        "names",
        "_index",
        "int_thread_count",
        "all_mask",
        "free_mask",
        "thread_process",
        "process_thread",
        "ext",
    )

    def __init__(
        self,
        time: int,
        next_thread_index: int,
        names: tuple,
        index: dict,
        int_thread_count: int,
        all_mask: int,
        free_mask: int,
        thread_process: tuple,
        process_thread: dict,
        ext: dict,
    ):
        self.time = time
        self.next_thread_index = next_thread_index
        self.names = names
        self._index = index
        self.int_thread_count = int_thread_count
        self.all_mask = all_mask
        self.free_mask = free_mask
        self.thread_process = thread_process
        self.process_thread = process_thread
        self.ext = ext

    # -- construction -------------------------------------------------------

    @staticmethod
    def for_test(test: dict) -> "Context":
        """Fresh context: threads 0..concurrency-1 plus "nemesis", all
        free, each running itself (context.clj:258-286)."""
        n = int(test.get("concurrency", 2))
        names = tuple(range(n)) + (NEMESIS,)
        index = {name: i for i, name in enumerate(names)}
        all_mask = (1 << len(names)) - 1
        return Context(
            time=0,
            next_thread_index=0,
            names=names,
            index=index,
            int_thread_count=n,
            all_mask=all_mask,
            free_mask=all_mask,
            thread_process=names,
            process_thread={name: name for name in names},
            ext={},
        )

    def _clone(self, *, time: Any = None, next_thread_index: Any = None,
               all_mask: Any = None, free_mask: Any = None,
               thread_process: Any = None, process_thread: Any = None,
               ext: Any = None) -> "Context":
        # Named parameters, not **kw: this runs ~3x per scheduled op
        # and the kwargs-dict form showed up in whole-stack profiles.
        # None is never a legitimate value for any of these fields, so
        # it doubles as the keep-current sentinel.
        return Context(
            time=self.time if time is None else time,
            next_thread_index=(
                self.next_thread_index if next_thread_index is None
                else next_thread_index
            ),
            names=self.names,
            index=self._index,
            int_thread_count=self.int_thread_count,
            all_mask=self.all_mask if all_mask is None else all_mask,
            free_mask=self.free_mask if free_mask is None else free_mask,
            thread_process=(
                self.thread_process if thread_process is None
                else thread_process
            ),
            process_thread=(
                self.process_thread if process_thread is None
                else process_thread
            ),
            ext=self.ext if ext is None else ext,
        )

    # -- map-ish behavior (context.clj "contexts also behave like maps") ----

    def get(self, k: Any, default: Any = None) -> Any:
        if k == "time":
            return self.time
        return self.ext.get(k, default)

    def assoc(self, k: Any, v: Any) -> "Context":
        if k == "time":
            return self._clone(time=v)
        ext = dict(self.ext)
        ext[k] = v
        return self._clone(ext=ext)

    def with_time(self, time: int) -> "Context":
        return self._clone(time=time)

    # -- thread / process queries ------------------------------------------

    def thread_index(self, thread: Any) -> int:
        return self._index[thread]

    def all_threads(self) -> list:
        return [self.names[i] for i in _mask_bits(self.all_mask)]

    def free_threads(self) -> list:
        return [self.names[i] for i in _mask_bits(self.free_mask)]

    def all_thread_count(self) -> int:
        return self.all_mask.bit_count()

    def free_thread_count(self) -> int:
        return self.free_mask.bit_count()

    def all_processes(self) -> list:
        return [self.thread_process[i] for i in _mask_bits(self.all_mask)]

    def free_processes(self) -> list:
        return [self.thread_process[i] for i in _mask_bits(self.free_mask)]

    def process_to_thread(self, process: Any) -> Any:
        return self.process_thread.get(process)

    def thread_to_process(self, thread: Any) -> Any:
        return self.thread_process[self._index[thread]]

    def thread_free(self, thread: Any) -> bool:
        i = self._index.get(thread)
        return i is not None and bool((self.free_mask >> i) & 1)

    def some_free_process(self) -> Any:
        """A free process, rotating through threads for fairness
        (context.clj:202-218): first free thread at index >=
        next_thread_index, wrapping around."""
        m = self.free_mask >> self.next_thread_index
        if m:
            i = self.next_thread_index + ((m & -m).bit_length() - 1)
            return self.thread_process[i]
        if self.next_thread_index == 0:
            return None
        m = self.free_mask
        if not m:
            return None
        return self.thread_process[(m & -m).bit_length() - 1]

    # -- transitions --------------------------------------------------------

    def busy_thread(self, time: int, thread: Any) -> "Context":
        """Marks thread busy at the given time, and bumps the fairness
        rotation pointer (context.clj:229-238)."""
        i = self._index[thread]
        return self._clone(
            time=time,
            next_thread_index=(self.next_thread_index + 1) % len(self.names),
            free_mask=self.free_mask & ~(1 << i),
        )

    def free_thread(self, time: int, thread: Any) -> "Context":
        i = self._index[thread]
        return self._clone(time=time, free_mask=self.free_mask | (1 << i))

    def with_next_process(self, thread: Any) -> "Context":
        """Replaces a crashed thread's process with a fresh id: old +
        int-thread-count (context.clj:240-256)."""
        i = self._index[thread]
        old = self.thread_process[i]
        if not isinstance(old, int):
            return self
        new = old + self.int_thread_count
        tp = list(self.thread_process)
        tp[i] = new
        pt = dict(self.process_thread)
        pt.pop(old, None)
        pt[new] = thread
        return self._clone(thread_process=tuple(tp), process_thread=pt)

    def __repr__(self) -> str:
        return (
            f"Context(time={self.time}, free={self.free_threads()}, "
            f"all={self.all_threads()})"
        )


def context(test: dict) -> Context:
    return Context.for_test(test)


class AllBut:
    """Predicate matching every thread except one (context.clj:288-307)."""

    __slots__ = ("element",)

    def __init__(self, element: Any):
        self.element = element

    def __call__(self, x: Any) -> bool:
        return x != self.element


def all_but(x: Any) -> AllBut:
    return AllBut(x)


def _as_pred(pred: Any) -> Callable[[Any], bool]:
    if callable(pred) and not isinstance(pred, (set, frozenset)):
        return pred
    s = set(pred) if not isinstance(pred, (set, frozenset)) else pred
    return lambda t: t in s


def make_thread_filter(pred: Any, ctx: Optional[Context] = None):
    """A precompiled context restriction: returns fn(ctx) -> ctx whose
    all/free thread sets are intersected with the threads matching pred
    (context.clj:311-358).  Without a context, compiles lazily on first
    call (thread sets are stable across a run)."""
    p = _as_pred(pred)

    if ctx is None:
        cell: list = [None]

        def lazy(c: Context) -> Context:
            f = cell[0]
            if f is None:
                f = make_thread_filter(p, c)
                cell[0] = f
            return f(c)

        return lazy

    mask = 0
    for i in _mask_bits(ctx.all_mask):
        if p(ctx.names[i]):
            mask |= 1 << i

    def by_mask(c: Context) -> Context:
        return c._clone(
            all_mask=c.all_mask & mask, free_mask=c.free_mask & mask
        )

    return by_mask
