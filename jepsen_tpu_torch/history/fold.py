"""Chunked parallel folds and async tasks over histories.

Equivalent of the `jepsen.history.fold` / `h/task` surface the
reference consumes (SURVEY.md §2.4: `h/fold`, `jepsen.history.fold/loopf`
at checker.clj:161-181, `h/task` async analysis helpers).  The
reference folds run chunk-concurrent over the on-disk BigVector; here
chunks fan out over a shared thread pool — worthwhile for reducers
that release the GIL (numpy/JAX batch steps) and for I/O-adjacent
work, and semantically identical for pure-Python reducers.

A Fold is reducer machinery in the tesser shape:

    Fold(identity=..., reducer=..., combiner=..., post=...)

`reducer(acc, op)` folds one op into a chunk accumulator (starting
from `identity()`); `combiner(a, b)` merges adjacent chunk results in
order; `post(acc)` finishes.  Without a combiner the fold runs
sequentially (order-dependent reductions stay correct).
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional, Sequence

from ..utils import bounded_pmap
from .core import History, Op

#: Chunk granularity, matching the store's sealed-chunk size
#: (format.clj:372-375).
CHUNK_SIZE = 16384


@dataclass(frozen=True)
class Fold:
    identity: Callable[[], Any]
    reducer: Callable[[Any, Op], Any]
    combiner: Optional[Callable[[Any, Any], Any]] = None
    post: Callable[[Any], Any] = lambda acc: acc


def loopf(identity: Callable[[], Any],
          reducer: Callable[[Any, Op], Any],
          combiner: Optional[Callable[[Any, Any], Any]] = None,
          post: Callable[[Any], Any] = lambda acc: acc) -> Fold:
    """Terse Fold constructor (jepsen.history.fold/loopf shape)."""
    return Fold(identity, reducer, combiner, post)


def fold(ops: Sequence[Op] | History, f: Fold,
         chunk_size: int = CHUNK_SIZE) -> Any:
    """Runs a fold over a history.  With a combiner, chunks reduce
    concurrently and merge in order; without one, a single sequential
    pass."""
    rows: Sequence[Op] = ops.ops if isinstance(ops, History) else ops
    if f.combiner is None or len(rows) <= chunk_size:
        acc = f.identity()
        red = f.reducer
        for o in rows:
            acc = red(acc, o)
        return f.post(acc)

    def one_chunk(lo: int) -> Any:
        acc = f.identity()
        red = f.reducer
        for o in rows[lo : lo + chunk_size]:
            acc = red(acc, o)
        return acc

    # Per-call pool (utils.bounded_pmap): no shared executor to leak
    # or to deadlock on nested folds.
    chunks = bounded_pmap(one_chunk, range(0, len(rows), chunk_size))
    out = chunks[0]
    for c in chunks[1:]:
        out = f.combiner(out, c)
    return f.post(out)


class Task:
    """A named async computation over a history (h/task): `result()`
    joins.  Dependencies are other tasks whose results are passed to
    `fn` positionally once they resolve.

    One thread per task (not the fold pool): tasks are coarse analysis
    jobs, and blocking on deps inside a bounded pool would deadlock on
    chains deeper than the worker count."""

    def __init__(self, name: str, fn: Callable[..., Any],
                 deps: Iterable["Task"] = ()):
        self.name = name
        self._deps = tuple(deps)
        self._future: Future = Future()
        t = threading.Thread(
            target=self._run, args=(fn,),
            name=f"history-task-{name}", daemon=True,
        )
        t.start()

    def _run(self, fn: Callable[..., Any]) -> None:
        try:
            args = [d.result() for d in self._deps]
            self._future.set_result(fn(*args))
        except BaseException as e:  # noqa: BLE001 — delivered via result()
            self._future.set_exception(e)

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: Optional[float] = None) -> Any:
        return self._future.result(timeout)

    def __repr__(self) -> str:
        state = "done" if self.done() else "running"
        return f"Task({self.name!r}, {state})"


def task(name: str, fn: Callable[..., Any],
         deps: Iterable[Task] = ()) -> Task:
    return Task(name, fn, deps)
