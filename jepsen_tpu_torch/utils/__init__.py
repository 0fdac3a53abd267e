"""Host utilities: synthetic histories (`histgen`), `bounded_pmap` and
`timeout`."""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Optional, TypeVar

T = TypeVar("T")
U = TypeVar("U")


def bounded_pmap(f: Callable[[T], U], xs: Iterable[T],
                 bound: Optional[int] = None) -> list[U]:
    """Parallel map over xs with at most `bound` concurrent threads
    (default: cpu count + 2), preserving order — the reference's
    `bounded-pmap` (jepsen_tpu/utils/__init__.py:64).  The first
    exception in order propagates."""
    xs = list(xs)
    if not xs:
        return []
    if bound is None:
        bound = (os.cpu_count() or 4) + 2
    with ThreadPoolExecutor(max_workers=bound) as pool:
        return list(pool.map(f, xs))


#: The name of `timeout`'s worker threads, so a caller can wait for the
#: ones a budget abandoned.
TIMEOUT_THREAD = "jepsen-timeout"


class JepsenTimeout(Exception):
    """Raised when a `timeout`-bounded call exceeds its budget."""


def timeout(ms: float, f: Callable[[], T], *,
            default: Any = JepsenTimeout) -> T:
    """Runs f in a worker thread with a deadline (the reference's
    `jepsen_tpu/utils/__init__.py:137`).  On expiry returns `default`
    (or raises JepsenTimeout when no default is given).  The worker
    thread is abandoned, not killed: Python cannot stop a thread, so it
    runs on to its end and its result is dropped."""
    box: list[Any] = []
    err: list[BaseException] = []

    def run() -> None:
        try:
            box.append(f())
        except BaseException as e:  # noqa: BLE001 — re-raised below
            err.append(e)

    t = threading.Thread(target=run, daemon=True, name=TIMEOUT_THREAD)
    t.start()
    t.join(ms / 1000.0)
    if t.is_alive():
        if default is JepsenTimeout:
            raise JepsenTimeout(f"timed out after {ms} ms")
        return default
    if err:
        raise err[0]
    return box[0]
