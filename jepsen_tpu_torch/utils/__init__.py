"""Host utilities: synthetic histories (`histgen`), the parallel maps
(`real_pmap`, `bounded_pmap`), time bookkeeping (`with_relative_time`,
`relative_time_nanos`, `Deadline`), `timeout`, `with_retry` and
`fraction` — copies of the reference's
`jepsen_tpu/utils/__init__.py`, trimmed to what the port calls."""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time as _time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")
U = TypeVar("U")


def real_pmap(f: Callable[[T], U], xs: Iterable[T]) -> list[U]:
    """Maps f over xs with one thread per element, results in order.  If
    any call raises, raises the first one, preferring anything over
    KeyboardInterrupt (the reference's utils/__init__.py:29)."""
    xs = list(xs)
    if not xs:
        return []
    results: list[Any] = [None] * len(xs)
    errors: list[tuple[int, BaseException]] = []
    lock = threading.Lock()

    def run(i: int, x: T) -> None:
        try:
            results[i] = f(x)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            with lock:
                errors.append((i, e))

    threads = [threading.Thread(target=run, args=(i, x), daemon=True)
               for i, x in enumerate(xs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        errors.sort(key=lambda ie: (isinstance(ie[1], KeyboardInterrupt),
                                    ie[0]))
        raise errors[0][1]
    return results


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


_relative_time_origin = threading.local()


@contextlib.contextmanager
def with_relative_time() -> Iterator[None]:
    """Binds this thread's time origin for `relative_time_nanos`."""
    old = getattr(_relative_time_origin, "origin", None)
    _relative_time_origin.origin = _time.monotonic_ns()
    try:
        yield
    finally:
        _relative_time_origin.origin = old


def relative_time_nanos() -> int:
    """Nanoseconds since the enclosing `with_relative_time` (the
    monotonic clock if none is bound)."""
    origin = getattr(_relative_time_origin, "origin", None)
    if origin is None:
        return _time.monotonic_ns()
    return _time.monotonic_ns() - origin


class Deadline:
    """A wall-clock budget handed down a call tree.  `Deadline(None)` is
    unbounded: remaining() is inf and it never expires."""

    __slots__ = ("seconds", "_t0")

    def __init__(self, seconds: Optional[float]):
        self.seconds = seconds
        self._t0 = _time.monotonic()

    @classmethod
    def never(cls) -> "Deadline":
        return cls(None)

    def elapsed(self) -> float:
        return _time.monotonic() - self._t0

    def remaining(self) -> float:
        """Seconds left (negative once expired; inf if unbounded)."""
        if self.seconds is None:
            return float("inf")
        return self.seconds - self.elapsed()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, what: str = "deadline") -> None:
        """Raises JepsenTimeout when the budget is spent."""
        if self.expired():
            raise JepsenTimeout(f"{what} exceeded {self.seconds:.3f} s budget")

    def capped(self, seconds: Optional[float]) -> "Deadline":
        """A sub-budget: at most `seconds`, never more than what is left."""
        left = self.remaining()
        if seconds is None:
            return Deadline(None if left == float("inf") else max(left, 0.0))
        if left == float("inf"):
            return Deadline(seconds)
        return Deadline(max(min(seconds, left), 0.0))


def with_retry(f: Callable[[], T], *, retries: int = 5,
               backoff_ms: float = 100.0, max_backoff_ms: float = 30_000.0,
               jitter: float = 0.5,
               retry_on: tuple[type[BaseException], ...] = (Exception,),
               no_retry_on: tuple[type[BaseException], ...] = (),
               deadline: Optional[Deadline] = None,
               log: Optional[Callable[[str], None]] = None) -> T:
    """Calls f, retrying up to `retries` times on `retry_on` (but not
    `no_retry_on`) with exponential backoff and jitter; a `deadline`
    bounds the whole loop (the reference's utils/__init__.py:227)."""
    attempt = 0
    while True:
        try:
            return f()
        except retry_on as e:
            if no_retry_on and isinstance(e, no_retry_on):
                raise
            attempt += 1
            if attempt > retries:
                raise
            pause = min(backoff_ms * (2 ** (attempt - 1)), max_backoff_ms)
            pause *= 1 + jitter * random.random()
            if deadline is not None and deadline.remaining() < pause / 1000.0:
                raise
            if log:
                log(f"retry {attempt}/{retries} after "
                    f"{type(e).__name__}: {e}")
            _time.sleep(pause / 1000.0)


def fraction(num: float, denom: float) -> float:
    """num / denom, 0 where denom is 0."""
    return num / denom if denom else 0.0


def sanitize_path_part(part: Any) -> str:
    """One safe filesystem path component from an arbitrary value:
    characters outside [A-Za-z0-9._-] become underscores, and names
    that are empty or all dots (which would escape or collapse the
    parent directory) are fully underscored."""
    import re

    s = re.sub(r"[^A-Za-z0-9._-]", "_", str(part))
    if not s or set(s) <= {"."}:
        return "_" * max(1, len(s))
    return s
