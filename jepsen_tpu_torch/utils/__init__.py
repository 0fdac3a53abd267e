"""Host utilities: synthetic histories (`histgen`), the parallel maps
(`real_pmap`, `bounded_pmap`), time bookkeeping (`with_relative_time`,
`relative_time_nanos`, the ms/ns conversions, `Deadline`), `timeout`,
`with_retry`, `await_fn`, the nemesis helpers (`majority`,
`rand_exp`, `nemesis_intervals`) and small formatting helpers — copies
of the reference's `jepsen_tpu/utils/__init__.py`, trimmed to what the
port calls."""

from __future__ import annotations

import contextlib
import math
import os
import random
import threading
import time as _time
from concurrent.futures import ThreadPoolExecutor
from typing import (Any, Callable, Iterable, Iterator, Optional, Sequence,
                    TypeVar)

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


#: Conversions (the reference's util.clj:380-407 mirror).
NANOS_PER_MS = 1_000_000
NANOS_PER_SECOND = 1_000_000_000


def ms_to_nanos(ms: float) -> int:
    return int(ms * NANOS_PER_MS)


def nanos_to_ms(ns: float) -> float:
    return ns / NANOS_PER_MS


def nanos_to_secs(ns: float) -> float:
    return ns / NANOS_PER_SECOND


def sleep_ms(ms: float) -> None:
    _time.sleep(ms / 1000.0)


class RetryExhausted(Exception):
    pass


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


def await_fn(f: Callable[[], T], *, retry_interval_ms: float = 1000.0,
             timeout_ms: float = 60_000.0,
             log_interval_ms: Optional[float] = 10_000.0,
             log_message: Optional[str] = None,
             log: Optional[Callable[[str], None]] = None) -> T:
    """Calls f until it returns without raising; raises JepsenTimeout
    once `timeout_ms` has passed, logging progress every
    `log_interval_ms` (the reference's utils/__init__.py:269)."""
    if log is None:
        import logging

        log = logging.getLogger("jepsen_tpu_torch").info
    deadline = _time.monotonic() + timeout_ms / 1000.0
    last_log = _time.monotonic()
    while True:
        try:
            return f()
        except Exception as e:
            now = _time.monotonic()
            if now > deadline:
                raise JepsenTimeout(
                    log_message or f"await_fn timed out after {timeout_ms} ms"
                ) from e
            if log_interval_ms and (now - last_log) * 1000 >= log_interval_ms:
                last_log = now
                log(log_message
                    or f"waiting for {getattr(f, '__name__', 'fn')}")
            _time.sleep(retry_interval_ms / 1000.0)


def majority(n: int) -> int:
    """Smallest integer strictly greater than half of n; majority(0) ==
    1."""
    return max(1, n // 2 + 1)


def chunks(xs: Sequence[T], size: int) -> Iterator[Sequence[T]]:
    for i in range(0, len(xs), size):
        yield xs[i:i + size]


def integer_interval_set_str(xs: Iterable[int]) -> str:
    """A set of integers in compact interval notation, e.g.
    #{1..3 5 7..9}."""
    xs = sorted(set(xs))
    parts: list[str] = []
    i = 0
    while i < len(xs):
        j = i
        while j + 1 < len(xs) and xs[j + 1] == xs[j] + 1:
            j += 1
        parts.append(str(xs[i]) if j == i else f"{xs[i]}..{xs[j]}")
        i = j + 1
    return "#{" + " ".join(parts) + "}"


def rand_exp(rate: float, rng: Optional[random.Random] = None) -> float:
    """An exponentially distributed random value of the given rate."""
    r = (rng or random).random()
    return -math.log(1.0 - r) / rate


def nemesis_intervals(history: Iterable[Any], start_fs=("start",),
                      stop_fs=("stop",)) -> list[tuple[Any, Any]]:
    """[start-op, stop-op] pairs of the nemesis's activity windows (the
    reference's utils/__init__.py:343).  Nemesis ops pair up as
    (invoke, completion), pairs of mismatched f dropped; every open
    start pair is closed by the next stop pair, and an unclosed one
    pairs with None.  Ops without a `process` are paired as they are
    when no op is the nemesis's."""
    history = list(history)
    ops = [o for o in history if getattr(o, "process", None) == "nemesis"]
    if not ops:
        ops = [o for o in history
               if getattr(o, "process", None) is None and hasattr(o, "f")]
    pairs = [(ops[i], ops[i + 1]) for i in range(0, len(ops) - 1, 2)
             if getattr(ops[i], "f", None) == getattr(ops[i + 1], "f", None)]
    intervals: list[tuple[Any, Any]] = []
    open_starts: list[tuple[Any, Any]] = []
    for a, b in pairs:
        f = getattr(a, "f", None)
        if f in start_fs:
            open_starts.append((a, b))
        elif f in stop_fs:
            for s1, s2 in open_starts:
                intervals.append((s1, a))
                intervals.append((s2, b))
            open_starts = []
    for s1, s2 in open_starts:
        intervals.append((s1, None))
        intervals.append((s2, None))
    return intervals


@contextlib.contextmanager
def name_thread(name: str) -> Iterator[None]:
    """Renames the current thread for the block."""
    t = threading.current_thread()
    old = t.name
    t.name = name
    try:
        yield
    finally:
        t.name = old


def coll_str(x: Any, limit: int = 8) -> str:
    """A long collection abbreviated for a log line."""
    try:
        xs = list(x)
    except TypeError:
        return repr(x)
    if len(xs) <= limit:
        return repr(xs)
    return f"[{', '.join(map(repr, xs[:limit]))}, ... ({len(xs)} total)]"


class Forgettable:
    """A reference that can forget its value, so the head of a long
    generator chain can be collected during a run."""

    __slots__ = ("_value", "_forgotten")

    def __init__(self, value: Any):
        self._value = value
        self._forgotten = False

    def deref(self) -> Any:
        if self._forgotten:
            raise ValueError("value has been forgotten")
        return self._value

    def forget(self) -> None:
        self._value = None
        self._forgotten = True


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


def summarize_times(times: Sequence[float]) -> dict:
    """Median, best and spread of measured repetition times: keys
    best_s, median_s, spread_s ([min, max]) and reps."""
    ts = sorted(times)
    if not ts:
        raise ValueError("no measurements")
    return {
        "best_s": round(ts[0], 3),
        "median_s": round(ts[len(ts) // 2], 3),
        "spread_s": [round(ts[0], 3), round(ts[-1], 3)],
        "reps": len(ts),
    }
