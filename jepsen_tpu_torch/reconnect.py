"""Auto-reconnecting connection wrappers for DB clients.

Equivalent of jepsen/src/jepsen/reconnect.clj: a
`Wrapper` owns a connection created by `open` and torn down by
`close`; `with_conn` hands the live connection to a body and, when the
body raises, closes and reopens it so the next caller gets a fresh
one.  Open/close/reconnect serialize under the wrapper's write lock
while concurrent bodies share a read lock (reconnect.clj:17-60).

    wrapper = Wrapper(open=lambda: connect(node), close=Conn.close)
    with wrapper.conn() as c:
        c.query(...)
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Any, Callable, Iterator, Optional

log = logging.getLogger(__name__)


class _RWLock:
    """Writer-preference read/write lock (ReentrantReadWriteLock's
    role in reconnect.clj:33-49)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextlib.contextmanager
    def read(self) -> Iterator[None]:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if not self._readers:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def write(self) -> Iterator[None]:
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


class Wrapper:
    """reconnect.clj:17-32."""

    def __init__(
        self,
        *,
        open: Callable[[], Any],
        close: Callable[[Any], None],
        name: Optional[str] = None,
        log_reconnects: bool = True,
    ):
        self._open = open
        self._close = close
        self.name = name
        self.log_reconnects = log_reconnects
        self._lock = _RWLock()
        self._conn: Any = None

    # -- lifecycle (reconnect.clj:53-92) ----------------------------------

    def open(self) -> "Wrapper":
        # Fast path without the write lock: conn() calls open() on
        # every use, and a writer-preference write acquisition would
        # stall behind (and deadlock with) threads already holding the
        # read lock in their bodies.
        with self._lock.read():
            if self._conn is not None:
                return self
        with self._lock.write():
            if self._conn is None:
                self._conn = self._open()
        return self

    def close(self) -> None:
        with self._lock.write():
            if self._conn is not None:
                try:
                    self._close(self._conn)
                finally:
                    self._conn = None

    def reopen(self) -> "Wrapper":
        """Close (best-effort) and open a fresh connection."""
        with self._lock.write():
            if self._conn is not None:
                try:
                    self._close(self._conn)
                except Exception:  # noqa: BLE001 — old conn may be dead
                    pass
                self._conn = None
            self._conn = self._open()
        return self

    # -- use (reconnect.clj:94-151 with-conn) -----------------------------

    @contextlib.contextmanager
    def conn(self) -> Iterator[Any]:
        """Yields the live connection (opening lazily); the read lock
        is held across the body, so a reopen triggered by one thread's
        failure waits for concurrent healthy bodies to finish instead
        of closing the connection under them (reconnect.clj:94-151).
        On a body exception the connection is reopened (after the read
        lock is released — the lock is not reentrant), then the error
        re-raises."""
        self.open()
        reopen_needed = False
        try:
            with self._lock.read():
                c = self._conn
                try:
                    yield c
                except Exception:
                    reopen_needed = True
                    raise
        finally:
            if reopen_needed:
                if self.log_reconnects:
                    log.info(
                        "reconnecting %s after error",
                        self.name or "conn", exc_info=True,
                    )
                try:
                    self.reopen()
                except Exception:  # noqa: BLE001 — reopen may fail too
                    log.warning(
                        "reopen of %s failed", self.name or "conn"
                    )
