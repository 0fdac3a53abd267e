"""DB protocol: installing, starting, and breaking the system under test.

The port's copy of `jepsen_tpu/db.py`, trimmed to the `DB` protocol with
its optional capabilities, the noop DB, and the run's `setup`,
`teardown`, `cycle` (teardown then setup, up to three tries) and
`snarf_logs`.  `Tcpdump` and `ComposedDB` wait for the suites that use
them.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

from .control import Session, health, on_nodes

log = logging.getLogger(__name__)

#: Setup/teardown attempts before giving up (db.clj:158-160).
CYCLE_TRIES = 3


class DB:
    """Installs and runs the database on one node (db.clj:12-14)."""

    def setup(self, test: dict, sess: Session, node: str) -> None:
        pass

    def teardown(self, test: dict, sess: Session, node: str) -> None:
        pass

    # -- optional capabilities ------------------------------------------

    def kill(self, test: dict, sess: Session, node: str) -> None:
        """Kill -9 the DB processes (Kill, db.clj:16-19)."""
        raise NotImplementedError

    def start(self, test: dict, sess: Session, node: str) -> None:
        raise NotImplementedError

    def pause(self, test: dict, sess: Session, node: str) -> None:
        """SIGSTOP (Pause, db.clj:30-33)."""
        raise NotImplementedError

    def resume(self, test: dict, sess: Session, node: str) -> None:
        """SIGCONT."""
        raise NotImplementedError

    def primaries(self, test: dict) -> Sequence[str]:
        """Nodes currently believed primary (Primary, db.clj:35-42)."""
        raise NotImplementedError

    def setup_primary(self, test: dict, sess: Session, node: str) -> None:
        """One-time setup run on the first node (db.clj:35-42)."""
        pass

    def log_files(self, test: dict, sess: Session, node: str) -> Sequence[str]:
        """Paths to snarf after the run (LogFiles, db.clj:44-48)."""
        return []

    # -- capability sniffing --------------------------------------------

    def supports(self, capability: str) -> bool:
        """True if this DB overrides `capability` (kill/pause/primaries),
        the duck-typed analog of (satisfies? Kill db)."""
        mine = getattr(type(self), capability, None)
        return mine is not None and mine is not getattr(DB, capability, None)


class NoopDB(DB):
    """No database: for in-memory and generator-only tests
    (tests.clj noop-test)."""


noop = NoopDB()


def setup(test: dict, db: Optional[DB] = None) -> None:
    """Sets up the DB on all surviving nodes in parallel (per-node
    failures go through the node-loss policy), then primary setup on
    the first node still in rotation (core.clj:164-173)."""
    db = db or test.get("db") or noop
    health.run_phase(test, "db setup", lambda s, n: db.setup(test, s, n))
    sessions = test.get("sessions") or {}
    primary = next(
        (
            n for n in test.get("nodes") or []
            if n in sessions and not health.is_quarantined(test, n)
        ),
        None,
    )
    if primary is not None:
        health.run_phase(
            test,
            "db primary setup",
            lambda s, n: db.setup_primary(test, s, n),
            [primary],
        )


def teardown(test: dict, db: Optional[DB] = None) -> None:
    db = db or test.get("db") or noop
    on_nodes(test, lambda s, n: db.teardown(test, s, n))


def cycle(test: dict, db: Optional[DB] = None) -> None:
    """Teardown then setup, retried ≤3 times (db.clj:158-199)."""
    db = db or test.get("db") or noop
    last: Optional[Exception] = None
    for attempt in range(CYCLE_TRIES):
        try:
            teardown(test, db)
            setup(test, db)
            return
        except Exception as e:  # noqa: BLE001
            last = e
            log.warning(
                "db cycle failed (%d/%d): %r", attempt + 1, CYCLE_TRIES, e
            )
    raise last  # type: ignore[misc]


def snarf_logs(test: dict, dest_dir: str, db: Optional[DB] = None) -> None:
    """Downloads every node's log files into dest_dir/<node>/
    (core.clj:101-128)."""
    db = db or test.get("db") or noop

    def snarf(sess: Session, node: str) -> None:
        files = list(db.log_files(test, sess, node))
        if not files:
            return
        node_dir = os.path.join(dest_dir, str(node))
        os.makedirs(node_dir, exist_ok=True)
        try:
            sess.download(files, node_dir)
        except Exception as e:  # noqa: BLE001
            log.warning("couldn't snarf logs from %s: %r", node, e)

    on_nodes(test, snarf)
