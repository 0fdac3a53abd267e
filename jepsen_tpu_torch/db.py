"""DB protocol: installing, starting, and breaking the system under test.

The port's copy of `jepsen_tpu/db.py`.

Equivalent of jepsen/src/jepsen/db.clj: the `DB`
protocol (:12-14), optional `Kill` (:16-19), `Pause` (:30-33),
`Primary` (:35-42), and `LogFiles` (:44-48) capabilities, and `cycle`
— teardown-then-setup across all nodes with ≤3 retries (:158-199).
"""

from __future__ import annotations

import logging
from typing import Any, Optional, Sequence

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


class Tcpdump(DB):
    """A DB that captures packets from setup to teardown and yields the
    pcap as a log file (db.clj:88-156).  Compose it next to your real
    DB.  Options:

      ports         ports to capture (filter `port a or port b ...`)
      clients_only  only traffic involving the control node's IP
      filter        extra pcap filter string, AND-ed in
    """

    DIR = "/tmp/jepsen-tpu/tcpdump"

    def __init__(self, *, ports: Sequence[int] = (),
                 clients_only: bool = False,
                 filter: Optional[str] = None):
        self.ports = list(ports)
        self.clients_only = clients_only
        self.filter = filter
        self.log_file = f"{self.DIR}/log"
        self.cap_file = f"{self.DIR}/tcpdump.pcap"
        self.pid_file = f"{self.DIR}/pid"

    def _filter_str(self, test: dict) -> str:
        # Each clause parenthesized: pcap's `and` binds tighter than
        # `or`, so a bare `port a or port b and host x` would capture
        # ALL of port a's traffic (the reference db.clj:111-117 has
        # this flaw; fixed here).
        parts = []
        if self.ports:
            parts.append(
                "(" + " or ".join(f"port {p}" for p in self.ports) + ")"
            )
        if self.clients_only:
            from .control.util import control_ip

            parts.append(f"host {control_ip(test)}")
        if self.filter:
            parts.append(f"({self.filter})")
        return " and ".join(p for p in parts if p)

    def setup(self, test: dict, sess: Session, node: str) -> None:
        from .control.util import start_daemon

        with sess.su():
            sess.exec("mkdir", "-p", self.DIR)
            # -U: unbuffered — SIGINT is supposed to flush the capture
            # but loses the tail in practice (db.clj:128-134).
            args: list = ["-w", self.cap_file, "-s", "65535",
                          "-B", "16384", "-U"]
            f = self._filter_str(test)
            if f:
                args.append(f)
            start_daemon(
                sess, "tcpdump", *args,
                pidfile=self.pid_file, logfile=self.log_file,
                chdir=self.DIR,
            )

    def teardown(self, test: dict, sess: Session, node: str) -> None:
        from .control.util import stop_daemon

        with sess.su():
            # Clean INT first so tcpdump flushes, then the hard stop.
            sess.exec_star(
                "bash", "-c",
                f"test -e {self.pid_file} && "
                f"kill -INT $(cat {self.pid_file}) && sleep 0.2; true",
            )
            stop_daemon(sess, self.pid_file)
            sess.exec_star("rm", "-rf", self.DIR)

    def log_files(self, test: dict, sess: Session, node: str):
        return [self.log_file, self.cap_file]


class ComposedDB(DB):
    """Runs several DBs as one: setup in order, teardown in reverse,
    log files merged; Kill/Pause/Primary route to the first DB that
    implements them (the reference composes DBs ad hoc; this is the
    common shape, e.g. Tcpdump + real DB)."""

    def __init__(self, dbs: Sequence[DB]):
        self.dbs = list(dbs)

    def setup(self, test, sess, node):
        for db in self.dbs:
            db.setup(test, sess, node)

    def teardown(self, test, sess, node):
        for db in reversed(self.dbs):
            db.teardown(test, sess, node)

    def _first_with(self, name: str):
        for db in self.dbs:
            if db.supports(name):
                return db
        return None

    def supports(self, capability: str) -> bool:
        # A wrapper "supports" a capability only if something inside
        # does — the inherited check would see our routing methods and
        # claim everything.
        return self._first_with(capability) is not None

    def kill(self, test, sess, node):
        db = self._first_with("kill")
        if db is None:
            raise NotImplementedError
        return db.kill(test, sess, node)

    def start(self, test, sess, node):
        db = self._first_with("start")
        if db is None:
            raise NotImplementedError
        return db.start(test, sess, node)

    def pause(self, test, sess, node):
        db = self._first_with("pause")
        if db is None:
            raise NotImplementedError
        return db.pause(test, sess, node)

    def resume(self, test, sess, node):
        db = self._first_with("resume")
        if db is None:
            raise NotImplementedError
        return db.resume(test, sess, node)

    def primaries(self, test):
        db = self._first_with("primaries")
        if db is None:
            raise NotImplementedError
        return db.primaries(test)

    def log_files(self, test, sess, node):
        out: list = []
        for db in self.dbs:
            out.extend(db.log_files(test, sess, node) or [])
        return out


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
    import os

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
