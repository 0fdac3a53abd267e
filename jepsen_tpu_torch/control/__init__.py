"""Control plane: sessions, the exec DSL, and node fan-out.

The port's copy of `jepsen_tpu/control/__init__.py`, with every remote
of control/remotes.py.  Equivalent of jepsen/control.clj, with one
deliberate design change (SURVEY.md §7): the reference scopes host/
session/sudo state in dynamic vars (`control.clj:44-57`); here a
`Session` is an explicit object bound to one node, carrying its sudo/
cd state, and fan-out passes sessions to your function.

    sess = Session.connect(test, "n1")
    sess.exec("echo", "hi")             # -> "hi"
    with sess.su():                      # sudo root
        sess.exec("apt-get", "install", "-y", "foo")
    on_nodes(test, lambda sess, node: sess.exec("hostname"))
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any, Callable, Iterator, Optional, Sequence

from ..utils import real_pmap
from .core import (
    ConnSpec,
    Lit,
    NonzeroExit,
    Remote,
    RemoteDisconnected,
    RemoteError,
    escape,
    escape_arg,
    lit,
    throw_on_nonzero_exit,
    wrap_action,
)
from .remotes import (
    DockerRemote,
    DummyRemote,
    K8sRemote,
    LocalRemote,
    RetryRemote,
    SshCliRemote,
    default_remote,
)

# Imported after Session's dependencies: health only needs telemetry at
# import time (it reaches back for Session lazily inside its probe).
from . import health  # noqa: E402

log = logging.getLogger(__name__)

__all__ = [
    "ConnSpec",
    "DockerRemote",
    "DummyRemote",
    "K8sRemote",
    "LocalRemote",
    "Lit",
    "NonzeroExit",
    "Remote",
    "RemoteDisconnected",
    "RemoteError",
    "RetryRemote",
    "Session",
    "SshCliRemote",
    "default_remote",
    "escape",
    "escape_arg",
    "health",
    "lit",
    "on_nodes",
    "with_sessions",
]


class Session:
    """One node's bound connection plus sudo/cd/trace state
    (control.clj:44-57 dynamic vars, reified)."""

    def __init__(
        self,
        node: str,
        remote: Remote,
        *,
        sudo: Optional[str] = None,
        sudo_password: Optional[str] = None,
        dir: Optional[str] = None,
        trace: bool = False,
        no_sudo: bool = False,
    ):
        self.node = node
        self.remote = remote
        self.sudo = sudo
        self.sudo_password = sudo_password
        self.dir = dir
        self.trace = trace
        self.no_sudo = no_sudo

    @staticmethod
    def connect(test: dict, node: str) -> "Session":
        """Opens a connection using the test's remote and ssh opts
        (control.clj:240-266 with-ssh)."""
        proto = default_remote(test)
        spec = ConnSpec.for_test(test, node)
        bound = proto.connect(spec)
        ssh = test.get("ssh", {}) or {}
        return Session(
            node,
            bound,
            sudo_password=ssh.get("sudo-password"),
            trace=bool(test.get("trace-control", False)),
            no_sudo=bool(ssh.get("no-sudo")),
        )

    # -- state scoping ---------------------------------------------------

    @contextlib.contextmanager
    def su(self, user: str = "root") -> Iterator["Session"]:
        """sudo scope (control.clj:190-199).  A transport that is
        already root (netns/docker-style remotes on sudo-less images)
        declares test["ssh"]["no-sudo"] and su("root") becomes a
        no-op — ONLY for root: a requested non-root identity still
        wraps (and fails loudly on a sudo-less image) rather than
        silently running the block as root."""
        if self.no_sudo and user == "root":
            yield self
            return
        old = self.sudo
        self.sudo = user
        try:
            yield self
        finally:
            self.sudo = old

    @contextlib.contextmanager
    def cd(self, dir: str) -> Iterator["Session"]:
        """working-directory scope (control.clj:184-188)."""
        old = self.dir
        self.dir = dir
        try:
            yield self
        finally:
            self.dir = old

    # -- command execution ----------------------------------------------

    def exec_star(self, *args: Any, **kw: Any) -> dict:
        """Builds, wraps, and runs a command; returns the full action
        result without raising (control.clj:130-161 ssh*)."""
        stdin = kw.pop("stdin", None)
        env = kw.pop("env", None)
        timeout = kw.pop("timeout", None)
        if kw:
            raise TypeError(f"unknown kwargs {sorted(kw)}")
        action: dict[str, Any] = {
            "cmd": escape(args),
            "in": stdin,
            "dir": self.dir,
            "sudo": self.sudo,
            "sudo-password": self.sudo_password,
            "env": env,
            "host": self.node,
        }
        if timeout is not None:
            action["timeout"] = timeout
        wrapped = wrap_action(action)
        if self.trace:
            log.info("[%s] %s", self.node, wrapped["cmd"])
        return self.remote.execute(wrapped)

    def exec(self, *args: Any, **kw: Any) -> str:
        """Runs a command, raising NonzeroExit on failure; returns
        trimmed stdout (control.clj:142-161)."""
        res = throw_on_nonzero_exit(self.exec_star(*args, **kw))
        return (res.get("out") or "").strip()

    def upload(self, local_paths: Any, remote_path: str) -> None:
        if isinstance(local_paths, str):
            local_paths = [local_paths]
        self.remote.upload(local_paths, remote_path)

    def download(self, remote_paths: Any, local_path: str) -> None:
        if isinstance(remote_paths, str):
            remote_paths = [remote_paths]
        self.remote.download(remote_paths, local_path)

    def disconnect(self) -> None:
        self.remote.disconnect()

    def __repr__(self) -> str:
        return f"Session({self.node})"


def sessions_for(test: dict) -> dict[str, Session]:
    """Opens one session per node in parallel; applies the node-loss
    policy to connect failures (abort: close the ones that succeeded
    and raise — one aggregate error naming every failed node when
    several fail, the lone original exception otherwise — the
    core.clj:69-90 with-resources contract; tolerate: quarantine the
    unreachable nodes and return the survivors' sessions — a node
    without a session is naturally skipped by `on_nodes`)."""
    nodes = list(test.get("nodes") or [])
    todo = [n for n in nodes if not health.is_quarantined(test, n)]
    opened, failed = health.node_fanout(
        todo, lambda node: Session.connect(test, node)
    )
    try:
        health.absorb_failures(test, "session connect", failed)
    except Exception:
        for s in opened.values():
            try:
                s.disconnect()
            except Exception:  # noqa: BLE001
                pass
        raise
    return opened


@contextlib.contextmanager
def with_sessions(test: dict) -> Iterator[dict]:
    """Binds test["sessions"] = {node: Session} for the duration
    (core.clj:266-286 with-sessions)."""
    sessions = sessions_for(test)
    test["sessions"] = sessions
    try:
        yield test
    finally:
        for s in sessions.values():
            try:
                s.disconnect()
            except Exception:  # noqa: BLE001
                pass
        test.pop("sessions", None)


def on_nodes(
    test: dict,
    f: Callable[[Session, str], Any],
    nodes: Optional[Sequence[str]] = None,
) -> dict:
    """Runs f(session, node) on every node in parallel; returns
    {node: result} (control.clj:299-315)."""
    sessions = test.get("sessions")
    if sessions is None:
        raise RuntimeError(
            "no sessions bound; run inside with_sessions(test)"
        )
    todo = list(nodes) if nodes is not None else list(sessions.keys())
    results = real_pmap(lambda n: (n, f(sessions[n], n)), todo)
    return dict(results)
