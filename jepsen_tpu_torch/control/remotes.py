"""Remote implementations: dummy, local subprocess, and a retrying
wrapper.

The port's copy of `jepsen_tpu/control/remotes.py`, trimmed to the dummy
remote, which never touches the network (the `:dummy?` strategy of a
run with `--dummy-ssh`), the local-subprocess remote the demo suites
run on (every node a port and a data directory on this machine), the
retrying wrapper (≤5 tries, ~100 ms backoff), and `default_remote`.
The ssh, docker and k8s remotes are not ported: a test that needs one
supplies it as test["remote"].

A local command runs as `subprocess.run(["bash", "-c", cmd])`: a fork
followed at once by an exec, with every descriptor but the three
standard ones closed, so a command (and any daemon it starts) inherits
nothing of the interpreter's CUDA state.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import threading
from typing import Any, Optional, Sequence

from .. import telemetry
from ..utils import with_retry
from .core import ConnSpec, Remote, RemoteDisconnected, RemoteError

log = logging.getLogger(__name__)


class DummyRemote(Remote):
    """Never touches the network: every command succeeds with empty
    output.  Executed actions are recorded (shared across connect copies)
    so tests can assert on them — the `:dummy?` CI strategy
    (SURVEY.md §4.1)."""

    def __init__(self, log_actions: Optional[list] = None):
        self.actions: list = log_actions if log_actions is not None else []
        self.spec: Optional[ConnSpec] = None

    def connect(self, spec: ConnSpec) -> "DummyRemote":
        # type(self): subclasses (tests override execute to shape
        # probe results) must survive the connect copy.
        r = type(self)(self.actions)
        r.spec = spec
        return r

    def execute(self, action: dict) -> dict:
        out = dict(action)
        out.setdefault("host", self.spec.host if self.spec else None)
        out.update({"out": "", "err": "", "exit": 0})
        self.actions.append(out)
        return out

    def upload(self, local_paths: Sequence[str], remote_path: str) -> None:
        self.actions.append(
            {"upload": list(local_paths), "to": remote_path}
        )

    def download(self, remote_paths: Sequence[str], local_path: str) -> None:
        self.actions.append(
            {"download": list(remote_paths), "to": local_path}
        )


class LocalRemote(Remote):
    """Runs commands on the control node itself via bash — the
    single-machine analog of docker exec, for integration tests against
    local processes."""

    def __init__(self):
        self.spec: Optional[ConnSpec] = None

    def connect(self, spec: ConnSpec) -> "LocalRemote":
        r = LocalRemote()
        r.spec = spec
        return r

    def execute(self, action: dict) -> dict:
        try:
            proc = subprocess.run(
                ["bash", "-c", action["cmd"]],
                input=(action.get("in") or "").encode(),
                capture_output=True,
                timeout=action.get("timeout", 120),
            )
        except subprocess.TimeoutExpired as e:
            raise RemoteError(f"timed out: {action['cmd']!r}") from e
        out = dict(action)
        out.update(
            {
                "host": self.spec.host if self.spec else "localhost",
                "out": proc.stdout.decode(errors="replace"),
                "err": proc.stderr.decode(errors="replace"),
                "exit": proc.returncode,
            }
        )
        return out

    def upload(self, local_paths: Sequence[str], remote_path: str) -> None:
        for p in local_paths:
            shutil.copy(p, remote_path)

    def download(self, remote_paths: Sequence[str], local_path: str) -> None:
        for p in remote_paths:
            if os.path.exists(p):
                dest = (
                    os.path.join(local_path, os.path.basename(p))
                    if os.path.isdir(local_path)
                    else local_path
                )
                shutil.copy(p, dest)


class RetryRemote(Remote):
    """Wraps any Remote with reconnect-and-retry on connection failures:
    ≤5 tries with exponential backoff + jitter (control/retry.clj:15-33
    gives the try count; the schedule is utils.with_retry's, capped low
    so exhaustion stays a few seconds, not half a minute)."""

    TRIES = 5
    BACKOFF_MS = 100.0
    MAX_BACKOFF_MS = 2000.0
    JITTER = 0.5

    def __init__(self, inner: Remote):
        self.inner = inner
        self.spec: Optional[ConnSpec] = None
        self.bound: Optional[Remote] = None
        self._lock = threading.Lock()

    @property
    def isolation(self) -> frozenset:
        # Retry is transparent: the failure domain is the wrapped
        # transport's.
        return self.inner.isolation

    def connect(self, spec: ConnSpec) -> "RetryRemote":
        r = RetryRemote(self.inner)
        r.spec = spec
        r.bound = self.inner.connect(spec)
        return r

    def _reconnect(self) -> None:
        with self._lock:
            try:
                if self.bound is not None:
                    self.bound.disconnect()
            except Exception:  # noqa: BLE001
                pass
            self.bound = self.inner.connect(self.spec)

    def _with_retry(self, f):
        # RemoteDisconnected passes straight through: the command itself
        # ended the session and may have been applied; replaying a
        # non-idempotent command is worse than surfacing the disconnect.
        first = True

        def attempt():
            nonlocal first
            if not first:
                # A previous attempt failed: rebuild the session before
                # replaying.  A reconnect failure is itself a RemoteError
                # and rides the same retry schedule.
                telemetry.count("net.reconnects")
                self._reconnect()
            first = False
            return f()

        try:
            return with_retry(
                attempt,
                retries=self.TRIES - 1,
                backoff_ms=self.BACKOFF_MS,
                max_backoff_ms=self.MAX_BACKOFF_MS,
                jitter=self.JITTER,
                retry_on=(RemoteError,),
                no_retry_on=(RemoteDisconnected,),
                log=lambda m: log.debug("remote call %s", m),
            )
        except RemoteDisconnected:
            raise
        except RemoteError:
            telemetry.count("net.retry.exhausted")
            raise

    def execute(self, action: dict) -> dict:
        return self._with_retry(lambda: self.bound.execute(action))

    def upload(self, local_paths: Sequence[str], remote_path: str) -> None:
        return self._with_retry(lambda: self.bound.upload(local_paths, remote_path))

    def download(self, remote_paths: Sequence[str], local_path: str) -> None:
        return self._with_retry(
            lambda: self.bound.download(remote_paths, local_path)
        )

    def disconnect(self) -> None:
        if self.bound is not None:
            self.bound.disconnect()


def default_remote(test: dict) -> Remote:
    """The test's transport: the dummy remote when test["ssh"]["dummy?"]
    is set, else test["remote"].  The reference's default, a retrying
    ssh remote, is not in the port: without either it raises."""
    ssh = test.get("ssh", {}) or {}
    if ssh.get("dummy?"):
        return DummyRemote()
    remote = test.get("remote")
    if remote is not None:
        return remote
    raise NotImplementedError(
        "no remote: the port has the dummy remote (test['ssh']['dummy?'], "
        "--dummy-ssh), the local remote (LocalRemote, which the suites' "
        "CLIs take by default) or a test-supplied test['remote']; its ssh, "
        "docker and k8s remotes are ROADMAP Queue A item 5")
