"""Remote implementations: dummy, local subprocess, ssh CLI, docker,
kubectl, and a retrying wrapper.

The port's copy of `jepsen_tpu/control/remotes.py`: the dummy remote,
which never touches the network (the `:dummy?` strategy of a run with
`--dummy-ssh`), the local-subprocess remote the demo suites run on
(every node a port and a data directory on this machine), an
`ssh`/`scp` CLI remote (the binaries may be absent; it gates at connect
time; `control/minissh/bin` holds shims that speak SSH-2 for them), a
`docker exec/cp` remote, a `kubectl exec/cp` remote, the retrying
wrapper (≤5 tries, ~100 ms backoff), and `default_remote`, which gives
retry(ssh-cli) as the reference's does.

Every command runs as a `subprocess.run` of its argv: a fork followed
at once by an exec, with every descriptor but the three standard ones
closed, so a command (and any daemon it starts) inherits nothing of the
interpreter's CUDA state.
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


class SshCliRemote(Remote):
    """Shells out to the `ssh`/`scp` binaries (the reference uses the
    sshj library + an scp subprocess; control/scp.clj:29-57).  Gated:
    raises RemoteError at connect time if ssh isn't installed."""

    # A real host over ssh is its own failure domain: packet and
    # clock faults stay on the target machine.
    isolation = frozenset({"net", "clock"})

    def __init__(self):
        self.spec: Optional[ConnSpec] = None

    def _ssh_opts(self) -> list[str]:
        spec = self.spec
        opts = ["-p", str(spec.port), "-l", spec.user]
        if not spec.strict_host_key_checking:
            opts += [
                "-o", "StrictHostKeyChecking=no",
                "-o", "UserKnownHostsFile=/dev/null",
                "-o", "LogLevel=ERROR",
            ]
        if spec.private_key_path:
            opts += ["-i", spec.private_key_path]
        return opts

    def _scp_opts(self) -> list[str]:
        spec = self.spec
        opts = ["-rpC", "-P", str(spec.port)]
        if not spec.strict_host_key_checking:
            opts += [
                "-o", "StrictHostKeyChecking=no",
                "-o", "UserKnownHostsFile=/dev/null",
                "-o", "LogLevel=ERROR",
            ]
        if spec.private_key_path:
            opts += ["-i", spec.private_key_path]
        return opts

    def connect(self, spec: ConnSpec) -> "SshCliRemote":
        if shutil.which("ssh") is None:
            raise RemoteError(
                "ssh binary not found; use DummyRemote/LocalRemote or "
                "install openssh-client"
            )
        r = SshCliRemote()
        r.spec = spec
        return r

    #: Marker separating the remote command's real exit status from
    #: ssh's own: the wrapped remote shell always exits 0, so any
    #: nonzero ssh status (or a missing marker) IS a transport failure —
    #: no stderr guessing, and non-idempotent commands are never
    #: re-run by the retry wrapper for their own failures.
    STATUS_MARKER = "\x01JTPU_STATUS:"

    def execute(self, action: dict) -> dict:
        wrapped = (
            f"{action['cmd']}\nprintf '{self.STATUS_MARKER}%d' \"$?\""
        )
        cmd = ["ssh", *self._ssh_opts(), self.spec.host, wrapped]
        try:
            proc = subprocess.run(
                cmd,
                input=(action.get("in") or "").encode(),
                capture_output=True,
                timeout=action.get("timeout", 300),
            )
        except subprocess.TimeoutExpired as e:
            raise RemoteError(f"ssh timed out: {action['cmd']!r}") from e
        stdout = proc.stdout.decode(errors="replace")
        marker_at = stdout.rfind(self.STATUS_MARKER)
        if proc.returncode != 0:
            raise RemoteError(
                f"ssh to {self.spec.host} failed (status {proc.returncode}): "
                f"{proc.stderr.decode(errors='replace')}"
            )
        if marker_at < 0:
            # ssh exited 0 but the status line never printed: the remote
            # shell ended cleanly without reporting (e.g. the command ran
            # `exit`).  It may well have run — distinct type so
            # RetryRemote won't replay a possibly-applied non-idempotent
            # command.  NOTE: a command that tears the connection down
            # hard (reboot, networking restart) usually makes ssh exit
            # 255 instead, which is indistinguishable from a transport
            # failure and IS retried — wrap such commands in nohup/
            # disown+sleep so the shell reports before the link drops.
            raise RemoteDisconnected(
                f"remote shell on {self.spec.host} ended before reporting "
                f"status for {action['cmd']!r}"
            )
        status = int(stdout[marker_at + len(self.STATUS_MARKER):] or -1)
        out = dict(action)
        out.update(
            {
                "host": self.spec.host,
                "out": stdout[:marker_at],
                "err": proc.stderr.decode(errors="replace"),
                "exit": status,
            }
        )
        return out

    def _scp(self, sources: Sequence[str], dest: str) -> None:
        proc = subprocess.run(
            ["scp", *self._scp_opts(), *sources, dest],
            capture_output=True,
        )
        if proc.returncode != 0:
            raise RemoteError(
                f"scp failed: {proc.stderr.decode(errors='replace')}"
            )

    def upload(self, local_paths: Sequence[str], remote_path: str) -> None:
        host = f"{self.spec.user}@{self.spec.host}"
        self._scp(list(local_paths), f"{host}:{remote_path}")

    def download(self, remote_paths: Sequence[str], local_path: str) -> None:
        host = f"{self.spec.user}@{self.spec.host}"
        self._scp([f"{host}:{p}" for p in remote_paths], local_path)


class DockerRemote(Remote):
    """docker exec / docker cp transport (control/docker.clj:30-92); the
    node name is the container name."""

    # A container has its own netns, so packet faults are contained;
    # the clock is the host's — skewing it would wound the control
    # host too, so "clock" is deliberately absent.
    isolation = frozenset({"net"})

    def __init__(self):
        self.spec: Optional[ConnSpec] = None

    def connect(self, spec: ConnSpec) -> "DockerRemote":
        if shutil.which("docker") is None:
            raise RemoteError("docker binary not found")
        r = DockerRemote()
        r.spec = spec
        return r

    def execute(self, action: dict) -> dict:
        cmd = [
            "docker", "exec", "-i", self.spec.host,
            "bash", "-c", action["cmd"],
        ]
        try:
            proc = subprocess.run(
                cmd,
                input=(action.get("in") or "").encode(),
                capture_output=True,
                timeout=action.get("timeout", 300),
            )
        except subprocess.TimeoutExpired as e:
            raise RemoteError(f"docker exec timed out") from e
        out = dict(action)
        out.update(
            {
                "host": self.spec.host,
                "out": proc.stdout.decode(errors="replace"),
                "err": proc.stderr.decode(errors="replace"),
                "exit": proc.returncode,
            }
        )
        return out

    def upload(self, local_paths: Sequence[str], remote_path: str) -> None:
        for p in local_paths:
            subprocess.run(
                ["docker", "cp", p, f"{self.spec.host}:{remote_path}"],
                check=True,
            )

    def download(self, remote_paths: Sequence[str], local_path: str) -> None:
        for p in remote_paths:
            subprocess.run(
                ["docker", "cp", f"{self.spec.host}:{p}", local_path],
                check=True,
            )


class K8sRemote(Remote):
    """kubectl exec / kubectl cp transport (control/k8s.clj:14-60); the
    node name is the pod name.  Optional kubectl context/namespace are
    fixed at construction — ConnSpec carries only the pod."""

    # A pod runs on a separate cluster node: both packet and clock
    # faults stay on the target's machine, not the control host.
    isolation = frozenset({"net", "clock"})

    def __init__(self, context: Optional[str] = None,
                 namespace: Optional[str] = None):
        self.context = context
        self.namespace = namespace
        self.spec: Optional[ConnSpec] = None

    def _flags(self) -> list[str]:
        flags = []
        if self.context:
            flags += ["--context", self.context]
        if self.namespace:
            flags += ["--namespace", self.namespace]
        return flags

    def connect(self, spec: ConnSpec) -> "K8sRemote":
        if shutil.which("kubectl") is None:
            raise RemoteError("kubectl binary not found")
        r = K8sRemote(self.context, self.namespace)
        r.spec = spec
        return r

    def execute(self, action: dict) -> dict:
        cmd = [
            "kubectl", "exec", "-i", *self._flags(), self.spec.host,
            "--", "sh", "-c", action["cmd"],
        ]
        try:
            proc = subprocess.run(
                cmd,
                input=(action.get("in") or "").encode(),
                capture_output=True,
                timeout=action.get("timeout", 300),
            )
        except subprocess.TimeoutExpired as e:
            raise RemoteError("kubectl exec timed out") from e
        out = dict(action)
        out.update(
            {
                "host": self.spec.host,
                "out": proc.stdout.decode(errors="replace"),
                "err": proc.stderr.decode(errors="replace"),
                "exit": proc.returncode,
            }
        )
        return out

    def _cp(self, src: str, dst: str) -> None:
        proc = subprocess.run(
            ["kubectl", "cp", *self._flags(), src, dst],
            capture_output=True,
        )
        if proc.returncode != 0:
            raise RemoteError(
                f"kubectl cp {src} -> {dst} failed: "
                f"{proc.stderr.decode(errors='replace')}"
            )

    def upload(self, local_paths: Sequence[str], remote_path: str) -> None:
        for p in local_paths:
            self._cp(p, f"{self.spec.host}:{remote_path}")

    def download(self, remote_paths: Sequence[str], local_path: str) -> None:
        for p in remote_paths:
            self._cp(f"{self.spec.host}:{p}", local_path)


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
    """Picks a transport for the test, the reference's default being
    retry(scp(sshj)) (control/sshj.clj:201-207): here retry(ssh-cli),
    with dummy short-circuit via test["ssh"]["dummy?"]."""
    ssh = test.get("ssh", {}) or {}
    if ssh.get("dummy?"):
        return DummyRemote()
    remote = test.get("remote")
    if remote is not None:
        return remote
    return RetryRemote(SshCliRemote())
