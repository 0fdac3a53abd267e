"""Remote-execution protocol: how the control node reaches DB nodes.

The port's copy of `jepsen_tpu/control/core.py` (no JAX there either).

Equivalent of jepsen/control/core.clj: the
`Remote` protocol (:7-62 — connect/disconnect!/execute!/upload!/
download!), shell `escape` (:71-114), env construction (:116-144),
`wrap-sudo` (:146-157), and `throw-on-nonzero-exit` (:159-175).

An Action is a plain dict describing one remote command:

    {"cmd": str, "in": stdin-str|None, "dir": cwd|None,
     "sudo": user|None, "sudo-password": str|None, "env": {k: v}}

Remotes receive the *wrapped* command (cd/sudo/env applied by
`wrap_action`) and return the action updated with "out", "err",
"exit".
"""

from __future__ import annotations

import re
import shlex
from typing import Any, Iterable, Mapping, Optional, Sequence


def split_host_port(node: Any, default_port: Optional[int] = None):
    """Splits "host:port" node names (localhost clusters publish sshd
    on per-container ports) into (host, port); IPv6 literals pass
    through — use "[v6addr]:port" to give one a port.  The single
    parser for every site that needs it (ConnSpec, clients,
    control_ip)."""
    s = str(node)
    if s.startswith("["):
        host, _, rest = s[1:].partition("]")
        if rest.startswith(":") and rest[1:].isdigit():
            return host, int(rest[1:])
        return host, default_port
    head, sep, tail = s.rpartition(":")
    if sep and tail.isdigit() and ":" not in head:
        return head, int(tail)
    return s, default_port


class RemoteError(Exception):
    """Connection-level failure (the reference's :ssh-failed)."""


class RemoteDisconnected(RemoteError):
    """The remote shell ended cleanly before reporting a status — the
    command itself likely ended the session (`exit`, a clean shutdown).
    The command may have executed, so the retry wrapper must NOT replay
    it (unlike plain RemoteError transport failures).  Commands that
    drop the link abruptly surface as transport failures instead and are
    retried — make them report-then-disconnect (nohup + sleep) if they
    are not idempotent."""


class NonzeroExit(Exception):
    """A remote command exited nonzero (control/core.clj:159-175)."""

    def __init__(self, action: dict):
        self.action = action
        super().__init__(
            f"command {action.get('cmd')!r} on {action.get('host')!r} "
            f"exited {action.get('exit')}:\nstdout: {action.get('out')}\n"
            f"stderr: {action.get('err')}"
        )

    @property
    def exit(self) -> int:
        return self.action.get("exit", -1)

    @property
    def out(self) -> str:
        return self.action.get("out", "")

    @property
    def err(self) -> str:
        return self.action.get("err", "")


class ConnSpec:
    """How to reach one node (the reference's conn-spec map,
    control/core.clj:28-40)."""

    def __init__(
        self,
        host: str,
        *,
        port: int = 22,
        user: str = "root",
        password: Optional[str] = None,
        private_key_path: Optional[str] = None,
        strict_host_key_checking: bool = False,
        dummy: bool = False,
    ):
        self.host = host
        self.port = port
        self.user = user
        self.password = password
        self.private_key_path = private_key_path
        self.strict_host_key_checking = strict_host_key_checking
        self.dummy = dummy

    @staticmethod
    def for_test(test: dict, node: str) -> "ConnSpec":
        ssh = test.get("ssh", {}) or {}
        host, port = split_host_port(node, ssh.get("port", 22))
        return ConnSpec(
            host,
            port=port,
            user=ssh.get("username", "root"),
            password=ssh.get("password"),
            private_key_path=ssh.get("private-key-path"),
            strict_host_key_checking=ssh.get("strict-host-key-checking", False),
            dummy=bool(ssh.get("dummy?", False)),
        )

    def __repr__(self) -> str:
        return f"ConnSpec({self.user}@{self.host}:{self.port})"


class Remote:
    """Pluggable transport (control/core.clj:7-62).  `connect` returns a
    copy bound to a conn spec; bound remotes execute actions and move
    files."""

    #: Capability probe for machine-global fault families.  A remote
    #: that executes on a machine *shared with the control host* (the
    #: default: LocalRemote, DummyRemote) isolates nothing — clock
    #: skew or packet-level interference there wounds the harness
    #: itself, so nemesis callers must skip those families.  Remotes
    #: that reach a genuinely separate failure domain declare what
    #: they isolate: ``"net"`` (packet faults stay on the target) and
    #: ``"clock"`` (time faults stay on the target).
    isolation: frozenset = frozenset()

    def connect(self, spec: ConnSpec) -> "Remote":
        raise NotImplementedError

    def disconnect(self) -> None:
        pass

    def execute(self, action: dict) -> dict:
        """Runs action["cmd"] (already wrapped); returns the action with
        "out", "err", "exit" added."""
        raise NotImplementedError

    def upload(self, local_paths: Sequence[str], remote_path: str) -> None:
        raise NotImplementedError

    def download(self, remote_paths: Sequence[str], local_path: str) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Shell construction
# ---------------------------------------------------------------------------

_SAFE = re.compile(r"^[a-zA-Z0-9_./:=-]+$")


def escape_arg(x: Any) -> str:
    """One shell word (control/core.clj:71-114; we rely on POSIX
    single-quote escaping rather than the reference's hand-rolled
    rules)."""
    s = x if isinstance(x, str) else str(x)
    if _SAFE.match(s):
        return s
    return shlex.quote(s)


class Lit:
    """An unescaped literal command fragment (the reference's
    jepsen.control/lit)."""

    def __init__(self, s: str):
        self.s = s

    def __repr__(self) -> str:
        return f"lit({self.s!r})"


def lit(s: str) -> Lit:
    return Lit(s)


def escape(args: Iterable[Any]) -> str:
    """Joins arguments into an escaped command string; Lit fragments
    pass through raw."""
    words = []
    for a in args:
        if isinstance(a, Lit):
            words.append(a.s)
        else:
            words.append(escape_arg(a))
    return " ".join(words)


def env_str(env: Mapping[str, Any]) -> str:
    """KEY=val prefix string (control/core.clj:116-144)."""
    return " ".join(
        f"{k}={escape_arg(str(v))}" for k, v in sorted(env.items())
    )


def wrap_cd(action: dict) -> dict:
    d = action.get("dir")
    if d:
        action = dict(action)
        action["cmd"] = f"cd {escape_arg(d)}; {action['cmd']}"
    return action


def wrap_env(action: dict) -> dict:
    env = action.get("env")
    if env:
        action = dict(action)
        action["cmd"] = f"env {env_str(env)} {action['cmd']}"
    return action


def wrap_sudo(action: dict) -> dict:
    """control/core.clj:146-157: sudo -S -u <user> with the password on
    stdin ahead of any existing input."""
    user = action.get("sudo")
    if not user:
        return action
    action = dict(action)
    action["cmd"] = f"sudo -S -u {escape_arg(user)} bash -c {shlex.quote(action['cmd'])}"
    password = action.get("sudo-password") or ""
    stdin = action.get("in") or ""
    action["in"] = password + "\n" + stdin
    return action


def wrap_action(action: dict) -> dict:
    # env innermost (prefixes the command), then cd, then sudo — cd
    # outside env, or `env K=V cd d; cmd` drops both the cwd and vars.
    return wrap_sudo(wrap_cd(wrap_env(action)))


def throw_on_nonzero_exit(action: dict) -> dict:
    if action.get("exit", 0) != 0:
        raise NonzeroExit(action)
    return action
