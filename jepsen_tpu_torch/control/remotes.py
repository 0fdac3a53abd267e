"""Remote implementations.

The port's copy of `jepsen_tpu/control/remotes.py`, trimmed to the dummy
remote, which never touches the network (the `:dummy?` strategy of a
run with `--dummy-ssh`), and `default_remote`.  The local-subprocess,
ssh, docker, k8s and retrying remotes wait for the suites that reach
real nodes; a test that needs one supplies it as test["remote"].
"""

from __future__ import annotations

from typing import Optional, Sequence

from .core import ConnSpec, Remote


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
        "--dummy-ssh) or a test-supplied test['remote']; its ssh remote "
        "is not ported yet")
