"""OS protocol: preparing nodes before the DB goes on.

The port's copy of `jepsen_tpu/oses.py`, trimmed to the `OS` protocol,
the noop OS and the run's `setup` and `teardown`; the Debian, Ubuntu,
CentOS and SmartOS installers wait for the remotes that reach real
nodes.  Named `oses` so as not to shadow the stdlib `os` module.
"""

from __future__ import annotations

import logging

from .control import Session, health, on_nodes

log = logging.getLogger(__name__)


class OS:
    """os.clj:4-8."""

    def setup(self, test: dict, sess: Session, node: str) -> None:
        pass

    def teardown(self, test: dict, sess: Session, node: str) -> None:
        pass


class NoopOS(OS):
    pass


noop = NoopOS()


def setup(test: dict) -> None:
    """OS setup across the surviving nodes (core.clj:92-99 with-os);
    per-node failures go through the node-loss policy (abort vs
    quarantine-and-shrink)."""
    osys = test.get("os") or noop
    health.run_phase(test, "os setup", lambda s, n: osys.setup(test, s, n))


def teardown(test: dict) -> None:
    osys = test.get("os") or noop
    on_nodes(test, lambda s, n: osys.teardown(test, s, n))
