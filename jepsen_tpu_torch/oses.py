"""OS protocol: preparing nodes before the DB goes on.

The port's copy of `jepsen_tpu/oses.py`.

Equivalent of jepsen/src/jepsen/os.clj (:4-8) and the
os/{debian,ubuntu,centos}.clj implementations (package install, hostfile
setup).  Named `oses` to avoid shadowing the stdlib `os` module.
"""

from __future__ import annotations

import logging
from typing import Any, Sequence

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


class DebianOS(OS):
    """Debian/Ubuntu node prep (os/debian.clj:14-181): hostname in
    /etc/hosts, apt packages installed on demand."""

    def __init__(self, packages: Sequence[str] = ()):
        self.packages = list(packages)

    def setup(self, test: dict, sess: Session, node: str) -> None:
        self.setup_hostfile(test, sess, node)
        if self.packages:
            self.install(sess, self.packages)

    def setup_hostfile(self, test: dict, sess: Session, node: str) -> None:
        """Ensures every test node resolves (os/debian.clj:14-27)."""
        nodes = test.get("nodes") or []
        lines = ["127.0.0.1 localhost"]
        for n in nodes:
            try:
                ip = sess.exec("getent", "hosts", n).split()[0]
            except Exception:  # noqa: BLE001 - unresolvable: leave to DNS
                continue
            lines.append(f"{ip} {n}")
        with sess.su():
            sess.exec(
                "tee", "/etc/hosts", stdin="\n".join(lines) + "\n"
            )

    def install(self, sess: Session, packages: Sequence[str]) -> None:
        """apt-get install missing packages (os/debian.clj:62-90)."""
        with sess.su():
            sess.exec(
                "env", "DEBIAN_FRONTEND=noninteractive",
                "apt-get", "install", "-y", "--no-install-recommends",
                *packages,
            )

    def teardown(self, test: dict, sess: Session, node: str) -> None:
        pass


debian = DebianOS()


class UbuntuOS(DebianOS):
    """Ubuntu node prep (os/ubuntu.clj): Debian mechanics plus the
    standard package load-out and a net heal."""

    DEFAULT_PACKAGES = (
        "apt-transport-https", "wget", "curl", "vim", "man-db",
        "faketime", "ntpdate", "unzip", "iptables", "psmisc", "tar",
        "bzip2", "iputils-ping", "iproute2", "rsyslog", "sudo",
        "logrotate",
    )

    def __init__(self, packages: Sequence[str] = ()):
        super().__init__(list(packages) or list(self.DEFAULT_PACKAGES))

    def setup(self, test: dict, sess: Session, node: str) -> None:
        super().setup(test, sess, node)
        net = test.get("net")
        if net is not None:
            try:
                net.heal(test)
            except Exception:  # noqa: BLE001 — `meh`, like the reference
                log.debug("net heal during OS setup failed", exc_info=True)


ubuntu = UbuntuOS()


class CentOSOS(OS):
    """CentOS node prep (os/centos.clj): loopback hostname entry, yum
    update at most daily, yum package install."""

    def __init__(self, packages: Sequence[str] = ()):
        self.packages = list(packages)

    def setup(self, test: dict, sess: Session, node: str) -> None:
        self.setup_hostfile(sess)
        self.maybe_update(sess)
        if self.packages:
            self.install(sess, self.packages)

    def setup_hostfile(self, sess: Session) -> None:
        """Appends the hostname to the loopback line
        (os/centos.clj:12-25)."""
        name = sess.exec("hostname")
        hosts = sess.exec("cat", "/etc/hosts") or ""
        out = []
        for line in hosts.splitlines():
            if line.startswith("127.0.0.1") and name not in line:
                line = f"{line} {name}"
            out.append(line)
        with sess.su():
            sess.exec("tee", "/etc/hosts", stdin="\n".join(out) + "\n")

    def maybe_update(self, sess: Session) -> None:
        """yum update unless one ran in the last day
        (os/centos.clj:27-44)."""
        try:
            now = int(sess.exec("date", "+%s"))
            last = int(sess.exec("stat", "-c", "%Y", "/var/log/yum.log"))
            if now - last < 86400:
                return
        except Exception:  # noqa: BLE001 — no yum.log: just update
            pass
        with sess.su():
            sess.exec_star("yum", "-y", "update")

    def install(self, sess: Session, packages: Sequence[str]) -> None:
        with sess.su():
            sess.exec("yum", "install", "-y", *packages)


centos = CentOSOS()


class SmartOSOS(CentOSOS):
    """SmartOS node prep (os/smartos.clj): the CentOS hostfile
    mechanics with pkgin as the package manager."""

    def maybe_update(self, sess: Session) -> None:
        try:
            now = int(sess.exec("date", "+%s"))
            last = int(sess.exec(
                "stat", "-c", "%Y", "/var/db/pkgin/pkgin.db"
            ))
            if now - last < 86400:
                return
        except Exception:  # noqa: BLE001 — no pkgin db yet: update
            pass
        with sess.su():
            sess.exec_star("pkgin", "-y", "update")

    def install(self, sess: Session, packages: Sequence[str]) -> None:
        with sess.su():
            sess.exec("pkgin", "-y", "install", *packages)


smartos = SmartOSOS()


def setup(test: dict) -> None:
    """OS setup across the surviving nodes (core.clj:92-99 with-os);
    per-node failures go through the node-loss policy (abort vs
    quarantine-and-shrink)."""
    osys = test.get("os") or noop
    health.run_phase(test, "os setup", lambda s, n: osys.setup(test, s, n))


def teardown(test: dict) -> None:
    osys = test.get("os") or noop
    on_nodes(test, lambda s, n: osys.teardown(test, s, n))
