"""Remote script utilities: daemons, downloads, file helpers.

The port's copy of `jepsen_tpu/control/util.py`.

Equivalent of jepsen/src/jepsen/control/util.clj:
`await-tcp-port` (:14-30), `exists?`/`ls` (:41-64), `write-file!`
(:91-105), retrying `wget!`/`cached-wget!` (:107-140+),
`install-archive!`, and pidfile daemon management
(`start-daemon!`/`stop-daemon!`).
"""

from __future__ import annotations

import logging
import os.path
import shlex
import time
from typing import Any, Callable, Optional, Sequence

from ..utils import await_fn
from . import Session
from .core import NonzeroExit, lit


def hashed_base_port(store_root: str, base: int, stride: int = 10,
                     buckets: int = 2000) -> int:
    """Deterministic per-store-dir port base so concurrently-running
    suites (different tmp dirs, one machine) rarely collide.  One
    implementation for every demo suite — the CRC expression used to
    be copy-pasted per suite with drifting strides."""
    import zlib

    return base + (zlib.crc32(store_root.encode()) % buckets) * stride

log = logging.getLogger(__name__)


def exists(sess: Session, path: str) -> bool:
    """control/util.clj:41-46."""
    return sess.exec_star("test", "-e", path)["exit"] == 0


def ls(sess: Session, path: str = ".") -> list[str]:
    """control/util.clj:48-64."""
    out = sess.exec("ls", "-1", path)
    return [l for l in out.splitlines() if l]


def ls_full(sess: Session, path: str) -> list[str]:
    d = path if path.endswith("/") else path + "/"
    return [d + f for f in ls(sess, d)]


def write_file(sess: Session, path: str, content: str) -> None:
    """Writes a string to a remote file via stdin (control/util.clj:91-105)."""
    sess.exec("tee", path, stdin=content)


def await_tcp_port(
    sess: Session,
    port: int,
    *,
    host: str = "localhost",
    timeout_s: float = 60,
    interval_s: float = 0.5,
) -> None:
    """Blocks until [host]:port accepts connections on the node
    (control/util.clj:14-30)."""

    def check() -> bool:
        res = sess.exec_star(
            "bash", "-c", f"exec 3<>/dev/tcp/{host}/{port}"
        )
        if res["exit"] != 0:
            raise RuntimeError(f"port {port} not open on {sess.node}")
        return True

    await_fn(
        check,
        timeout_ms=timeout_s * 1000,
        retry_interval_ms=interval_s * 1000,
        log_message=f"waiting for {host}:{port} on {sess.node}",
    )


def retrying_daemon_start(
    sess: Session,
    start: "Callable[[], Any]",
    port: int,
    *,
    host: str = "localhost",
    tries: int = 3,
    await_timeout_s: float = 10.0,
    interval_s: float = 0.1,
    backoff_ms: float = 200.0,
) -> None:
    """Starts a daemon and waits for its TCP port, retrying the whole
    start+probe cycle with exponential backoff (utils.with_retry) when
    the bind is slow or the daemon died during startup.  A freshly
    rebooted node, a port still in TIME_WAIT from the previous cycle, or
    a daemon that needs a moment to recover its log must not fail the
    run on the first probe — db.cycle would otherwise tear the whole DB
    down and rebuild it for what one more start attempt fixes.  `start`
    must be idempotent (start_daemon is: a live pidfile makes it a
    no-op)."""
    from ..utils import JepsenTimeout, with_retry

    def attempt() -> None:
        start()
        await_tcp_port(
            sess, port, host=host,
            timeout_s=await_timeout_s, interval_s=interval_s,
        )

    def note(msg: str) -> None:
        from .. import telemetry

        telemetry.count("daemon.start-retries")
        log.warning("daemon start on %s port %s: %s", sess.node, port, msg)

    with_retry(
        attempt,
        retries=max(tries - 1, 0),
        backoff_ms=backoff_ms,
        retry_on=(JepsenTimeout, NonzeroExit, RuntimeError),
        log=note,
    )


def wget(sess: Session, url: str, *, force: bool = False) -> str:
    """Downloads url into the current directory if not already present;
    returns the filename (control/util.clj:107-129)."""
    name = url.rstrip("/").rsplit("/", 1)[-1]
    if force or not exists(sess, name):
        sess.exec("rm", "-f", name)
        sess.exec("wget", "--tries", "20", "--waitretry", "60",
                  "--retry-connrefused", "--no-check-certificate", url)
    return name


def install_archive(
    sess: Session, url: str, dest: str, *, force: bool = False
) -> str:
    """Downloads and extracts a tarball/zip into dest
    (control/util.clj:170-250 condensed: no local-file cache layer)."""
    if exists(sess, dest) and not force:
        return dest
    sess.exec("rm", "-rf", dest)
    sess.exec("mkdir", "-p", dest)
    with sess.cd(dest):
        name = wget(sess, url, force=True)
        if name.endswith(".zip"):
            sess.exec("unzip", name)
        else:
            sess.exec("tar", "--no-same-owner", "--no-same-permissions",
                      "--extract", "--file", name)
        sess.exec("rm", "-f", name)
        # If the archive contained a single wrapper dir, splice it out.
        entries = ls(sess, ".")
        if len(entries) == 1:
            inner = entries[0]
            if sess.exec_star("test", "-d", inner)["exit"] == 0:
                sess.exec("bash", "-c",
                          f"mv {inner}/* . 2>/dev/null; rmdir {inner} || true")
    return dest


# ---------------------------------------------------------------------------
# Daemon management (control/util.clj start-daemon!/stop-daemon!)
# ---------------------------------------------------------------------------


def start_daemon(
    sess: Session,
    bin: str,
    *args: Any,
    pidfile: str,
    logfile: str,
    chdir: Optional[str] = None,
    env: Optional[dict] = None,
    make_pidfile: bool = True,
) -> bool:
    """Starts a long-running process detached from the session, tracked
    by a pidfile; returns False if the pidfile already names a live
    process (start-stop-daemon semantics without requiring the binary)."""
    if daemon_running(sess, pidfile):
        return False
    from .core import escape, escape_arg

    cmd = escape([bin, *args])
    if env:
        from .core import env_str

        cmd = f"env {env_str(env)} {cmd}"
    if chdir:
        cmd = f"cd {escape_arg(chdir)} && {cmd}"
    # The daemon must not inherit our stdout/stderr pipes, or callers
    # block until it exits: redirect at the outer level too.
    inner = escape_arg(cmd + f" >> {logfile} 2>&1")
    wrapper = (
        f"nohup setsid bash -c {inner} >/dev/null 2>&1 </dev/null "
        f"& echo $! > {pidfile}"
        if make_pidfile
        else f"nohup setsid bash -c {inner} >/dev/null 2>&1 </dev/null &"
    )
    sess.exec("bash", "-c", wrapper)
    return True


def daemon_running(sess: Session, pidfile: str) -> bool:
    res = sess.exec_star(
        "bash", "-c", f"test -e {pidfile} && kill -0 $(cat {pidfile})"
    )
    return res["exit"] == 0


def stop_daemon(
    sess: Session, pidfile: str, *, signal: str = "KILL"
) -> None:
    """Kills the pidfile's process tree and removes the pidfile
    (control/util.clj stop-daemon!)."""
    sess.exec_star(
        "bash", "-c",
        f"test -e {pidfile} && kill -{signal} -- -$(cat {pidfile}) "
        f"2>/dev/null; kill -{signal} $(cat {pidfile}) 2>/dev/null; true",
    )
    sess.exec("rm", "-f", pidfile)


def grep_kill(sess: Session, pattern: str, *, signal: str = "KILL") -> None:
    """pkill -f by pattern (control/util.clj grepkill!) — see grepkill;
    this spelling keeps the signal-name flavor of the original API."""
    grepkill(sess, pattern, signal=signal)


def control_ip(test: Optional[dict] = None) -> str:
    """The control node's IP as DB nodes would see it
    (control/net.clj control-ip): the source address of a UDP route
    toward the first node (no packets sent), falling back to a public
    resolver target, then loopback."""
    import socket

    from .core import split_host_port

    targets = list((test or {}).get("nodes") or []) + ["8.8.8.8"]
    for t in targets:
        host, _ = split_host_port(t)
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.connect((host, 9))
                return s.getsockname()[0]
        except OSError:
            continue
    return "127.0.0.1"


def grepkill(sess: "Session", pattern: str,
             signal: "int | str" = 9) -> None:
    """Kills every process whose command line matches `pattern`
    (control/util.clj grepkill!).  Best-effort: no match is fine.

    Suite DBs call this on setup BEFORE starting their daemon: an
    interrupted earlier run (SIGKILLed pytest, crashed driver) leaks
    the daemon, and a later suite binding the same port then talks to
    the STALE server — foreign data, false convictions (observed
    round 5: a leaked kvdb on port 7401 convicted a healthy run)."""
    # pkill -f matches FULL cmdlines — including the ssh/bash chain
    # carrying this very pattern as an argument, which -9's our own
    # session (observed: 'ssh failed (status -9)').  The classic
    # bracket trick makes the regex match the target but not any
    # process whose cmdline contains the (bracketed) pattern text.
    if not pattern:
        return
    c = pattern[0]
    # The trick is only sound when the leading character is an
    # ordinary literal: wrapping a metacharacter changes the ERE —
    # '[^...]' becomes a negated class, '[\]' is implementation-
    # defined, '[.]' narrows any-char to literal-dot (and '[.' opens
    # a POSIX collating symbol) — and a changed regex can SIGKILL
    # unrelated processes or miss the target.  Reject rather than
    # guess: every real caller passes a daemon/command name.
    if not (c.isalnum() or c in "_/-"):
        raise ValueError(
            f"grepkill pattern must start with a literal character "
            f"(letter, digit, '_', '/', or '-'), got {c!r}: the "
            f"self-match-avoiding bracket wrap would change the regex"
        )
    safe = f"[{c}]{pattern[1:]}"
    # Elevate: leaked daemons from an interrupted run may be root-owned
    # (suites started under sudo), and an unprivileged pkill would skip
    # them while `|| true` swallowed the permission failure — preserving
    # exactly the stale-server hazard this call exists to remove.
    with sess.su():
        sess.exec_star(
            "bash", "-c",
            f"pkill -{signal} -f -- {shlex.quote(safe)} || true",
        )

