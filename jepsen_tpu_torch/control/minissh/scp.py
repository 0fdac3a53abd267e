"""The classic scp wire protocol, speaker-agnostic.

scp runs over an exec channel: one side is started with `scp -t <dst>`
(sink: receives files) or `scp -f <src>` (source: sends files); the
other side speaks the matching half.  Records:

    C<mode> <size> <name>\n   file, then <size> raw bytes + \0
    D<mode> 0 <name>\n        descend into directory
    E\n                       pop directory
    T<mtime> 0 <atime> 0\n    times for the next C/D (with -p)

Every record and file body is acknowledged with \0 (\1 = warning,
\2 = fatal, each followed by a message line).

Both the in-process server (server.py) and the scp client shim
(bin/scp) call into these two functions with a tiny IO
adapter, so there is exactly one implementation of the protocol.
Reference consumption: control/scp.clj:29-57 shells out to scp the
same way SshCliRemote does.
"""

from __future__ import annotations

import os
import stat as stat_mod


class ScpIO:
    """Adapter the speakers use: a read/write byte stream."""

    def read(self, n: int) -> bytes:  # pragma: no cover - interface
        raise NotImplementedError

    def write(self, b: bytes) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class ScpError(Exception):
    pass


def _read_exact(io: ScpIO, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = io.read(n - len(out))
        if not chunk:
            raise ScpError("unexpected EOF in scp stream")
        out += chunk
    return out


def _read_line(io: ScpIO) -> bytes:
    out = b""
    while True:
        c = io.read(1)
        if not c:
            raise ScpError("unexpected EOF in scp record")
        if c == b"\n":
            return out
        out += c


def _ack(io: ScpIO) -> None:
    io.write(b"\x00")


def _expect_ack(io: ScpIO) -> None:
    c = _read_exact(io, 1)
    if c == b"\x00":
        return
    msg = _read_line(io).decode(errors="replace")
    raise ScpError(f"scp peer error ({c[0]}): {msg}")


def speak_source(io: ScpIO, path: str, *, recursive: bool = False,
                 preserve: bool = False) -> None:
    """Sends `path` (file, or directory with recursive=True) to a sink
    on the other end."""
    _expect_ack(io)  # sink announces readiness

    def send_times(st) -> None:
        io.write(
            f"T{int(st.st_mtime)} 0 {int(st.st_atime)} 0\n".encode()
        )
        _expect_ack(io)

    def send_file(p: str) -> None:
        st = os.stat(p)
        if preserve:
            send_times(st)
        mode = stat_mod.S_IMODE(st.st_mode)
        name = os.path.basename(p.rstrip("/")) or "/"
        io.write(f"C{mode:04o} {st.st_size} {name}\n".encode())
        _expect_ack(io)
        with open(p, "rb") as f:
            left = st.st_size
            while left:
                chunk = f.read(min(65536, left))
                if not chunk:
                    raise ScpError(f"{p} shrank while sending")
                io.write(chunk)
                left -= len(chunk)
        io.write(b"\x00")
        _expect_ack(io)

    def send_dir(p: str) -> None:
        st = os.stat(p)
        if preserve:
            send_times(st)
        mode = stat_mod.S_IMODE(st.st_mode)
        name = os.path.basename(p.rstrip("/")) or "/"
        io.write(f"D{mode:04o} 0 {name}\n".encode())
        _expect_ack(io)
        for entry in sorted(os.listdir(p)):
            walk(os.path.join(p, entry))
        io.write(b"E\n")
        _expect_ack(io)

    def walk(p: str) -> None:
        if os.path.isdir(p):
            if not recursive:
                raise ScpError(f"{p} is a directory (no -r)")
            send_dir(p)
        else:
            send_file(p)

    walk(path)


def speak_sink(io: ScpIO, dst: str, *, recursive: bool = False,
               preserve: bool = False) -> None:
    """Receives files into `dst` from a source on the other end.  When
    dst is an existing directory, entries land inside it; otherwise a
    single incoming file is written at dst itself."""
    _ack(io)  # announce readiness
    dst_is_dir = os.path.isdir(dst)
    stack = [dst]
    pending_times = None

    def target_for(name: str) -> str:
        base = stack[-1]
        if len(stack) > 1 or dst_is_dir:
            return os.path.join(base, name)
        return base

    while True:
        try:
            line = _read_line(io)
        except ScpError:
            return  # clean EOF between records: source is done
        if not line:
            continue
        kind, rest = line[:1], line[1:].decode(errors="replace")
        if kind == b"T":
            parts = rest.split()
            pending_times = (int(parts[2]), int(parts[0]))
            _ack(io)
        elif kind == b"C":
            mode_s, size_s, name = rest.split(" ", 2)
            size = int(size_s)
            path = target_for(os.path.basename(name))
            _ack(io)
            with open(path, "wb") as f:
                left = size
                while left:
                    chunk = io.read(min(65536, left))
                    if not chunk:
                        raise ScpError("EOF mid-file in scp sink")
                    f.write(chunk)
                    left -= len(chunk)
            _expect_ack(io)  # source's end-of-body \0
            os.chmod(path, int(mode_s, 8))
            if preserve and pending_times:
                os.utime(path, pending_times)
            pending_times = None
            _ack(io)
            if len(stack) == 1 and not dst_is_dir and not recursive:
                return  # single-file transfer complete
        elif kind == b"D":
            mode_s, _zero, name = rest.split(" ", 2)
            path = target_for(os.path.basename(name))
            os.makedirs(path, exist_ok=True)
            os.chmod(path, int(mode_s, 8))
            if preserve and pending_times:
                os.utime(path, pending_times)
            pending_times = None
            stack.append(path)
            _ack(io)
        elif kind == b"E":
            if len(stack) > 1:
                stack.pop()
            _ack(io)
            if len(stack) == 1 and not dst_is_dir:
                return
        elif kind in (b"\x01", b"\x02"):
            raise ScpError(f"scp source error: {rest}")
        else:
            io.write(b"\x01bad record\n")
            raise ScpError(f"unknown scp record {line!r}")
