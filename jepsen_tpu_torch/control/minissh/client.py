"""Blocking SSH client over minissh.transport.

One connection, publickey (or password) userauth, one exec channel —
exactly the shape SshCliRemote's per-command `ssh`/`scp` subprocesses
need (control/remotes.py:163-175 runs one command per invocation).
"""

from __future__ import annotations

import socket

from cryptography.hazmat.primitives import serialization

from . import scp as scp_proto
from .transport import (
    MSG_CHANNEL_CLOSE,
    MSG_CHANNEL_DATA,
    MSG_CHANNEL_EOF,
    MSG_CHANNEL_EXTENDED_DATA,
    MSG_CHANNEL_OPEN,
    MSG_CHANNEL_OPEN_CONFIRMATION,
    MSG_CHANNEL_OPEN_FAILURE,
    MSG_CHANNEL_REQUEST,
    MSG_CHANNEL_SUCCESS,
    MSG_CHANNEL_FAILURE,
    MSG_CHANNEL_WINDOW_ADJUST,
    MSG_SERVICE_ACCEPT,
    MSG_SERVICE_REQUEST,
    MSG_USERAUTH_FAILURE,
    MSG_USERAUTH_REQUEST,
    MSG_USERAUTH_SUCCESS,
    Buf,
    SshError,
    Transport,
    hostkey_blob,
    sig_blob,
    sstr,
    u32,
)

WINDOW = 1 << 30
MAX_PACKET = 32768


class SshClient:
    def __init__(self, host: str, port: int = 22, *, user: str = "root",
                 key_path: str | None = None,
                 password: str | None = None,
                 timeout: float = 30.0,
                 io_timeout: float = 900.0):
        self.host = host
        self.port = port
        self.user = user
        self.key_path = key_path
        self.password = password
        self.timeout = timeout
        #: The longest one read or write may wait once the session is
        #: up (a command may run silent for a while, but not forever).
        self.io_timeout = io_timeout
        self.tr: Transport | None = None
        self._chan_peer: int | None = None

    # -- lifecycle ---------------------------------------------------------

    def connect(self) -> "SshClient":
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        )
        # The handshake and userauth wait at most `timeout` a read; the
        # session then `io_timeout`.  A timed-out read ends the
        # connection (OSError), never a desynchronized one.
        self.tr = Transport(sock, server_side=False)
        self.tr.handshake()
        self._userauth()
        sock.settimeout(self.io_timeout)
        return self

    def close(self) -> None:
        if self.tr:
            self.tr.close()

    def __enter__(self):
        return self.connect()

    def __exit__(self, *exc):
        self.close()

    # -- auth --------------------------------------------------------------

    def _userauth(self) -> None:
        tr = self.tr
        tr.write_packet(
            bytes([MSG_SERVICE_REQUEST]) + sstr(b"ssh-userauth")
        )
        pkt = tr.read_message()
        if pkt[0] != MSG_SERVICE_ACCEPT:
            raise SshError("userauth service refused")

        if self.key_path:
            with open(self.key_path, "rb") as f:
                key = serialization.load_ssh_private_key(f.read(), None)
            blob = hostkey_blob(key.public_key())
            base = (
                bytes([MSG_USERAUTH_REQUEST])
                + sstr(self.user.encode())
                + sstr(b"ssh-connection")
                + sstr(b"publickey")
                + b"\x01"
                + sstr(b"ssh-ed25519")
                + sstr(blob)
            )
            sig = key.sign(sstr(tr.session_id) + base)
            tr.write_packet(base + sstr(sig_blob(sig)))
        elif self.password is not None:
            tr.write_packet(
                bytes([MSG_USERAUTH_REQUEST])
                + sstr(self.user.encode())
                + sstr(b"ssh-connection")
                + sstr(b"password")
                + b"\x00"
                + sstr(self.password.encode())
            )
        else:
            raise SshError("no key_path or password configured")
        pkt = tr.read_message()
        if pkt[0] == MSG_USERAUTH_SUCCESS:
            return
        if pkt[0] == MSG_USERAUTH_FAILURE:
            raise SshError("authentication failed")
        raise SshError(f"unexpected userauth reply {pkt[0]}")

    # -- exec --------------------------------------------------------------

    def _open_session(self) -> None:
        tr = self.tr
        tr.write_packet(
            bytes([MSG_CHANNEL_OPEN]) + sstr(b"session")
            + u32(0) + u32(WINDOW) + u32(MAX_PACKET)
        )
        while True:
            pkt = tr.read_message()
            if pkt[0] == MSG_CHANNEL_OPEN_CONFIRMATION:
                buf = Buf(pkt)
                buf.byte()
                buf.u32()  # our id (0)
                self._chan_peer = buf.u32()
                return
            if pkt[0] == MSG_CHANNEL_OPEN_FAILURE:
                raise SshError("channel open refused")

    def run(self, command: str, stdin: bytes = b"",
            stdout_cb=None, stderr_cb=None) -> tuple[int, bytes, bytes]:
        """Execs `command`; returns (exit_status, stdout, stderr).
        Callbacks, when given, stream chunks as they arrive (the CLI
        shim uses them to behave like a real ssh)."""
        tr = self.tr
        self._open_session()
        peer = self._chan_peer
        tr.write_packet(
            bytes([MSG_CHANNEL_REQUEST]) + u32(peer) + sstr(b"exec")
            + b"\x01" + sstr(command.encode())
        )
        # exec reply may interleave with early data; collect as we go
        out, err = [], []
        status = 255
        sender = None
        got_close = False
        got_reply = False

        def send_stdin():
            # A dedicated sender keeps the main loop reading: a large
            # stdin against an echoing command would otherwise deadlock
            # (we block in sendall while the server blocks sending
            # output nobody is reading).  write_packet is lock-
            # protected, so the only other write — the final CLOSE —
            # is safe; it happens after join().
            try:
                for i in range(0, len(stdin), MAX_PACKET - 64):
                    chunk = stdin[i:i + MAX_PACKET - 64]
                    tr.write_packet(
                        bytes([MSG_CHANNEL_DATA]) + u32(peer) + sstr(chunk)
                    )
                tr.write_packet(bytes([MSG_CHANNEL_EOF]) + u32(peer))
            except OSError:
                pass  # connection died; main loop reports it

        while not got_close:
            if got_reply and sender is None:
                import threading

                sender = threading.Thread(target=send_stdin, daemon=True)
                sender.start()
            pkt = tr.read_message()
            buf = Buf(pkt)
            t = buf.byte()
            if t == MSG_CHANNEL_SUCCESS:
                got_reply = True
            elif t == MSG_CHANNEL_FAILURE:
                raise SshError("exec request refused")
            elif t == MSG_CHANNEL_DATA:
                buf.u32()
                data = buf.string()
                out.append(data)
                if stdout_cb:
                    stdout_cb(data)
            elif t == MSG_CHANNEL_EXTENDED_DATA:
                buf.u32()
                buf.u32()  # type 1 = stderr
                data = buf.string()
                err.append(data)
                if stderr_cb:
                    stderr_cb(data)
            elif t == MSG_CHANNEL_REQUEST:
                buf.u32()
                if buf.string() == b"exit-status":
                    buf.bool()
                    status = buf.u32()
            elif t == MSG_CHANNEL_CLOSE:
                got_close = True
            elif t in (MSG_CHANNEL_EOF, MSG_CHANNEL_WINDOW_ADJUST):
                continue
            else:
                raise SshError(f"unexpected message {t} during exec")
        if sender is not None:
            sender.join(timeout=30)
        try:
            tr.write_packet(bytes([MSG_CHANNEL_CLOSE]) + u32(peer))
        except OSError:
            pass  # peer may already have torn the connection down
        return status, b"".join(out), b"".join(err)

    # -- scp ---------------------------------------------------------------

    def scp_upload(self, local: str, remote: str, *,
                   recursive: bool = False, preserve: bool = False) -> int:
        flags = "-t" + ("r" if recursive else "") + \
            ("p" if preserve else "")
        return self._scp(f"scp {flags} {_q(remote)}", "source", local,
                         recursive, preserve)

    def scp_download(self, remote: str, local: str, *,
                     recursive: bool = False, preserve: bool = False) -> int:
        flags = "-f" + ("r" if recursive else "") + \
            ("p" if preserve else "")
        return self._scp(f"scp {flags} {_q(remote)}", "sink", local,
                         recursive, preserve)

    def _scp(self, command: str, role: str, local_path: str,
             recursive: bool, preserve: bool) -> int:
        tr = self.tr
        self._open_session()
        peer = self._chan_peer
        tr.write_packet(
            bytes([MSG_CHANNEL_REQUEST]) + u32(peer) + sstr(b"exec")
            + b"\x01" + sstr(command.encode())
        )
        pkt = tr.read_message()
        if pkt[0] == MSG_CHANNEL_FAILURE:
            raise SshError("scp exec refused")
        io = _ClientChannelIO(self, peer,
                              preread=pkt if pkt[0] != MSG_CHANNEL_SUCCESS
                              else None)
        try:
            if role == "source":
                scp_proto.speak_source(io, local_path,
                                       recursive=recursive,
                                       preserve=preserve)
                try:
                    tr.write_packet(bytes([MSG_CHANNEL_EOF]) + u32(peer))
                except OSError:
                    pass
            else:
                scp_proto.speak_sink(io, local_path,
                                     recursive=recursive,
                                     preserve=preserve)
        except scp_proto.ScpError as e:
            raise SshError(f"scp failed: {e}") from e
        # drain to exit-status
        status = 0
        while True:
            pkt = io.pending_control or self.tr.read_message()
            io.pending_control = None
            buf = Buf(pkt)
            t = buf.byte()
            if t == MSG_CHANNEL_REQUEST:
                buf.u32()
                if buf.string() == b"exit-status":
                    buf.bool()
                    status = buf.u32()
            elif t == MSG_CHANNEL_CLOSE:
                break
            elif t in (MSG_CHANNEL_DATA, MSG_CHANNEL_EXTENDED_DATA,
                       MSG_CHANNEL_EOF, MSG_CHANNEL_WINDOW_ADJUST):
                continue
            else:
                raise SshError(f"unexpected message {t} after scp")
        try:
            tr.write_packet(bytes([MSG_CHANNEL_CLOSE]) + u32(peer))
        except OSError:
            pass
        return status


def _q(path: str) -> str:
    import shlex

    return shlex.quote(path)


class _ClientChannelIO(scp_proto.ScpIO):
    """scp stream over the client's channel; control messages seen
    mid-stream (exit-status, close) are parked for the drain loop."""

    def __init__(self, client: SshClient, peer: int, preread=None):
        self.client = client
        self.peer = peer
        self.buf = b""
        self.eof = False
        self.pending_control = None
        self._preread = preread

    def read(self, n: int) -> bytes:
        while not self.buf and not self.eof:
            if self._preread is not None:
                pkt, self._preread = self._preread, None
            else:
                pkt = self.client.tr.read_message()
            buf = Buf(pkt)
            t = buf.byte()
            if t == MSG_CHANNEL_DATA:
                buf.u32()
                self.buf += buf.string()
            elif t == MSG_CHANNEL_EOF:
                self.eof = True
            elif t in (MSG_CHANNEL_CLOSE, MSG_CHANNEL_REQUEST):
                self.pending_control = pkt
                self.eof = True
            elif t in (MSG_CHANNEL_WINDOW_ADJUST, MSG_CHANNEL_SUCCESS,
                       MSG_CHANNEL_EXTENDED_DATA):
                continue
            else:
                raise SshError(f"unexpected message {t} in scp stream")
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def write(self, b: bytes) -> None:
        for i in range(0, len(b), MAX_PACKET - 64):
            chunk = b[i:i + MAX_PACKET - 64]
            self.client.tr.write_packet(
                bytes([MSG_CHANNEL_DATA]) + u32(self.peer) + sstr(chunk)
            )
