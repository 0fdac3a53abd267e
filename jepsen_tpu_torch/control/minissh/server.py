"""Threaded SSH exec server over minissh.transport.

Serves the slice of SSH that jepsen-tpu's control layer uses
(control/remotes.py SshCliRemote; reference behavior at
control_test.clj:157-161): publickey/password userauth, one "session"
channel per connection, "exec" with streamed stdin/stdout/stderr and
exit-status, plus a built-in scp sink/source (the image has no scp
binary, so `scp -t/-f` exec commands are served in-process through
scp.py).

Commands run as the server's own user via bash -c in `root_dir`, each a
fork followed at once by an exec with every descriptor but the three
standard ones closed, so a command (and any daemon it starts) inherits
nothing of a serving interpreter's CUDA state.  This
is a test fixture standing in for a cluster node, not a hardened
daemon: it binds loopback by default and trusts its configured keys.
"""

from __future__ import annotations

import os
import shlex
import socket
import subprocess
import threading

from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey,
)
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
    MSG_USERAUTH_PK_OK,
    MSG_USERAUTH_REQUEST,
    MSG_USERAUTH_SUCCESS,
    Buf,
    SshError,
    Transport,
    hostkey_blob,
    pub_from_blob,
    sig_from_blob,
    sstr,
    u32,
)

WINDOW = 1 << 30
MAX_PACKET = 32768

#: The longest one socket read or write of a connection may wait: a
#: client gone silent mid-handshake or mid-session ends its connection
#: instead of holding a thread forever.  (A running command's own
#: silence is waited out by select polling, not by a socket read.)
CONN_TIMEOUT_S = 120.0


def generate_keypair(directory: str, name: str = "id_ed25519"):
    """Writes an OpenSSH-format ed25519 keypair into `directory`;
    returns (private_path, public_blob).  Replaces ssh-keygen, which
    the image doesn't ship."""
    key = Ed25519PrivateKey.generate()
    priv_path = os.path.join(directory, name)
    with open(priv_path, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.OpenSSH,
            serialization.NoEncryption(),
        ))
    os.chmod(priv_path, 0o600)
    blob = hostkey_blob(key.public_key())
    import base64

    with open(priv_path + ".pub", "wb") as f:
        f.write(b"ssh-ed25519 " + base64.b64encode(blob) + b" minissh\n")
    return priv_path, blob


class MiniSshServer:
    """One loopback "node".  start() binds an ephemeral port; .port
    tells clients where to dial."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 authorized_keys: list[bytes] | None = None,
                 passwords: dict[str, str] | None = None,
                 root_dir: str | None = None,
                 hostname: str | None = None):
        self.host = host
        self.port = port
        self.authorized_keys = list(authorized_keys or [])
        self.passwords = dict(passwords or {})
        self.root_dir = root_dir
        self.hostname = hostname
        self.host_key = Ed25519PrivateKey.generate()
        self._sock: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._stopping = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "MiniSshServer":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(32)
        self.port = s.getsockname()[1]
        self._sock = s
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stopping.set()
        if self._sock:
            try:
                self._sock.close()
            except OSError:
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- connection handling -----------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            )
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        conn.settimeout(CONN_TIMEOUT_S)
        tr = Transport(conn, server_side=True, host_key=self.host_key)
        try:
            tr.handshake()
            if not self._userauth(tr):
                return
            self._session(tr)
            # Give the client a beat to send its own CLOSE before the
            # socket drops, so its final writes don't see EPIPE.
            deadline = 5.0
            while deadline > 0 and tr.readable(timeout=0.25):
                deadline -= 0.25
                pkt = tr.read_message()
                if pkt and pkt[0] == MSG_CHANNEL_CLOSE:
                    break
        except (SshError, OSError):
            pass
        finally:
            tr.close()

    def _userauth(self, tr: Transport) -> bool:
        while True:
            pkt = tr.read_message()
            buf = Buf(pkt)
            t = buf.byte()
            if t == MSG_SERVICE_REQUEST:
                svc = buf.string()
                tr.write_packet(
                    bytes([MSG_SERVICE_ACCEPT]) + sstr(svc)
                )
                continue
            if t != MSG_USERAUTH_REQUEST:
                raise SshError(f"expected USERAUTH_REQUEST, got {t}")
            user = buf.string().decode()
            buf.string()  # service: ssh-connection
            method = buf.string()
            if method == b"publickey":
                has_sig = buf.bool()
                alg = buf.string()
                blob = buf.string()
                if alg != b"ssh-ed25519" or blob not in self.authorized_keys:
                    self._auth_fail(tr)
                    continue
                if not has_sig:
                    tr.write_packet(
                        bytes([MSG_USERAUTH_PK_OK]) + sstr(alg) + sstr(blob)
                    )
                    continue
                sig = sig_from_blob(buf.string())
                # signed blob (RFC 4252 §7): session_id + the request
                # up to and including the key blob, sans signature
                signed = (
                    sstr(tr.session_id)
                    + bytes([MSG_USERAUTH_REQUEST])
                    + sstr(user.encode())
                    + sstr(b"ssh-connection")
                    + sstr(b"publickey")
                    + b"\x01"
                    + sstr(alg)
                    + sstr(blob)
                )
                try:
                    pub_from_blob(blob).verify(sig, signed)
                except Exception:
                    self._auth_fail(tr)
                    continue
                tr.write_packet(bytes([MSG_USERAUTH_SUCCESS]))
                return True
            if method == b"password":
                buf.bool()
                pw = buf.string().decode()
                if self.passwords.get(user) == pw:
                    tr.write_packet(bytes([MSG_USERAUTH_SUCCESS]))
                    return True
                self._auth_fail(tr)
                continue
            self._auth_fail(tr)

    def _auth_fail(self, tr: Transport) -> None:
        tr.write_packet(
            bytes([MSG_USERAUTH_FAILURE])
            + sstr(b"publickey,password") + b"\x00"
        )

    # -- session channel ---------------------------------------------------

    def _session(self, tr: Transport) -> None:
        chan_peer = None
        while True:
            pkt = tr.read_message()
            buf = Buf(pkt)
            t = buf.byte()
            if t == MSG_CHANNEL_OPEN:
                kind = buf.string()
                peer_id = buf.u32()
                if kind != b"session":
                    tr.write_packet(
                        bytes([MSG_CHANNEL_OPEN_FAILURE]) + u32(peer_id)
                        + u32(3) + sstr(b"only session") + sstr(b"")
                    )
                    continue
                chan_peer = peer_id
                tr.write_packet(
                    bytes([MSG_CHANNEL_OPEN_CONFIRMATION])
                    + u32(peer_id) + u32(0) + u32(WINDOW) + u32(MAX_PACKET)
                )
            elif t == MSG_CHANNEL_REQUEST:
                buf.u32()  # our channel id (0)
                req = buf.string()
                want_reply = buf.bool()
                if req == b"exec" and chan_peer is not None:
                    command = buf.string().decode()
                    if want_reply:
                        tr.write_packet(
                            bytes([MSG_CHANNEL_SUCCESS]) + u32(chan_peer)
                        )
                    self._exec(tr, chan_peer, command)
                    return
                if req == b"env":
                    if want_reply:
                        tr.write_packet(
                            bytes([MSG_CHANNEL_SUCCESS]) + u32(chan_peer)
                        )
                elif want_reply:
                    tr.write_packet(
                        bytes([MSG_CHANNEL_FAILURE]) + u32(chan_peer)
                    )
            elif t in (MSG_CHANNEL_WINDOW_ADJUST, MSG_CHANNEL_EOF):
                continue
            elif t == MSG_CHANNEL_CLOSE:
                return
            else:
                raise SshError(f"unexpected message {t} pre-exec")

    # -- exec --------------------------------------------------------------

    def _exec(self, tr: Transport, peer: int, command: str) -> None:
        scp_argv = self._parse_scp(command)
        if scp_argv is not None:
            self._exec_scp(tr, peer, *scp_argv)
            return

        env = dict(os.environ)
        if self.hostname:
            # lets `hostname` report the node name without uts
            # namespaces: tests and DB setup key on it
            env["MINISSH_HOSTNAME"] = self.hostname
            command = (
                f"hostname() {{ echo {shlex.quote(self.hostname)}; }}; "
                f"export -f hostname >/dev/null 2>&1; " + command
            )
        proc = subprocess.Popen(
            ["/bin/bash", "-c", command],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            cwd=self.root_dir,
            env=env,
            close_fds=True,
        )

        def pump(stream, mtype, extended):
            while True:
                chunk = stream.read(32768)
                if not chunk:
                    return
                if extended:
                    tr.write_packet(
                        bytes([mtype]) + u32(peer) + u32(1) + sstr(chunk)
                    )
                else:
                    tr.write_packet(
                        bytes([mtype]) + u32(peer) + sstr(chunk)
                    )

        t_out = threading.Thread(
            target=pump, args=(proc.stdout, MSG_CHANNEL_DATA, False),
            daemon=True,
        )
        t_err = threading.Thread(
            target=pump, args=(proc.stderr, MSG_CHANNEL_EXTENDED_DATA, True),
            daemon=True,
        )
        t_out.start()
        t_err.start()

        # Main loop: feed stdin from channel data until client EOF.
        stdin_open = True
        closed = False
        while True:
            if not tr.readable(timeout=0.05):
                if proc.poll() is not None:
                    break
                continue
            try:
                pkt = tr.read_message()
            except (SshError, OSError):
                proc.kill()
                closed = True
                break
            buf = Buf(pkt)
            t = buf.byte()
            if t == MSG_CHANNEL_DATA:
                buf.u32()
                data = buf.string()
                if stdin_open:
                    try:
                        proc.stdin.write(data)
                        proc.stdin.flush()
                    except (BrokenPipeError, ValueError):
                        stdin_open = False
            elif t == MSG_CHANNEL_EOF:
                if stdin_open:
                    try:
                        proc.stdin.close()
                    except OSError:
                        pass
                    stdin_open = False
            elif t == MSG_CHANNEL_CLOSE:
                proc.kill()
                closed = True
                break
            elif t == MSG_CHANNEL_WINDOW_ADJUST:
                continue
        if stdin_open:
            try:
                proc.stdin.close()
            except OSError:
                pass
        rc = proc.wait()
        t_out.join(timeout=30)
        t_err.join(timeout=30)
        if not closed:
            tr.write_packet(
                bytes([MSG_CHANNEL_REQUEST]) + u32(peer)
                + sstr(b"exit-status") + b"\x00" + u32(rc & 0xFF)
            )
            tr.write_packet(bytes([MSG_CHANNEL_EOF]) + u32(peer))
            tr.write_packet(bytes([MSG_CHANNEL_CLOSE]) + u32(peer))

    # -- scp ---------------------------------------------------------------

    @staticmethod
    def _parse_scp(command: str):
        """(mode, path, recursive, preserve) when the exec command is a
        classic scp server invocation, else None."""
        try:
            argv = shlex.split(command)
        except ValueError:
            return None
        if not argv or argv[0] != "scp":
            return None
        mode = None
        recursive = preserve = False
        path = None
        for a in argv[1:]:
            if a.startswith("-") and len(a) > 1 and a != "--":
                for c in a[1:]:
                    if c == "t":
                        mode = "sink"
                    elif c == "f":
                        mode = "source"
                    elif c == "r":
                        recursive = True
                    elif c == "p":
                        preserve = True
                    # -d, -v, -C: accepted, no-op here
            else:
                path = a
        if mode is None or path is None:
            return None
        return mode, path, recursive, preserve

    def _exec_scp(self, tr: Transport, peer: int, mode: str, path: str,
                  recursive: bool, preserve: bool) -> None:
        io = _ChannelIO(tr, peer)
        rc = 0
        try:
            if self.root_dir and not os.path.isabs(path):
                path = os.path.join(self.root_dir, path)
            if mode == "sink":
                scp_proto.speak_sink(io, path, recursive=recursive,
                                     preserve=preserve)
            else:
                scp_proto.speak_source(io, path, recursive=recursive,
                                       preserve=preserve)
        except (scp_proto.ScpError, OSError) as e:
            try:
                io.write(b"\x02" + str(e).encode() + b"\n")
            except (SshError, OSError):
                pass
            rc = 1
        tr.write_packet(
            bytes([MSG_CHANNEL_REQUEST]) + u32(peer)
            + sstr(b"exit-status") + b"\x00" + u32(rc)
        )
        tr.write_packet(bytes([MSG_CHANNEL_EOF]) + u32(peer))
        tr.write_packet(bytes([MSG_CHANNEL_CLOSE]) + u32(peer))


class _ChannelIO(scp_proto.ScpIO):
    """scp byte stream over one channel's DATA messages."""

    def __init__(self, tr: Transport, peer: int):
        self.tr = tr
        self.peer = peer
        self.buf = b""
        self.eof = False

    def read(self, n: int) -> bytes:
        while not self.buf and not self.eof:
            pkt = self.tr.read_message()
            buf = Buf(pkt)
            t = buf.byte()
            if t == MSG_CHANNEL_DATA:
                buf.u32()
                self.buf += buf.string()
            elif t in (MSG_CHANNEL_EOF, MSG_CHANNEL_CLOSE):
                self.eof = True
            elif t == MSG_CHANNEL_WINDOW_ADJUST:
                continue
            else:
                raise SshError(f"unexpected message {t} in scp stream")
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def write(self, b: bytes) -> None:
        for i in range(0, len(b), MAX_PACKET - 64):
            chunk = b[i:i + MAX_PACKET - 64]
            self.tr.write_packet(
                bytes([MSG_CHANNEL_DATA]) + u32(self.peer) + sstr(chunk)
            )


def main(argv=None) -> int:
    """Standalone node daemon: `python -m jepsen_tpu_torch.control.
    minissh.server --host 10.x.y.z --authorized-keys id_ed25519.pub`.  Run
    inside a network namespace (ip netns exec), this turns a namespace
    into a full SSH-reachable cluster node — the netns analogue of the
    docker harness's sshd containers (tools/cluster)."""
    import argparse
    import base64
    import time

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=2200)
    ap.add_argument("--authorized-keys", required=True,
                    help="OpenSSH .pub file; each ssh-ed25519 line is "
                    "accepted for any user")
    ap.add_argument("--hostname", default=None)
    ap.add_argument("--root-dir", default=None)
    args = ap.parse_args(argv)

    blobs = []
    with open(args.authorized_keys, "rb") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2 and parts[0] == b"ssh-ed25519":
                blobs.append(base64.b64decode(parts[1]))
    if not blobs:
        ap.error(f"no ssh-ed25519 keys in {args.authorized_keys}")

    srv = MiniSshServer(
        args.host, args.port, authorized_keys=blobs,
        hostname=args.hostname, root_dir=args.root_dir,
    ).start()
    print(f"listening {args.host}:{srv.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
