"""SSH-2 binary packet protocol + curve25519-sha256 key exchange.

RFC 4253 (transport), RFC 8731 (curve25519 kex), RFC 8709
(ssh-ed25519).  One ciphersuite: aes128-ctr + hmac-sha2-256, no
compression, no rekeying.  Both client and server sides live here; the
asymmetry is confined to `Transport.handshake`.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import os
import socket
import struct
import threading

from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey,
    Ed25519PublicKey,
)
from cryptography.hazmat.primitives.asymmetric.x25519 import (
    X25519PrivateKey,
    X25519PublicKey,
)
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

VERSION = b"SSH-2.0-jepsen_tpu_minissh_0.1"

# message numbers (RFC 4253 / 4252 / 4254)
MSG_DISCONNECT = 1
MSG_IGNORE = 2
MSG_UNIMPLEMENTED = 3
MSG_DEBUG = 4
MSG_SERVICE_REQUEST = 5
MSG_SERVICE_ACCEPT = 6
MSG_KEXINIT = 20
MSG_NEWKEYS = 21
MSG_KEX_ECDH_INIT = 30
MSG_KEX_ECDH_REPLY = 31
MSG_USERAUTH_REQUEST = 50
MSG_USERAUTH_FAILURE = 51
MSG_USERAUTH_SUCCESS = 52
MSG_USERAUTH_PK_OK = 60
MSG_GLOBAL_REQUEST = 80
MSG_REQUEST_SUCCESS = 81
MSG_REQUEST_FAILURE = 82
MSG_CHANNEL_OPEN = 90
MSG_CHANNEL_OPEN_CONFIRMATION = 91
MSG_CHANNEL_OPEN_FAILURE = 92
MSG_CHANNEL_WINDOW_ADJUST = 93
MSG_CHANNEL_DATA = 94
MSG_CHANNEL_EXTENDED_DATA = 95
MSG_CHANNEL_EOF = 96
MSG_CHANNEL_CLOSE = 97
MSG_CHANNEL_REQUEST = 98
MSG_CHANNEL_SUCCESS = 99
MSG_CHANNEL_FAILURE = 100

KEX_ALGO = b"curve25519-sha256"
HOSTKEY_ALGO = b"ssh-ed25519"
CIPHER = b"aes128-ctr"
MAC = b"hmac-sha2-256"


class SshError(Exception):
    pass


# ------------------------------------------------------------ wire encoding


def u32(x: int) -> bytes:
    return struct.pack(">I", x)


def sstr(b: bytes) -> bytes:
    return u32(len(b)) + b


def mpint(x: int) -> bytes:
    if x == 0:
        return u32(0)
    b = x.to_bytes((x.bit_length() + 7) // 8, "big")
    if b[0] & 0x80:  # positive numbers need a leading zero bit
        b = b"\x00" + b
    return sstr(b)


class Buf:
    """Sequential reader over a packet payload."""

    __slots__ = ("b", "i")

    def __init__(self, b: bytes):
        self.b = b
        self.i = 0

    def byte(self) -> int:
        self.i += 1
        return self.b[self.i - 1]

    def bool(self) -> bool:
        return self.byte() != 0

    def u32(self) -> int:
        v = struct.unpack_from(">I", self.b, self.i)[0]
        self.i += 4
        return v

    def string(self) -> bytes:
        n = self.u32()
        s = self.b[self.i:self.i + n]
        if len(s) != n:
            raise SshError("truncated string")
        self.i += n
        return s

    def rest(self) -> bytes:
        return self.b[self.i:]


# ------------------------------------------------------------- host keys


def hostkey_blob(pub: Ed25519PublicKey) -> bytes:
    from cryptography.hazmat.primitives.serialization import (
        Encoding,
        PublicFormat,
    )

    raw = pub.public_bytes(Encoding.Raw, PublicFormat.Raw)
    return sstr(HOSTKEY_ALGO) + sstr(raw)


def pub_from_blob(blob: bytes) -> Ed25519PublicKey:
    buf = Buf(blob)
    algo = buf.string()
    if algo != HOSTKEY_ALGO:
        raise SshError(f"unsupported key algo {algo!r}")
    return Ed25519PublicKey.from_public_bytes(buf.string())


def sig_blob(sig: bytes) -> bytes:
    return sstr(HOSTKEY_ALGO) + sstr(sig)


def sig_from_blob(blob: bytes) -> bytes:
    buf = Buf(blob)
    if buf.string() != HOSTKEY_ALGO:
        raise SshError("unsupported signature algo")
    return buf.string()


# ------------------------------------------------------------- transport


def _kexinit_payload() -> bytes:
    nl = sstr  # name-list == string of comma-joined names
    return (
        bytes([MSG_KEXINIT])
        + os.urandom(16)
        + nl(KEX_ALGO)
        + nl(HOSTKEY_ALGO)
        + nl(CIPHER)      # ciphers c->s
        + nl(CIPHER)      # ciphers s->c
        + nl(MAC)         # macs c->s
        + nl(MAC)         # macs s->c
        + nl(b"none")     # compression c->s
        + nl(b"none")     # compression s->c
        + nl(b"")         # languages c->s
        + nl(b"")         # languages s->c
        + b"\x00"         # first_kex_packet_follows
        + u32(0)          # reserved
    )


def _check_kexinit(payload: bytes) -> None:
    buf = Buf(payload)
    if buf.byte() != MSG_KEXINIT:
        raise SshError("expected KEXINIT")
    buf.i += 16  # cookie
    lists = [buf.string() for _ in range(10)]
    wanted = [KEX_ALGO, HOSTKEY_ALGO, CIPHER, CIPHER, MAC, MAC,
              b"none", b"none"]
    for want, got in zip(wanted, lists):
        names = got.split(b",")
        if want not in names:
            raise SshError(
                f"no common algorithm: need {want!r} in {got!r}"
            )


class Transport:
    """One SSH connection's packet layer, after `handshake()` runs the
    version exchange + kex + (for clients) the caller does userauth."""

    def __init__(self, sock: socket.socket, *, server_side: bool,
                 host_key: Ed25519PrivateKey | None = None):
        self.sock = sock
        self.server_side = server_side
        self.host_key = host_key
        self._rbuf = b""
        self._wlock = threading.Lock()  # exec pumps write concurrently
        self._seq_in = 0
        self._seq_out = 0
        self._enc = None   # outgoing cipher ctx
        self._dec = None   # incoming cipher ctx
        self._mac_out = b""
        self._mac_in = b""
        self.session_id: bytes | None = None

    # -- raw socket helpers ------------------------------------------------

    def _recv_exact(self, n: int) -> bytes:
        while len(self._rbuf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise SshError("connection closed")
            self._rbuf += chunk
        out, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        return out

    def _recv_line(self) -> bytes:
        while b"\n" not in self._rbuf:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise SshError("connection closed in version exchange")
            self._rbuf += chunk
        line, self._rbuf = self._rbuf.split(b"\n", 1)
        return line.rstrip(b"\r")

    # -- packets -----------------------------------------------------------

    def write_packet(self, payload: bytes) -> None:
        block = 16 if self._enc else 8
        # packet_length(4) + padding_length(1) + payload + padding ≡ 0
        # (mod block); padding ≥ 4.
        pad = block - ((5 + len(payload)) % block)
        if pad < 4:
            pad += block
        pkt = u32(1 + len(payload) + pad) + bytes([pad]) + payload \
            + os.urandom(pad)
        with self._wlock:
            if self._enc:
                mac = hmac_mod.new(
                    self._mac_out, u32(self._seq_out) + pkt, hashlib.sha256
                ).digest()
                pkt = self._enc.update(pkt) + mac
            self.sock.sendall(pkt)
            self._seq_out = (self._seq_out + 1) & 0xFFFFFFFF

    def read_packet(self) -> bytes:
        if self._dec:
            first = self._dec.update(self._recv_exact(16))
            plen = struct.unpack(">I", first[:4])[0]
            if plen > 1 << 24:
                raise SshError(f"packet too large: {plen}")
            rest = self._dec.update(self._recv_exact(plen - 12))
            mac = self._recv_exact(32)
            pkt = first + rest
            want = hmac_mod.new(
                self._mac_in, u32(self._seq_in) + pkt, hashlib.sha256
            ).digest()
            if not hmac_mod.compare_digest(mac, want):
                raise SshError("bad MAC")
        else:
            first = self._recv_exact(4)
            plen = struct.unpack(">I", first)[0]
            if plen > 1 << 24:
                raise SshError(f"packet too large: {plen}")
            pkt = first + self._recv_exact(plen)
        self._seq_in = (self._seq_in + 1) & 0xFFFFFFFF
        pad = pkt[4]
        # pkt = len(4) + padlen(1) + payload + padding
        payload = pkt[5:4 + struct.unpack(">I", pkt[:4])[0] - pad]
        return payload

    def readable(self, timeout: float = 0.0) -> bool:
        """True when a read_message() call would find bytes to start
        on.  Used instead of socket timeouts: a timeout raised halfway
        through an encrypted packet would desynchronize the CTR
        keystream, so callers must only invoke read_message when
        committed to blocking for the whole packet."""
        if self._rbuf:
            return True
        import select

        r, _, _ = select.select([self.sock], [], [], timeout)
        return bool(r)

    def read_message(self) -> bytes:
        """read_packet, transparently dropping IGNORE/DEBUG."""
        while True:
            p = self.read_packet()
            if not p:
                continue
            if p[0] in (MSG_IGNORE, MSG_DEBUG, MSG_UNIMPLEMENTED):
                continue
            if p[0] == MSG_DISCONNECT:
                buf = Buf(p)
                buf.byte()
                code = buf.u32()
                msg = buf.string()
                raise SshError(f"disconnected ({code}): {msg.decode(errors='replace')}")
            return p

    # -- key exchange ------------------------------------------------------

    def handshake(self) -> None:
        # version exchange
        self.sock.sendall(VERSION + b"\r\n")
        peer = self._recv_line()
        while not peer.startswith(b"SSH-"):
            peer = self._recv_line()  # pre-banner lines are allowed
        if not peer.startswith(b"SSH-2.0-"):
            raise SshError(f"unsupported peer version {peer!r}")
        v_c = peer if self.server_side else VERSION
        v_s = VERSION if self.server_side else peer

        my_kexinit = _kexinit_payload()
        self.write_packet(my_kexinit)
        peer_kexinit = self.read_message()
        _check_kexinit(peer_kexinit)
        i_c = peer_kexinit if self.server_side else my_kexinit
        i_s = my_kexinit if self.server_side else peer_kexinit

        eph = X25519PrivateKey.generate()
        from cryptography.hazmat.primitives.serialization import (
            Encoding,
            PublicFormat,
        )

        my_q = eph.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)

        if self.server_side:
            pkt = self.read_message()
            buf = Buf(pkt)
            if buf.byte() != MSG_KEX_ECDH_INIT:
                raise SshError("expected KEX_ECDH_INIT")
            q_c = buf.string()
            shared = eph.exchange(X25519PublicKey.from_public_bytes(q_c))
            k_s = hostkey_blob(self.host_key.public_key())
            h = self._exchange_hash(v_c, v_s, i_c, i_s, k_s, q_c, my_q,
                                    shared)
            sig = self.host_key.sign(h)
            self.write_packet(
                bytes([MSG_KEX_ECDH_REPLY])
                + sstr(k_s) + sstr(my_q) + sstr(sig_blob(sig))
            )
            q_s = my_q
        else:
            self.write_packet(bytes([MSG_KEX_ECDH_INIT]) + sstr(my_q))
            pkt = self.read_message()
            buf = Buf(pkt)
            if buf.byte() != MSG_KEX_ECDH_REPLY:
                raise SshError("expected KEX_ECDH_REPLY")
            k_s = buf.string()
            q_s = buf.string()
            sig = sig_from_blob(buf.string())
            shared = eph.exchange(X25519PublicKey.from_public_bytes(q_s))
            h = self._exchange_hash(v_c, v_s, i_c, i_s, k_s, my_q, q_s,
                                    shared)
            # Like StrictHostKeyChecking=no (the mode SshCliRemote
            # passes): verify the signature proves possession of the
            # presented key, but accept any host key.
            pub_from_blob(k_s).verify(sig, h)

        if self.session_id is None:
            self.session_id = h
        self.write_packet(bytes([MSG_NEWKEYS]))
        if self.read_message() != bytes([MSG_NEWKEYS]):
            raise SshError("expected NEWKEYS")
        self._activate_keys(shared, h)

    def _exchange_hash(self, v_c, v_s, i_c, i_s, k_s, q_c, q_s,
                       shared: bytes) -> bytes:
        k = int.from_bytes(shared, "big")
        blob = (
            sstr(v_c) + sstr(v_s) + sstr(i_c) + sstr(i_s)
            + sstr(k_s) + sstr(q_c) + sstr(q_s) + mpint(k)
        )
        return hashlib.sha256(blob).digest()

    def _derive(self, shared: bytes, h: bytes, letter: bytes,
                size: int) -> bytes:
        k = mpint(int.from_bytes(shared, "big"))
        out = hashlib.sha256(k + h + letter + self.session_id).digest()
        while len(out) < size:
            out += hashlib.sha256(k + h + out).digest()
        return out[:size]

    def _activate_keys(self, shared: bytes, h: bytes) -> None:
        iv_c = self._derive(shared, h, b"A", 16)
        iv_s = self._derive(shared, h, b"B", 16)
        key_c = self._derive(shared, h, b"C", 16)
        key_s = self._derive(shared, h, b"D", 16)
        mac_c = self._derive(shared, h, b"E", 32)
        mac_s = self._derive(shared, h, b"F", 32)

        def ctr(key, iv):
            return Cipher(algorithms.AES(key), modes.CTR(iv))

        if self.server_side:
            self._dec = ctr(key_c, iv_c).decryptor()
            self._enc = ctr(key_s, iv_s).encryptor()
            self._mac_in, self._mac_out = mac_c, mac_s
        else:
            self._enc = ctr(key_c, iv_c).encryptor()
            self._dec = ctr(key_s, iv_s).decryptor()
            self._mac_in, self._mac_out = mac_s, mac_c

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
