"""The checkerd wire protocol: store-format frames over a TCP stream.

The port's copy of `jepsen_tpu/checkerd/protocol.py`, frame for frame
the same; `model_to_spec` / `model_from_spec` map to the port's models.

A frame is exactly a store block (store/format.py):

    [u32 payload-len][u32 crc32][u8 type][payload]

JSON payloads go through the store's `_encode` (same coercions, same
bytes as at rest); packed-history payloads are raw binary
(history/packed.py `packed_to_bytes`), CRC-checked like everything
else.  Frame types live above the store's block-type range so a frame
can never be mistaken for an on-disk block.

A submit conversation, client -> server:

    SUBMIT {"run", "model", "algorithm", "n-keys", "packed",
            "budget-s", "time-limit-s",
            "tenant": name | null, "deadline-s": s | null,
            "trace": {"trace-id", "parent-span"} | null}
    CHUNK  {"key": i, "ops": [op dicts...]}        (repeatable, ops mode)
    PACKED <u32 key-index><packed bytes>           (one per key, packed mode)
    COMMIT {}
                                  <- TICKET {"ticket", "queue-depth"}
                                   | SHED {"shed": true, "reason",
                                           "retry-after-s", "tenant",
                                           "estimate-s"}
    POLL {"ticket"}               <- PENDING {"state", "queue-depth"}
                                   | RESULT {"valid", "key-results",
                                             "checkerd": {...meta}}
                                   | ERROR {"error"}
    STATS {}                      <- STATS_REPLY {...fleet stats...}
    RESUME {"session"}            <- RESUME_OK {"received": {i: count},
                                                "n-keys"}
                                   | ERROR {"error"}

A streamed SUBMIT may carry a client-minted "session" token; the
server then parks the half-uploaded submission when the connection
dies, and a RESUME on a fresh connection re-attaches to it, replying
with the per-key op counts it already holds (the stable bound) so the
client re-sends only the tail.

The optional SUBMIT "trace" field is the submitting run's telemetry
trace context (telemetry.trace_context()).  The daemon stamps the
cohort's span events with it and ships them back in RESULT meta
("spans" + "pid"), so the run's trace — and tools/trace_merge.py —
can nest daemon-side work under the run's analyze span.  Absent or
null means the submitter doesn't want span transport (older clients
remain wire-compatible: unknown SUBMIT fields are ignored).

Key identity never crosses the wire: the client submits subhistories in
key order and the server replies with `key-results` in the same order,
so arbitrary (unhashable-after-JSON, tuple, KV-subclass) keys stay a
client-side concern.
"""

from __future__ import annotations

import json
import socket
import struct
import zlib
from typing import Any, BinaryIO, Optional

from ..store.format import _HEADER, frame, raw_frame

# Frame types (store blocks use 1..5; leave headroom).
F_SUBMIT = 16
F_CHUNK = 17
F_PACKED = 18  # binary payload: u32 key-index + packed_to_bytes()
F_COMMIT = 19
F_TICKET = 20
F_POLL = 21
F_PENDING = 22
F_RESULT = 23
F_STATS = 24
F_STATS_REPLY = 25
F_ERROR = 26
#: Streaming reconnect (streaming/remote.py): a client whose upload
#: connection died re-attaches to its parked server-side submission and
#: learns the daemon's stable bound — per-key received-op counts — so
#: it re-sends only the tail past the last FULL stable block instead of
#: re-uploading or falling back to a whole-history recheck.
F_RESUME = 27       # {"session": token}
F_RESUME_OK = 28    # {"received": {key-index: op-count}, "n-keys": n}
#: Overload control (checkerd/overload.py): a COMMIT the admission
#: plane refuses answers with a structured RETRY-AFTER instead of a
#: TICKET — deadline-aware shedding and weighted admission are honest,
#: machine-readable refusals, never ERROR-shaped silence.
F_SHED = 29         # {"shed": true, "reason", "retry-after-s", ...}

#: Frame types whose payload is raw bytes, not JSON.
BINARY_TYPES = frozenset({F_PACKED})

#: Upper bound on a single frame's payload: big enough for a 16k-op
#: CHUNK or a multi-million-row packed tensor, small enough that a
#: corrupt length field can't balloon one read into the whole heap.
MAX_FRAME = 1 << 28

_KEY_PREFIX = struct.Struct("<I")


class ProtocolError(Exception):
    """A malformed, truncated, or CRC-failing frame."""


def write_frame(wf: BinaryIO, ftype: int, payload: Any) -> None:
    """Writes one frame; `payload` is bytes for BINARY_TYPES, else any
    JSON-able value."""
    if ftype in BINARY_TYPES:
        wf.write(raw_frame(ftype, payload))
    else:
        wf.write(frame(ftype, payload))


def read_frame(rf: BinaryIO) -> Optional[tuple[int, Any]]:
    """Reads one frame -> (type, payload), or None on clean EOF.  A
    partial header/payload or CRC mismatch raises ProtocolError: on a
    stream (unlike a crash-torn file tail) a bad frame means the
    conversation is unrecoverable."""
    header = _read_exactly(rf, _HEADER.size, eof_ok=True)
    if header is None:
        return None
    length, crc, ftype = _HEADER.unpack(header)
    if length > MAX_FRAME:
        raise ProtocolError(f"frame length {length} exceeds {MAX_FRAME}")
    data = _read_exactly(rf, length, eof_ok=False)
    if zlib.crc32(data) != crc:
        raise ProtocolError(f"frame type {ftype}: CRC mismatch")
    if ftype in BINARY_TYPES:
        return ftype, data
    try:
        return ftype, json.loads(data)
    except ValueError as e:
        raise ProtocolError(f"frame type {ftype}: bad JSON: {e}") from e


def _read_exactly(rf: BinaryIO, n: int, *, eof_ok: bool) -> Optional[bytes]:
    chunks: list[bytes] = []
    got = 0
    while got < n:
        b = rf.read(n - got)
        if not b:
            if eof_ok and got == 0:
                return None
            raise ProtocolError(f"truncated frame: {got}/{n} bytes")
        chunks.append(b)
        got += len(b)
    return b"".join(chunks) if len(chunks) != 1 else chunks[0]


def pack_key_frame(key_index: int, packed_bytes: bytes) -> bytes:
    """Payload for an F_PACKED frame: the key's submit-order index
    prefixed to the packed-column tensor bytes."""
    return _KEY_PREFIX.pack(key_index) + packed_bytes


def unpack_key_frame(data: bytes) -> tuple[int, bytes]:
    if len(data) < _KEY_PREFIX.size:
        raise ProtocolError("packed frame shorter than its key prefix")
    (i,) = _KEY_PREFIX.unpack_from(data)
    return i, data[_KEY_PREFIX.size:]


def parse_addr(addr: str) -> tuple[str, int]:
    """"host:port" -> (host, port); bare "port" means localhost."""
    if ":" in addr:
        host, _, port = addr.rpartition(":")
        return host or "127.0.0.1", int(port)
    return "127.0.0.1", int(addr)


# ---------------------------------------------------------------------------
# Model specs: the models a verdict can be computed for server-side.
# ---------------------------------------------------------------------------

def model_to_spec(model: Any) -> Optional[dict]:
    """A JSON description of a model instance, or None when the model
    (or its initial value) has no wire form — the client then checks
    in-process.  Only covers the stock models; a custom Model subclass
    carries arbitrary Python the daemon can't be asked to import."""
    from ..models.collections import FIFOQueue, SetModel, UnorderedQueue
    from ..models.mutex import Mutex
    from ..models.registers import CASRegister, MultiRegister, Register

    spec: Optional[dict] = None
    # CASRegister subclasses Register: exact type checks, most specific
    # first, so a further subclass (unknown step semantics) is refused.
    t = type(model)
    if t is CASRegister:
        spec = {"type": "cas-register", "value": model.value}
    elif t is Register:
        spec = {"type": "register", "value": model.value}
    elif t is MultiRegister:
        spec = {
            "type": "multi-register",
            "values": sorted(model.values.items(), key=repr),
        }
    elif t is Mutex:
        spec = {"type": "mutex", "locked": bool(model.locked)}
    elif t is FIFOQueue:
        spec = {"type": "fifo-queue", "items": list(model.items)}
    elif t is UnorderedQueue:
        spec = {"type": "unordered-queue", "pending": list(model.pending)}
    elif t is SetModel:
        spec = {"type": "set", "items": sorted(model.items, key=repr)}
    if spec is None:
        return None
    try:
        # Strict round-trip probe: _encode's repr() safety net would
        # silently change values like object() — refuse instead.
        json.dumps(spec)
    except (TypeError, ValueError):
        return None
    return spec


def model_from_spec(spec: dict) -> Any:
    """Rebuilds a model instance from its wire spec.  Raises ValueError
    for unknown types, which the server surfaces as an ERROR frame (the
    client falls back in-process)."""
    from ..models.collections import FIFOQueue, SetModel, UnorderedQueue
    from ..models.mutex import Mutex
    from ..models.registers import CASRegister, MultiRegister, Register

    t = spec.get("type")
    if t == "cas-register":
        return CASRegister(spec.get("value"))
    if t == "register":
        return Register(spec.get("value"))
    if t == "multi-register":
        return MultiRegister({k: v for k, v in spec.get("values") or []})
    if t == "mutex":
        return Mutex(bool(spec.get("locked")))
    if t == "fifo-queue":
        return FIFOQueue(tuple(spec.get("items") or ()))
    if t == "unordered-queue":
        return UnorderedQueue(tuple(spec.get("pending") or ()))
    if t == "set":
        return SetModel(frozenset(spec.get("items") or ()))
    raise ValueError(f"unknown model spec type {t!r}")


def canonical_spec(spec: dict) -> str:
    """Deterministic string form of a model spec — the model-cache and
    cohort-compatibility key."""
    return json.dumps(spec, sort_keys=True, separators=(",", ":"))


def connect(addr: str, timeout: float = 3.0) -> socket.socket:
    host, port = parse_addr(addr)
    s = socket.create_connection((host, port), timeout=timeout)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s
