"""Append-only, checksummed, block-structured files.

The port's copy of the framing of `jepsen_tpu/store/format.py`, trimmed
to what the plan memo journal (plan/cache.py), the checker daemon's
queue journal and wire frames (checkerd/) and the time-series store
(telemetry/timeseries.py) use, byte for byte the same, so a file
written by either package replays in the other:

    magic "JTPU1\\n"
    block*        where block = [u32 payload-len][u32 crc32][u8 type]
                               [payload bytes]

Payloads are compact JSON.  A torn final block fails its length or CRC
check and is ignored by readers; `BlockWriter` truncates it before
appending, so new blocks stay reachable by the sequential scan.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Optional

MAGIC = b"JTPU1\n"

#: Plan-memo journal entry: one settled plan-node verdict per block.
BLOCK_PLAN = 6
#: Checker-daemon queue-journal record (checkerd/journal.py): one
#: accepted submission, result or abandonment per block.
BLOCK_QUEUE = 7
#: Time-series sample batch (telemetry/timeseries.py): one cadence tick
#: of samples per block.
BLOCK_SERIES = 8

_HEADER = struct.Struct("<IIB")  # payload-len, crc32, type


def _jsonable(x: Any) -> Any:
    """Best-effort JSON coercion: sets and tuples become lists, unknown
    objects their repr."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted((_jsonable(v) for v in x), key=repr)
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    return repr(x)


def _encode(payload: Any) -> bytes:
    """Compact JSON, with `_jsonable` for what the encoder rejects; a
    payload the fast path cannot route (tuple dict keys) goes through
    the full coercion."""
    try:
        return json.dumps(payload, separators=(",", ":"),
                          default=_jsonable).encode()
    except (TypeError, ValueError):
        return json.dumps(_jsonable(payload), separators=(",", ":")).encode()


def frame(block_type: int, payload: Any) -> bytes:
    """One self-contained `[u32 len][u32 crc32][u8 type][payload]`
    block as bytes."""
    data = _encode(payload)
    return _HEADER.pack(len(data), zlib.crc32(data), block_type) + data


def raw_frame(block_type: int, data: bytes) -> bytes:
    """`frame` for a payload that is already bytes."""
    return _HEADER.pack(len(data), zlib.crc32(data), block_type) + data


class BlockWriter:
    """Appends typed, CRC32-checked blocks to a file.  Reopening a file
    with a torn tail truncates it back to the end of the last valid
    block."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path) if os.path.exists(path) else 0
        end = _valid_end(path, size) if size >= len(MAGIC) else 0
        if end > 0:
            if end < size:
                with open(path, "r+b") as tf:
                    tf.truncate(end)
            self.f: BinaryIO = open(path, "ab")
        else:
            self.f = open(path, "wb")
            self.f.write(MAGIC)
            self.f.flush()

    def append(self, block_type: int, payload: Any) -> int:
        """Writes one block; returns its file offset."""
        block = frame(block_type, payload)
        off = self.f.tell()
        self.f.write(block)
        self.f.flush()
        return off

    def sync(self) -> None:
        os.fsync(self.f.fileno())

    def close(self) -> None:
        self.f.close()


def _read_block(f: BinaryIO, size: int) -> Optional[tuple[int, int, Any]]:
    """(offset, type, payload) of the block at the current position, or
    None if torn or invalid."""
    off = f.tell()
    header = f.read(_HEADER.size)
    if len(header) < _HEADER.size:
        return None
    length, crc, btype = _HEADER.unpack(header)
    if off + _HEADER.size + length > size:
        return None
    data = f.read(length)
    if len(data) < length or zlib.crc32(data) != crc:
        return None
    try:
        return off, btype, json.loads(data)
    except ValueError:
        return None


def _valid_end(path: str, size: int) -> int:
    """Offset just past the last valid block (past the magic if none;
    0 for a file without the magic, which the writer then overwrites)."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            return 0
        end = len(MAGIC)
        while True:
            if _read_block(f, size) is None:
                return end
            end = f.tell()
