"""Append-only, checksummed, block-structured files.

The port's copy of `jepsen_tpu/store/format.py`: the test file a run
writes (its test map, history chunks, results and index blocks:
`HistoryWriter`, `Handle`, `TestFile`), and the framing the fault
ledger (nemesis/ledger.py), the plan memo journal (plan/cache.py), the
checker daemon's queue journal and wire frames (checkerd/) and the
time-series store (telemetry/timeseries.py) use, byte for byte the
same, so a file written by either package loads in the other:

    magic "JTPU1\n"
    block*        where block = [u32 payload-len][u32 crc32][u8 type]
                               [payload bytes]

Payloads are compact JSON (op values as JSON has them: a KV or any
tuple as a list).  A torn final block fails its length or CRC check
and is ignored by readers; `BlockWriter` truncates it before
appending, so new blocks stay reachable by the sequential scan.
Blocks are only referenced by an INDEX written after them, so a run
that crashed keeps its history up to its last sealed chunk.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Iterator, Optional

from ..history.core import History, Op

MAGIC = b"JTPU1\n"

#: A test file's blocks: the INDEX in force ({"test", "results":
#: offsets, "chunks": [offsets], "n_ops"}), the TEST map, a history
#: CHUNK (a list of op dicts) and the RESULTS map.
BLOCK_INDEX = 1
BLOCK_TEST = 2
BLOCK_CHUNK = 3
BLOCK_RESULTS = 4
#: Fault-ledger record (nemesis/ledger.py): one intent or healed entry.
BLOCK_LEDGER = 5
#: Plan-memo journal entry: one settled plan-node verdict per block.
BLOCK_PLAN = 6
#: Checker-daemon queue-journal record (checkerd/journal.py): one
#: accepted submission, result or abandonment per block.
BLOCK_QUEUE = 7
#: Time-series sample batch (telemetry/timeseries.py): one cadence tick
#: of samples per block.
BLOCK_SERIES = 8

#: Ops per sealed history chunk.
CHUNK_SIZE = 16384

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


class TestFile:
    """Read side: scans for the last valid INDEX, exposes test map,
    results, and the history as lazily-loaded chunks."""

    __test__ = False  # not a pytest class, despite the name

    def __init__(self, path: str):
        self.path = path
        self.size = os.path.getsize(path)
        self.f: BinaryIO = open(path, "rb")
        if self.f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a JTPU1 file")
        self.index: Optional[dict] = None
        self._scan()

    def _scan(self) -> None:
        """Walks every block, remembering the last valid INDEX
        (crash-recovery read path)."""
        while True:
            rec = _read_block(self.f, self.size)
            if rec is None:
                break
            _, btype, payload = rec
            if btype == BLOCK_INDEX:
                self.index = payload

    def _load(self, off: int, want_type: int) -> Any:
        self.f.seek(off)
        rec = _read_block(self.f, self.size)
        if rec is None or rec[1] != want_type:
            raise ValueError(
                f"{self.path}: bad block at {off} (want type {want_type})"
            )
        return rec[2]

    @property
    def test(self) -> Optional[dict]:
        if self.index is None or self.index.get("test") is None:
            return None
        return self._load(self.index["test"], BLOCK_TEST)

    @property
    def results(self) -> Optional[dict]:
        if self.index is None or self.index.get("results") is None:
            return None
        return self._load(self.index["results"], BLOCK_RESULTS)

    def iter_ops(self) -> Iterator[Op]:
        if self.index is None:
            return
        for off in self.index.get("chunks", []):
            for d in self._load(off, BLOCK_CHUNK):
                yield Op.from_dict(d)

    def history(self) -> History:
        return History(list(self.iter_ops()), reindex=False)

    def close(self) -> None:
        self.f.close()

    def __enter__(self) -> "TestFile":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class HistoryWriter:
    """Streams ops into sealed CHUNK blocks, checkpointing an INDEX after
    every seal so crashes keep everything up to the last seal
    (format.clj:189-199).  Use as the interpreter's `writer` hook."""

    def __init__(
        self,
        writer: BlockWriter,
        *,
        chunk_size: int = CHUNK_SIZE,
        test_offset: Optional[int] = None,
    ):
        self.writer = writer
        self.chunk_size = chunk_size
        self.buffer: list[dict] = []
        self.chunk_offsets: list[int] = []
        self.n_ops = 0
        self.test_offset = test_offset
        self.results_offset: Optional[int] = None

    def append(self, op: Op) -> None:
        self.buffer.append(op.to_dict())
        self.n_ops += 1
        if len(self.buffer) >= self.chunk_size:
            self.seal()
            self.checkpoint()

    def seal(self) -> None:
        if self.buffer:
            off = self.writer.append(BLOCK_CHUNK, self.buffer)
            self.chunk_offsets.append(off)
            self.buffer = []

    def checkpoint(self) -> None:
        self.writer.append(
            BLOCK_INDEX,
            {
                "test": self.test_offset,
                "results": self.results_offset,
                "chunks": self.chunk_offsets,
                "n_ops": self.n_ops,
            },
        )
        self.writer.sync()

    def close(self) -> None:
        self.seal()
        self.checkpoint()


class Handle:
    """One open test file for the whole run lifecycle: the three save
    phases of store.clj:426-466 over one BlockWriter."""

    def __init__(self, path: str):
        self.path = path
        existing_index: Optional[dict] = None
        if os.path.exists(path) and os.path.getsize(path) > len(MAGIC):
            try:
                with TestFile(path) as tf:
                    existing_index = tf.index
            except ValueError:
                existing_index = None
        self.writer = BlockWriter(path)
        self.history_writer: Optional[HistoryWriter] = None
        self._test_offset: Optional[int] = None
        if existing_index:
            # Reopening (e.g. to append fresh analysis results): carry
            # the prior index forward so history chunks stay reachable.
            self._test_offset = existing_index.get("test")
            hw = HistoryWriter(self.writer, test_offset=self._test_offset)
            hw.chunk_offsets = list(existing_index.get("chunks", []))
            hw.n_ops = existing_index.get("n_ops", 0)
            hw.results_offset = existing_index.get("results")
            self.history_writer = hw

    def save_test(self, test_map: dict) -> None:
        """save-0!: the initial test map, before the run."""
        self._test_offset = self.writer.append(BLOCK_TEST, test_map)
        if self.history_writer is not None:
            self.history_writer.test_offset = self._test_offset
        self.writer.sync()

    def open_history_writer(self, chunk_size: int = CHUNK_SIZE) -> HistoryWriter:
        self.history_writer = HistoryWriter(
            self.writer, chunk_size=chunk_size, test_offset=self._test_offset
        )
        return self.history_writer

    def _ensure_history_writer(self) -> HistoryWriter:
        if self.history_writer is None:
            self.history_writer = HistoryWriter(
                self.writer, test_offset=self._test_offset
            )
        return self.history_writer

    def save_run(self, test_map: dict) -> None:
        """save-1!: test + completed history."""
        hw = self._ensure_history_writer()
        hw.seal()
        self._test_offset = self.writer.append(BLOCK_TEST, test_map)
        hw.test_offset = self._test_offset
        hw.checkpoint()

    def save_results(self, results: dict) -> None:
        """save-2!: analysis results."""
        hw = self._ensure_history_writer()
        hw.seal()
        hw.results_offset = self.writer.append(BLOCK_RESULTS, results)
        hw.checkpoint()

    def close(self) -> None:
        self.writer.close()

    def __enter__(self) -> "Handle":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
