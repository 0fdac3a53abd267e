"""Packed columnar op tables — the device-facing history form.

The port's copy of `jepsen_tpu/history/packed.py`, trimmed to
`pack_history`, the incremental `PackedBuilder`, what they return, and
the columnar wire form (`packed_to_bytes` / `packed_from_bytes`, byte
for byte the reference's, so either package's client talks to either
package's checker daemon).
A history becomes invocation-ordered numpy columns: int32 op payloads
(process/status/f/a0/a1) and int64 event bookkeeping (inv/ret/
src_index/preds/horizon; ret uses NO_RET = int64 max, which the device
paths clamp to int32 INF).
Precedence is reduced to two counters per op:

  preds[a]   = #{y != a : ret(y) < inv(a)}   ops that must precede a
  horizon[a] = #{y != a : inv(y) < ret(a)}   last level at which a may
                                             remain un-linearized

Info (indeterminate) ops never complete: ret = NO_RET and horizon =
n-1, so they stay optional forever.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from .. import telemetry
from .core import FAIL, INVOKE, OK, History, Op

#: Sentinel for "never returns" event index.
NO_RET = np.iinfo(np.int64).max

#: Sentinel int32 for missing / nil argument values.
NIL = np.iinfo(np.int32).min

#: Status codes for packed ops.
ST_OK = 1
ST_INFO = 3


class Interner:
    """Dense int interning of arbitrary hashable values (op payloads)."""

    __slots__ = ("values", "_ids")

    def __init__(self) -> None:
        self.values: list[Any] = []
        self._ids: dict[Any, int] = {}

    def intern(self, v: Any) -> int:
        i = self._ids.get(v)
        if i is None:
            i = len(self.values)
            self._ids[v] = i
            self.values.append(v)
        return i

    def value(self, i: int) -> Any:
        return self.values[i]

    def __len__(self) -> int:
        return len(self.values)


#: An encoder maps (invocation, completion|None) to a packed
#: (f_code, a0, a1) int32 triple, or None to drop the op (e.g.
#: indeterminate reads, which can never affect model state).
OpEncoderFn = Callable[[Op, Optional[Op]], Optional[tuple[int, int, int]]]


@dataclass
class PackedOps:
    """Columnar live-operation table, invocation-ordered."""

    #: (n,) invocation event index within the client event sequence
    inv: np.ndarray
    #: (n,) completion event index, NO_RET when never completed
    ret: np.ndarray
    #: (n,) worker process ids
    process: np.ndarray
    #: (n,) ST_OK / ST_INFO
    status: np.ndarray
    #: (n,) packed op function codes
    f: np.ndarray
    #: (n,) first argument (NIL if absent)
    a0: np.ndarray
    #: (n,) second argument (NIL if absent)
    a1: np.ndarray
    #: (n,) original History index of the invocation (for reporting)
    src_index: np.ndarray
    #: (n,) number of ops that must be linearized before this one
    preds: np.ndarray
    #: (n,) last BFS level at which this op may remain un-linearized
    horizon: np.ndarray

    @property
    def n(self) -> int:
        return int(self.inv.shape[0])

    @property
    def n_ok(self) -> int:
        return int((self.status == ST_OK).sum())


#: Column names and dtypes, in the reference's serialization order.
PACKED_COLUMNS: tuple[tuple[str, Any], ...] = (
    ("inv", np.int64),
    ("ret", np.int64),
    ("process", np.int32),
    ("status", np.int32),
    ("f", np.int32),
    ("a0", np.int32),
    ("a1", np.int32),
    ("src_index", np.int64),
    ("preds", np.int64),
    ("horizon", np.int64),
)


PACKED_MAGIC = b"JPKD1\n"


def packed_to_bytes(p: "PackedOps") -> bytes:
    """Serializes a PackedOps to the columnar binary form: the magic, the
    int64 row count, then each column of PACKED_COLUMNS little-endian."""
    parts = [PACKED_MAGIC, np.int64(p.n).tobytes()]
    for name, dtype in PACKED_COLUMNS:
        col = np.ascontiguousarray(getattr(p, name), dtype=dtype)
        if col.shape != (p.n,):
            raise ValueError(f"column {name}: shape {col.shape} != ({p.n},)")
        parts.append(col.tobytes())
    return b"".join(parts)


def packed_from_bytes(buf: bytes) -> "PackedOps":
    """Inverse of packed_to_bytes.  Validates the magic and the total
    length, so a torn or foreign frame raises ValueError instead of
    mis-slicing columns."""
    if buf[: len(PACKED_MAGIC)] != PACKED_MAGIC:
        raise ValueError("not a packed-ops frame (bad magic)")
    off = len(PACKED_MAGIC)
    n = int(np.frombuffer(buf, dtype=np.int64, count=1, offset=off)[0])
    if n < 0:
        raise ValueError(f"packed-ops frame: negative row count {n}")
    off += 8
    want = off + sum(n * np.dtype(dt).itemsize for _, dt in PACKED_COLUMNS)
    if len(buf) != want:
        raise ValueError(
            f"packed-ops frame: {len(buf)} bytes, want {want} for n={n}")
    cols = {}
    for name, dtype in PACKED_COLUMNS:
        # Owned, writable copies: a frombuffer view is read-only and
        # pins the source buffer.
        cols[name] = np.frombuffer(buf, dtype=dtype, count=n,
                                   offset=off).copy()
        off += n * np.dtype(dtype).itemsize
    return PackedOps(**cols)


def _require_i32(arr: np.ndarray) -> None:
    """The process/status/f/a0/a1 columns narrow to int32 on device; a
    value past int32 would wrap silently in the cast and corrupt every
    verdict downstream, so raise first."""
    if not arr.size:
        return
    cols = arr[:, 2:7]
    lo = int(cols.min())
    hi = int(cols.max())
    if lo < -(2 ** 31) or hi >= 2 ** 31:
        raise OverflowError(
            f"packed op column value out of int32 range [{lo}, {hi}]: "
            f"re-encode op arguments (a0/a1) into a dense int32 domain "
            f"before packing"
        )


def _rows_to_packed(rows: list, *, with_preds: bool) -> PackedOps:
    """Inv-sorted row tuples (inv, ret, process, status, f, a0, a1,
    src_index) -> PackedOps.  preds/horizon are computed in O(n log n)
    from the sorted rets (inv is ascending already; subtracting 1
    removes the op itself: inv(a) < ret(a) for completed ops, and every
    op counts for a NO_RET op, itself included); with_preds=False
    leaves them zero for witness-only snapshots."""
    if rows:
        arr = np.array(rows, dtype=np.int64)
    else:
        arr = np.zeros((0, 8), dtype=np.int64)
    _require_i32(arr)

    inv = arr[:, 0]
    ret = arr[:, 1]
    n = arr.shape[0]
    if with_preds:
        ret_sorted = np.sort(ret)
        preds = np.searchsorted(ret_sorted, inv, side="left").astype(np.int64)
        inv_before_ret = np.searchsorted(inv, ret, side="left").astype(np.int64)
        horizon = np.minimum(inv_before_ret - 1, n - 1)
    else:
        preds = np.zeros(n, dtype=np.int64)
        horizon = np.zeros(n, dtype=np.int64)

    return PackedOps(
        inv=inv.astype(np.int64),
        ret=ret,
        process=arr[:, 2].astype(np.int32),
        status=arr[:, 3].astype(np.int32),
        f=arr[:, 4].astype(np.int32),
        a0=arr[:, 5].astype(np.int32),
        a1=arr[:, 6].astype(np.int32),
        src_index=arr[:, 7].astype(np.int64),
        preds=preds,
        horizon=horizon,
    )


class PackedBuilder:
    """Incremental `pack_history`: ops append in journal order and each
    chunk encodes without re-packing the prefix — the online checker's
    ingest (streaming/).

    For any history h, appending its ops one by one and calling
    `finish()` gives `pack_history(h, encode)` byte for byte:
    pack_history is this builder fed op by op.  `append_many` pairs the
    same rows but hands the encoder its ops in another order, so an
    encoder that interns values may number them otherwise; its pack is
    byte-identical once the encoder has seen h's values, and equal to
    the reference builder's on the same chunks.

    Mid-run, `snapshot()` returns the STABLE ROW PREFIX: rows whose
    invocation event index is < s, where s = min invocation index over
    in-flight ops.  Every future row belongs to an in-flight op (inv >=
    s) or to an op not yet invoked (inv >= the event counter >= s), so
    it sorts after the prefix: prefix row indices, contents and order
    are final, which lets the frontier (streaming/frontier.py) carry
    its search across snapshots."""

    __slots__ = ("encode", "_e", "_pending", "_rows", "_stable",
                 "_finished")

    #: Below this many client ops `append_many` runs the scalar loop.
    #: The two pairings hand the encoder its ops in different orders,
    #: so the choice sets the order in which values intern: it stays
    #: the reference builder's, so that both give the same codes for
    #: the same chunks.  (Speed alone would put it near 256: on the host
    #: of an H100 machine, `tools/port_ab.py` read append() at 0.99-1.21
    #: µs per cas-register op, the numpy path at 2.44-2.48 µs in 16-op
    #: chunks, 1.36-1.40 at 64, 0.94-0.98 at 256.)
    _MANY_MIN = 16

    def __init__(self, encode: OpEncoderFn):
        self.encode = encode
        #: next dense event index over client ops
        self._e = 0
        #: process -> (inv_e, invoke Op) of the op in flight
        self._pending: dict[Any, tuple[int, Op]] = {}
        #: emitted rows not yet moved to the stable prefix, in emit order
        self._rows: list[tuple[int, ...]] = []
        #: inv-sorted rows proven stable by a past snapshot()
        self._stable: list[tuple[int, ...]] = []
        self._finished = False

    @property
    def n_rows(self) -> int:
        """Rows emitted so far (more may follow until finish())."""
        return len(self._rows) + len(self._stable)

    @property
    def in_flight(self) -> int:
        """Ops invoked but not yet completed."""
        return len(self._pending)

    def stable_bound(self) -> int:
        """s: the event index below which rows are final — the least
        in-flight invocation index, or the event counter when nothing
        is in flight."""
        if not self._pending:
            return self._e
        return min(inv_e for inv_e, _ in self._pending.values())

    # -- ingest -------------------------------------------------------------

    def _emit(self, inv_e: int, invoke_op: Op, ret_e: int,
              comp: Optional[Op]) -> None:
        if comp is not None and comp.type == FAIL:
            return  # certainly never happened
        status = ST_OK if (comp is not None and comp.type == OK) else ST_INFO
        enc = self.encode(invoke_op, comp)
        if enc is None:
            return
        fc, a0, a1 = enc
        self._rows.append((
            inv_e,
            ret_e if status == ST_OK else NO_RET,
            invoke_op.process,
            status,
            fc,
            a0,
            a1,
            invoke_op.index,
        ))

    def append(self, o: Op) -> None:
        """Feeds one op in journal order.  Non-client ops are ignored
        without consuming an event index (pack_history's client
        filter)."""
        if self._finished:
            raise RuntimeError("PackedBuilder already finished")
        if o.is_client_op:
            self._append_client(o)

    def _append_client(self, o: Op) -> None:
        e = self._e
        self._e = e + 1
        if o.type == INVOKE:
            prev = self._pending.get(o.process)
            if prev is not None:
                self._emit(prev[0], prev[1], -1, None)
            self._pending[o.process] = (e, o)
        else:
            inv = self._pending.pop(o.process, None)
            if inv is not None:
                self._emit(inv[0], inv[1], e, o)

    def append_many(self, ops) -> None:
        """Feeds a chunk of ops in journal order — the same rows as
        append() per op, with the invoke/completion pairing done in
        numpy.

        After any client op on process p, p's pending state is "that op
        was an invoke".  So within one process's events a completion
        pairs with its predecessor iff that is an invoke, an invoke is
        a double-invoke indeterminate iff its successor is an invoke,
        and only each process's first op meets pending state carried in
        from earlier chunks (handled one by one).  A stable sort by
        process turns those relations into shifted masks.  Rows come
        out in another order than append()'s, but each has its own inv
        and every consumer sorts or reduces over inv."""
        if self._finished:
            raise RuntimeError("PackedBuilder already finished")
        client = [o for o in ops if isinstance(o.process, int)]
        n = len(client)
        if n < self._MANY_MIN:
            for o in client:
                self._append_client(o)
            return
        e0 = self._e
        self._e = e0 + n
        is_inv = np.array([o.type == INVOKE for o in client], dtype=bool)
        procs = np.array([o.process for o in client], dtype=np.int64)
        order = np.argsort(procs, kind="stable")
        p_sorted = procs[order]
        inv_sorted = is_inv[order]
        same_prev = np.zeros(n, dtype=bool)
        np.equal(p_sorted[1:], p_sorted[:-1], out=same_prev[1:])
        prev_inv = np.zeros(n, dtype=bool)
        prev_inv[1:] = inv_sorted[:-1]
        same_next = np.zeros(n, dtype=bool)
        same_next[:-1] = same_prev[1:]
        next_inv = np.zeros(n, dtype=bool)
        next_inv[:-1] = inv_sorted[1:]
        oi = order.tolist()
        emit_row = self._rows.append
        # Each process's first op against a pending invoke carried in.
        for j in np.nonzero(~same_prev)[0].tolist():
            i = oi[j]
            o = client[i]
            prev = self._pending.pop(o.process, None)
            if prev is None:
                continue
            if is_inv[i]:
                self._emit(prev[0], prev[1], -1, None)  # double invoke
            else:
                self._emit(prev[0], prev[1], e0 + i, o)
        # Within-chunk pairs: a completion whose predecessor in its
        # process is an invoke.  The encoder's batched form (`many`)
        # takes every pair in one call where the model has one.
        pairs = []
        for j in np.nonzero((~inv_sorted) & same_prev & prev_inv)[0].tolist():
            ic = oi[j]
            if client[ic].type != FAIL:  # a failure never happened
                pairs.append((oi[j - 1], ic))
        enc_many = getattr(self.encode, "many", None)
        if enc_many is not None:
            encoded = enc_many([(client[ii], client[ic]) for ii, ic in pairs])
        else:
            encoded = [self.encode(client[ii], client[ic]) for ii, ic in pairs]
        for (ii, ic), enc in zip(pairs, encoded):
            if enc is None:
                continue
            fc, a0, a1 = enc
            inv_op = client[ii]
            if client[ic].type == OK:
                emit_row((e0 + ii, e0 + ic, inv_op.process, ST_OK,
                          fc, a0, a1, inv_op.index))
            else:
                emit_row((e0 + ii, NO_RET, inv_op.process, ST_INFO,
                          fc, a0, a1, inv_op.index))
        # Within-chunk double invokes: superseded by the next invoke.
        for j in np.nonzero(inv_sorted & same_next & next_inv)[0].tolist():
            i = oi[j]
            inv_op = client[i]
            enc = self.encode(inv_op, None)
            if enc is not None:
                fc, a0, a1 = enc
                emit_row((e0 + i, NO_RET, inv_op.process, ST_INFO,
                          fc, a0, a1, inv_op.index))
        # Trailing invokes become the pending state.
        for j in np.nonzero(inv_sorted & ~same_next)[0].tolist():
            i = oi[j]
            self._pending[client[i].process] = (e0 + i, client[i])

    # -- snapshots, discards, finish ----------------------------------------

    def _advance_stable(self, s: int) -> None:
        """Moves rows with inv < s into the inv-sorted stable prefix.
        Every stable row has inv < the previous s <= every newly stable
        row's inv, so sorting the batch and appending keeps the prefix
        sorted."""
        fresh = [r for r in self._rows if r[0] < s]
        if not fresh:
            return
        self._rows = [r for r in self._rows if r[0] >= s]
        fresh.sort(key=lambda r: r[0])
        self._stable.extend(fresh)

    def discard_stable_prefix(self, *, bars_per_block: int,
                              blocks_done: int) -> tuple[int, int, int]:
        """Rolling-window discard: drops the longest prefix of the
        stable rows that the frontier can never need again, renumbers
        the surviving event indices down from 0, and returns
        (rows_dropped, bars_dropped, event_shift) for the caller's
        `FrontierCarry.rebase`.  A prefix of length d is dropped when:

          1. every dropped row is ST_OK (an ST_INFO row stays an
             entrant of every later block, so it pins the discard
             point);
          2. max(ret over the prefix) < min(ret over every retained OK
             row), so the prefix's barriers are exactly the global
             ranks [0, d) and retained ranks shift uniformly by d;
          3. d is a multiple of `bars_per_block` (block boundaries stay
             aligned);
          4. d <= (blocks_done - 1) * bars_per_block: the newest
             processed block stays resident, since the carried window
             names its rows.

        Then every comparison the frontier makes (rank against k0, inv
        against a barrier's ret, the window re-gather by row index) is
        unchanged by the shift.  Renumbering keeps a long run's event
        indices inside int32."""
        if self._finished:
            raise RuntimeError("PackedBuilder already finished")
        K = bars_per_block
        max_bars = max(0, blocks_done - 1) * K
        if K <= 0 or max_bars <= 0 or not self._stable:
            return 0, 0, 0
        n_ok_prefix = 0
        for r in self._stable:
            if r[3] != ST_OK:
                break
            n_ok_prefix += 1
        if n_ok_prefix == 0:
            return 0, 0, 0
        # Condition 2 against every retained OK row: the stable tail and
        # the unsorted rows (a row with inv >= s may have completed
        # before a stable row did).  Pending ops complete later still.
        min_ret_rest = min(
            min((r[1] for r in self._stable[n_ok_prefix:] if r[3] == ST_OK),
                default=NO_RET),
            min((r[1] for r in self._rows if r[3] == ST_OK),
                default=NO_RET),
        )
        rets = sorted(r[1] for r in self._stable[:n_ok_prefix])
        d = n_ok_prefix
        while d > 0 and rets[d - 1] >= min_ret_rest:
            d -= 1
        d = min(d, max_bars)
        d -= d % K
        if d <= 0:
            return 0, 0, 0
        # The first d rows by ret must also be the first d rows: else
        # discard nothing rather than permute ranks.
        cut = rets[d - 1]
        if any(r[1] > cut for r in self._stable[:d]) or any(
                r[1] <= cut for r in self._stable[d:n_ok_prefix]):
            return 0, 0, 0
        rest = self._stable[d:]
        candidates = [r[0] for r in rest] + [r[0] for r in self._rows]
        candidates += [inv_e for inv_e, _ in self._pending.values()]
        e_shift = min(candidates) if candidates else self._e

        def shifted(r):
            return (r[0] - e_shift,
                    r[1] - e_shift if r[1] != NO_RET else NO_RET) + r[2:]

        self._stable = [shifted(r) for r in rest]
        self._rows = [shifted(r) for r in self._rows]
        self._pending = {p: (inv_e - e_shift, op)
                         for p, (inv_e, op) in self._pending.items()}
        self._e -= e_shift
        return d, d, e_shift

    def snapshot(self) -> tuple[PackedOps, int]:
        """(stable-prefix pack, s): exactly the rows with inv < s.  The
        pack is witness-only: preds/horizon stay zero (the witness never
        reads them; finish() gives the full pack)."""
        with telemetry.span("ingest.snapshot", rows=self.n_rows):
            telemetry.count("ingest.snapshots")
            s = self.stable_bound()
            self._advance_stable(s)
            return _rows_to_packed(self._stable, with_preds=False), s

    def finish(self) -> PackedOps:
        """Closes the pack: unfinished invocations become
        indeterminate, rows sort by invocation, preds/horizon are
        computed — byte-identical to pack_history on the same ops."""
        if self._finished:
            raise RuntimeError("PackedBuilder already finished")
        self._finished = True
        with telemetry.span("ingest.finish", rows=self.n_rows):
            # In pending dict order: the order the encoder sees them.
            for inv_e, inv_op in self._pending.values():
                self._emit(inv_e, inv_op, -1, None)
            self._pending.clear()
            rows = self._stable + self._rows
            rows.sort(key=lambda r: r[0])
            return _rows_to_packed(rows, with_preds=True)


def pack_history(h: History, encode: OpEncoderFn) -> PackedOps:
    """Packs the client portion of a history into columnar arrays:
      1. keep client ops only;
      2. pair invocations with completions;
      3. drop certain failures (:fail) — they never happened;
      4. ops whose completion is missing or :info become indeterminate
         (ret = NO_RET);
      5. encode (f, value) via the model's encoder; encoders may drop
         no-effect indeterminate ops (e.g. :info reads).
    This is `PackedBuilder` fed one op at a time: the encoder sees the
    ops in journal order, so values intern in the order the reference's
    pack_history interns them (`append_many` encodes in another order).
    """
    b = PackedBuilder(encode)
    for o in h:
        if o.is_client_op:
            b._append_client(o)
    return b.finish()
