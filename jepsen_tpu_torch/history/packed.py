"""Packed columnar op tables — the device-facing history form.

The port's copy of `jepsen_tpu/history/packed.py`, trimmed to
`pack_history` and what it returns.  A history becomes invocation-
ordered numpy columns: int32 op payloads (process/status/f/a0/a1) and
int64 event bookkeeping (inv/ret/src_index/preds/horizon; ret uses
NO_RET = int64 max, which the device paths clamp to int32 INF).
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


def pack_history(h: History, encode: OpEncoderFn) -> PackedOps:
    """Packs the client portion of a history into columnar arrays:
      1. keep client ops only;
      2. pair invocations with completions;
      3. drop certain failures (:fail) — they never happened;
      4. ops whose completion is missing or :info become indeterminate
         (ret = NO_RET);
      5. encode (f, value) via the model's encoder; encoders may drop
         no-effect indeterminate ops (e.g. :info reads).
    """
    client = [o for o in h if o.is_client_op]
    rows: list[tuple[int, int, int, int, int, int, int, int]] = []
    # Pairing runs on the client-only event sequence, so inv/ret are
    # dense event positions in that sequence.
    pending: dict[Any, tuple[int, Op]] = {}

    def emit(inv_e: int, invoke_op: Op, ret_e: int, comp: Op | None) -> None:
        if comp is not None and comp.type == FAIL:
            return  # certainly never happened
        status = ST_OK if (comp is not None and comp.type == OK) else ST_INFO
        enc = encode(invoke_op, comp)
        if enc is None:
            return
        fc, a0, a1 = enc
        rows.append((
            inv_e,
            ret_e if status == ST_OK else NO_RET,
            invoke_op.process,
            status,
            fc,
            a0,
            a1,
            invoke_op.index,
        ))

    for e, o in enumerate(client):
        if o.type == INVOKE:
            prev = pending.get(o.process)
            if prev is not None:
                # Double invoke without completion (torn history): the
                # earlier op is indeterminate.
                emit(prev[0], prev[1], -1, None)
            pending[o.process] = (e, o)
        else:
            inv = pending.pop(o.process, None)
            if inv is None:
                continue  # completion without invocation: tolerate
            emit(inv[0], inv[1], e, o)
    # Unfinished invocations are indeterminate.
    for inv_e, inv_op in pending.values():
        emit(inv_e, inv_op, -1, None)

    rows.sort(key=lambda r: r[0])
    if rows:
        arr = np.array(rows, dtype=np.int64)
    else:
        arr = np.zeros((0, 8), dtype=np.int64)
    _require_i32(arr)

    inv = arr[:, 0]
    ret = arr[:, 1]
    n = arr.shape[0]
    # O(n log n) via sorted rets; inv is ascending already.  Subtracting
    # 1 removes the op itself (inv(a) < ret(a) for completed ops; every
    # op counts for a NO_RET op, itself included).
    ret_sorted = np.sort(ret)
    preds = np.searchsorted(ret_sorted, inv, side="left").astype(np.int64)
    inv_before_ret = np.searchsorted(inv, ret, side="left").astype(np.int64)
    horizon = np.minimum(inv_before_ret - 1, n - 1)

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
