"""Synthetic concurrent histories for benchmarks and tests.

The port's copy of `jepsen_tpu/utils/histgen.py random_register_history`,
`stale_read_history` and `random_register_packed`, kept line for line: they draw from
Python's `random` and numpy's `default_rng`, so one seed gives one
history in both packages, which the parity tests rely on.
"""

from __future__ import annotations

import random
from typing import Optional

from ..history.core import History, Op, history


def random_register_history(
    n_ops: int,
    *,
    procs: int = 16,
    info_rate: float = 0.02,
    cas: bool = True,
    n_values: int = 5,
    seed: int = 45100,
    bad: bool = False,
    bad_at: Optional[float] = None,
) -> History:
    """A concurrent cas-register history of ~n_ops operations.

    Each op's effect is applied atomically at completion time, so the
    history is linearizable unless `bad` injects a read of a
    never-written value (at the end) or `bad_at` does so at that
    fraction of the way through.  `info_rate` of ops complete as :info
    (indeterminate) — these stay concurrent with everything after them,
    the width driver for the WGL search."""
    rng = random.Random(seed)
    value: Optional[int] = None
    ops: list[Op] = []
    # process -> (f, payload, as_info) for in-flight ops
    pending: dict[int, tuple] = {}
    started = 0

    def complete(p: int) -> None:
        nonlocal value
        f, payload, as_info = pending.pop(p)
        if as_info:
            # Indeterminate: maybe the effect happened.
            if f == "write" and rng.random() < 0.5:
                value = payload
            elif f == "cas" and rng.random() < 0.5 and value == payload[0]:
                value = payload[1]
            ops.append(Op(type="info", f=f, value=payload, process=p))
            return
        if f == "read":
            ops.append(Op(type="ok", f="read", value=value, process=p))
        elif f == "write":
            value = payload
            ops.append(Op(type="ok", f="write", value=payload, process=p))
        else:  # cas
            if value == payload[0]:
                value = payload[1]
                ops.append(Op(type="ok", f="cas", value=payload, process=p))
            else:
                ops.append(Op(type="fail", f="cas", value=payload, process=p))

    while started < n_ops or pending:
        p = rng.randrange(procs)
        if p in pending:
            complete(p)
        elif started < n_ops:
            fs = ["read", "write", "cas"] if cas else ["read", "write"]
            f = rng.choice(fs)
            if f == "read":
                payload = None
            elif f == "write":
                payload = rng.randrange(n_values)
            else:
                payload = (rng.randrange(n_values), rng.randrange(n_values))
            as_info = f != "read" and rng.random() < info_rate
            pending[p] = (f, payload, as_info)
            ops.append(Op(type="invoke", f=f, value=payload, process=p))
            started += 1
        # else: only pending ops remain; loop drains them.

    if bad:
        ops.append(Op(type="invoke", f="read", value=None, process=0))
        ops.append(Op(type="ok", f="read", value=n_values + 94, process=0))
    if bad_at is not None:
        # A mid-history impossible read on a process id outside the
        # worker range, so it can't collide with an in-flight op.
        at = max(0, min(len(ops), int(bad_at * len(ops))))
        ops[at:at] = [
            Op(type="invoke", f="read", value=None, process=procs),
            Op(type="ok", f="read", value=n_values + 73, process=procs),
        ]
    return history(ops)


def stale_read_history(
    n_ops: int,
    *,
    procs: int = 16,
    info_rate: float = 0.05,
    n_values: int = 5,
    seed: int = 45100,
    read_at: float = 0.6,
) -> History:
    """A concurrent register history that is not linearizable through
    the async-replication shape (repkv's violation): a value S is
    written and acknowledged early, an acknowledged fence write
    overwrites it, and much later a read still returns S.  Every
    producer of S completes before the fence begins and the fence
    completes before the read is invoked, so no linearization can serve
    S to the read: the stale-read screen of `checker/refute.py` proves
    it at any scale.

    The body between fence and read is a linearizable-by-construction
    workload over values 0..n_values-1 < S, so nothing produces S
    again; info ops are welcome."""
    S = n_values
    prologue = [
        Op(type="invoke", f="write", value=S, process=0),
        Op(type="ok", f="write", value=S, process=0),
        # the fence: an acknowledged overwrite, its window disjoint from
        # the producer above and the stale read below
        Op(type="invoke", f="write", value=0, process=0),
        Op(type="ok", f="write", value=0, process=0),
    ]
    body = list(
        random_register_history(
            n_ops - 3, procs=procs, info_rate=info_rate,
            n_values=n_values, seed=seed,
        )
    )
    at = max(0, min(len(body), int(read_at * len(body))))
    body[at:at] = [
        Op(type="invoke", f="read", value=None, process=procs),
        Op(type="ok", f="read", value=S, process=procs),
    ]
    return history(prologue + body)


def random_register_packed(
    n_ops: int,
    *,
    procs: int = 16,
    info_rate: float = 0.05,
    n_values: int = 5,
    seed: int = 45100,
    model=None,
):
    """A linearizable-by-construction register workload built directly
    in PackedOps form, in numpy — the scale generator (the Op-level
    generator and pack_history take minutes at millions of ops).

    * op k runs on process k % procs; per-process exponential-gap
      clocks, merged by one argsort, give invocation and completion
      events dense global ranks and ~`procs`-wide concurrency;
    * half the ops are writes, half reads (no cas);
    * `info_rate` of the writes complete :info (ret = NO_RET), each
      applied with probability 1/2 at its completion instant;
    * every read takes effect at its completion and returns the latest
      applied write completing before it (or the initial value).

    `model` (default cas_register().packed()) supplies the encoder; the
    codes are learned from sample encodings, so rows match
    pack_history's exactly."""
    import numpy as np

    from ..history.packed import NO_RET, ST_INFO, ST_OK, PackedOps

    if model is None:
        from ..models import cas_register

        model = cas_register().packed()
    encode = model.encode

    rng = np.random.default_rng(seed)
    n = int(n_ops)
    proc = (np.arange(n, dtype=np.int64) % procs).astype(np.int32)

    # Interleave: token 2k is op k's invocation, 2k+1 its completion;
    # each process's clock restarts at its segment of the cumsum.
    gaps = rng.exponential(1.0, size=2 * n)
    tok_proc = np.repeat(proc, 2)
    order_by_proc = np.argsort(tok_proc, kind="stable")
    times = np.empty(2 * n)
    g_sorted = gaps[order_by_proc]
    csum = np.cumsum(g_sorted)
    # Empty segments (procs > n_ops) give boundary positions 0 or 2n,
    # which are no bases: masked out.
    seg_starts = np.searchsorted(tok_proc[order_by_proc],
                                 np.arange(procs), side="left")
    base = np.zeros(2 * n)
    pos = seg_starts[1:]
    ok_pos = pos[(pos > 0) & (pos < 2 * n)]
    base[ok_pos] = csum[ok_pos - 1]
    times[order_by_proc] = csum - np.maximum.accumulate(base)
    rank = np.argsort(np.argsort(times, kind="stable"), kind="stable")
    inv_rank = rank[0::2].astype(np.int64)
    ret_rank = rank[1::2].astype(np.int64)

    # Op mix and outcomes.
    is_write = rng.random(n) < 0.5
    payload = rng.integers(0, n_values, size=n)
    is_info = is_write & (rng.random(n) < info_rate)
    applied = is_write & (~is_info | (rng.random(n) < 0.5))

    # Reads see the latest applied write completing before they do.
    w_rank = ret_rank[applied]
    w_order = np.argsort(w_rank)
    w_rank_sorted = w_rank[w_order]
    w_payload_sorted = payload[applied][w_order]
    read_rows = np.nonzero(~is_write)[0]
    if len(w_rank_sorted):
        idx = np.searchsorted(w_rank_sorted, ret_rank[read_rows],
                              side="left") - 1
        read_val = np.where(
            idx >= 0, w_payload_sorted[np.maximum(idx, 0)], -1,
        )  # -1 = the initial value (reads None)
    else:
        read_val = np.full(len(read_rows), -1, dtype=np.int64)

    def code(f, value, typ="ok"):
        inv = Op(type="invoke", f=f,
                 value=None if f == "read" else value, process=0)
        comp = Op(type=typ, f=f, value=value, process=0)
        enc = encode(inv, comp)
        if enc is None:
            raise ValueError(f"encoder dropped a sample {typ} {f} {value}")
        return enc

    wr_codes = np.asarray([code("write", v) for v in range(n_values)],
                          dtype=np.int64)          # (V, 3)
    wr_info_codes = np.asarray(
        [code("write", v, "info") for v in range(n_values)],
        dtype=np.int64,
    )
    rd_codes = np.asarray(
        [code("read", v) for v in range(n_values)], dtype=np.int64,
    )                                               # (V, 3)

    fc = np.empty(n, dtype=np.int32)
    a0 = np.empty(n, dtype=np.int32)
    a1 = np.empty(n, dtype=np.int32)
    wrows = np.nonzero(is_write & ~is_info)[0]
    irows = np.nonzero(is_info)[0]
    fc[wrows] = wr_codes[payload[wrows], 0]
    a0[wrows] = wr_codes[payload[wrows], 1]
    a1[wrows] = wr_codes[payload[wrows], 2]
    fc[irows] = wr_info_codes[payload[irows], 0]
    a0[irows] = wr_info_codes[payload[irows], 1]
    a1[irows] = wr_info_codes[payload[irows], 2]
    seen = read_rows[read_val >= 0]
    seen_val = read_val[read_val >= 0]
    fc[seen] = rd_codes[seen_val, 0]
    a0[seen] = rd_codes[seen_val, 1]
    a1[seen] = rd_codes[seen_val, 2]

    status = np.where(is_info, ST_INFO, ST_OK).astype(np.int32)
    ret = np.where(is_info, NO_RET, ret_rank)

    # Reads of the initial value encode to None and are dropped, as
    # pack_history drops them; event ranks are not renumbered.
    keep = np.ones(n, dtype=bool)
    keep[read_rows[read_val < 0]] = False

    # Rows in invocation order, like pack_history's.
    o = np.nonzero(keep)[0][np.argsort(inv_rank[keep])]
    inv_s = inv_rank[o]
    ret_s = ret[o]
    m = len(o)

    ret_sorted = np.sort(ret_s)
    preds = np.searchsorted(ret_sorted, inv_s, side="left").astype(np.int64)
    inv_before_ret = np.searchsorted(inv_s, ret_s, side="left").astype(np.int64)
    horizon = np.minimum(inv_before_ret - 1, m - 1)

    return PackedOps(
        inv=inv_s,
        ret=ret_s,
        process=proc[o],
        status=status[o],
        f=fc[o],
        a0=a0[o],
        a1=a1[o],
        src_index=inv_s.copy(),
        preds=preds,
        horizon=horizon,
    )
