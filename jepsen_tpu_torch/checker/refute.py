"""Sound O(n log n) non-linearizability screens over op intervals.

The port's copy of `jepsen_tpu/checker/refute.py`.

The exact engines (wgl_cpu.py's DFS, wgl_event.py's event walk) decide
both directions but share WGL's worst case: once accumulated :info ops
unlock every model state, the per-barrier closure is the full subset
lattice of open ops — exponential in concurrency — and no constant
factor saves a 50k-op invalid history.  The reference hits the same
wall: knossos times out on BASELINE.md's north-star history.

This module is the third racer (knossos.competition races solvers the
same way, consumed at checker.clj:214-233): *necessary conditions* for
linearizability of register-family histories, checked columnar in
numpy.  When a condition fails, the history is PROVEN non-linearizable
and the screen returns a certificate; when none fails it returns None
and the exact engines carry on.  Sound, incomplete, O(n log n) — it
settles at any scale the two invalid families that dominate practice:

* unsupported read — an :ok op asserts a value no op could have
  produced before it returned (a read of a never-acknowledged write);
* stale read — every producer of the asserted value is *necessarily*
  overwritten: some :ok non-producer op's whole window fits between
  the producer's return and the reader's invocation (the async-
  replication shape: a backup serving a value the primary overwrote
  long ago, e.g. demo/repkv's unsafe reads).

Soundness argument (zone conditions in the style of Gibbons & Korach,
"Testing Shared Memories", SIAM J. Comput. 1997): suppose a
linearization exists and :ok op r asserts value v at its point t_r ∈
(inv_r, ret_r).  Let q be the op whose effect last established v
before t_r (or "initial state" if none).  Then q is a producer of v
with inv_q < t_r ≤ ret_r.  If some :ok op w with a forced effect ≠ v
on the same key has its whole window inside (ret_q, inv_r), then w's
effect lands strictly between t_q and t_r, so state left v after q —
contradicting q being last (whatever re-established v would be a later
producer, considered separately).  An :info producer can linearize
arbitrarily late, so it is never killable this way; it blocks
refutation whenever inv < ret_r.  Hence: if EVERY candidate q is
killed and v is not an unperturbed initial value, no linearization
exists.

Models opt in through `PackedModel.refute_view` returning a
`RefuteView`; models without one (queues, sets) simply skip the
screen.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .. import telemetry
from ..history.packed import NIL, ST_OK, PackedOps
from ..models.base import PackedModel
from .wgl_cpu import WGLResult

#: "before everything" / "no overwriter" sentinel for M values.
_NEG = np.iinfo(np.int64).min // 4


@dataclass
class RefuteView:
    """Per-row facets the screens run on.

    - key:      (n,) int32 — state word the op touches (0 for scalar
                registers; the register index for multi-register).
    - asserts:  (n,) int32 — value code the state must equal at the
                op's linearization point (reads: the value read; cas:
                the expected value), or NIL.
    - produces: (n,) int32 — value code the op forces the key to on
                success (writes and cas new-values), or NIL.  For :ok
                rows the effect is certain (the op returned); for
                :info rows it is possible.
    - init:     (n_keys,) int32 — initial value code per key.
    """

    key: np.ndarray
    asserts: np.ndarray
    produces: np.ndarray
    init: np.ndarray


def _top2_distinct(ret_w: np.ndarray, inv_w: np.ndarray,
                   label_w: np.ndarray):
    """Prefix structure over overwriters sorted by ret: for each prefix,
    the max inv and, with a different produce-label, the runner-up max
    inv.  Lets M(t, v) = "latest inv among ops with ret ≤ t whose label
    ≠ v" be answered per query from two tracks."""
    order = np.argsort(ret_w, kind="stable")
    ret_s, inv_s, lab_s = ret_w[order], inv_w[order], label_w[order]
    m = len(order)
    best = np.full(m, _NEG, dtype=np.int64)
    best_lab = np.full(m, NIL, dtype=np.int64)
    alt = np.full(m, _NEG, dtype=np.int64)
    b, bl, a = _NEG, NIL, _NEG
    for i in range(m):
        iv, lb = int(inv_s[i]), int(lab_s[i])
        if lb == bl:
            if iv > b:
                b = iv
        elif iv > b:
            # New champion with a new label; old champion becomes the
            # best-with-different-label iff its inv beats the alt.
            if b > a and bl != NIL:
                a = b
            b, bl = iv, lb
        elif iv > a:
            a = iv
        best[i], best_lab[i], alt[i] = b, bl, a
    return ret_s, best, best_lab, alt


def check_refute(
    packed: PackedOps,
    pm: PackedModel,
    *,
    time_limit_s: Optional[float] = None,
    report_configs: int = 10,
) -> Optional[WGLResult]:
    """Runs the screens; WGLResult(valid=False, ...) with a certificate
    when a violation is proven, else None (no opinion — NOT "valid").
    Timed in a `checker.refute` span."""
    with telemetry.span("checker.refute"):
        return _screens(packed, pm, time_limit_s, report_configs)


def _screens(packed: PackedOps, pm: PackedModel,
             time_limit_s: Optional[float],
             report_configs: int) -> Optional[WGLResult]:
    if pm.refute_view is None or packed.n == 0:
        return None
    t0 = time.monotonic()
    # The screen is O(n log n) and a pre-pass, not a search: even with
    # no configured limit it must not stall the engines behind it.
    limit = 60.0 if time_limit_s is None else time_limit_s
    view = pm.refute_view(packed)

    inv = packed.inv.astype(np.int64)
    ret = packed.ret.astype(np.int64)
    ok = packed.status == ST_OK
    key = view.key.astype(np.int64)
    asserts = view.asserts.astype(np.int64)
    produces = view.produces.astype(np.int64)

    # :info rows may linearize arbitrarily late: their ret is +inf for
    # every screen purpose (packed stores NO_RET; normalize).
    big = np.iinfo(np.int64).max // 4
    ret = np.where(ok, ret, big)

    ass_rows = np.nonzero(ok & (asserts != NIL))[0]
    if len(ass_rows) == 0:
        return None

    refuted: list[dict] = []
    crashed_at: Optional[int] = None
    done = False

    for k in np.unique(key[ass_rows]):
        if done or time.monotonic() - t0 > limit:
            break
        on_key = key == k
        a_rows = ass_rows[key[ass_rows] == k]
        # Forced overwriters: :ok effects on this key.  Label = value
        # produced, so M can exclude producers of the queried value.
        w_rows = np.nonzero(on_key & ok & (produces != NIL))[0]
        have_w = len(w_rows) > 0
        if have_w:
            ret_s, best, best_lab, alt = _top2_distinct(
                ret[w_rows], inv[w_rows], produces[w_rows]
            )
        p_rows = np.nonzero(on_key & (produces != NIL))[0]
        init_v = int(view.init[int(k)])

        # Group asserting rows and producers by value ONCE (sorted +
        # sliced): a per-value boolean rescan would be quadratic on
        # unique-value histories.
        a_sorted = a_rows[np.argsort(asserts[a_rows], kind="stable")]
        a_vals = asserts[a_sorted]
        p_sorted = p_rows[np.argsort(produces[p_rows], kind="stable")]
        p_vals = produces[p_sorted]
        group_vals, group_starts = np.unique(a_vals, return_index=True)
        group_ends = np.append(group_starts[1:], len(a_vals))

        for v, g_lo, g_hi in zip(group_vals, group_starts, group_ends):
            v = int(v)
            rows_v = a_sorted[g_lo:g_hi]
            # M per query: latest inv among overwriters (≠ v) whose
            # whole window precedes the query's invocation.
            if have_w:
                j = np.searchsorted(ret_s, inv[rows_v], side="right") - 1
                jc = np.maximum(j, 0)
                M = np.where(
                    j < 0, _NEG,
                    np.where(best_lab[jc] != v, best[jc], alt[jc]),
                )
            else:
                M = np.full(len(rows_v), _NEG, dtype=np.int64)

            alive = (v == init_v) & (M == _NEG)
            pv = p_sorted[
                np.searchsorted(p_vals, v, side="left"):
                np.searchsorted(p_vals, v, side="right")
            ]
            if len(pv):
                # :info producers are never killable: they may
                # linearize arbitrarily late.
                pi = pv[~ok[pv]]
                if len(pi):
                    alive = alive | (int(inv[pi].min()) < ret[rows_v])
                # An :ok producer survives when no overwriter window
                # fits after its return: among producers with
                # ret > M, the earliest invocation must precede the
                # query's return.
                po = pv[ok[pv]]
                if len(po):
                    o = np.argsort(ret[po], kind="stable")
                    ret_p = ret[po][o]
                    # suffix-min of inv over producers sorted by ret
                    sufmin = np.minimum.accumulate(inv[po][o][::-1])[::-1]
                    sufmin = np.append(sufmin, big)
                    idx = np.searchsorted(ret_p, M, side="right")
                    alive = alive | (sufmin[idx] < ret[rows_v])

            for r in rows_v[~alive]:
                refuted.append(
                    _certificate(packed, pm, view, int(r), v,
                                 int(M[np.nonzero(rows_v == r)[0][0]]),
                                 pv, ok)
                )
                if crashed_at is None or ret[r] < ret[crashed_at]:
                    crashed_at = int(r)
                if len(refuted) >= report_configs:
                    done = True
                    break
            if done or time.monotonic() - t0 > limit:
                done = True
                break

    if not refuted:
        return None
    return WGLResult(
        valid=False,
        configs_explored=len(ass_rows),
        final_configs=refuted,
        crashed_at=crashed_at,
        elapsed_s=time.monotonic() - t0,
    )


def _certificate(packed, pm, view, r: int, v: int, M: int, pv, ok):
    desc = (
        pm.describe_op(int(packed.f[r]), int(packed.a0[r]),
                       int(packed.a1[r]))
        if pm.describe_op else None
    )
    val = pm.interner.value(v) if v != NIL else None
    producers = [
        {
            "history-index": int(packed.src_index[p]),
            "status": "ok" if ok[p] else "info",
            "killed-by-overwrite-before": int(M),
        }
        for p in pv[:8]
    ]
    return {
        "screen": "unsupported-read" if len(pv) == 0 else "stale-read",
        "op": desc,
        "history-index": int(packed.src_index[r]),
        "asserted-value": val,
        "producers-considered": producers,
        "proof": (
            "no op that could produce the asserted value is "
            "linearizable before this op returns"
            if len(pv) == 0 else
            "every producer of the asserted value is necessarily "
            "overwritten by an acknowledged op whose whole window "
            "precedes this op's invocation"
        ),
    }
