"""Incremental frontier state for the online witness search.

The port of `jepsen_tpu/streaming/frontier.py`.  The witness engine
(ops/wgl_witness.py) runs as chunks of blocks whose carry — member
window, beam states, alive mask — is a frontier: every lane alive after
block b is a legal linearization of the first (b+1)*K barriers.
`FrontierCarry` keeps that carry between calls: each `advance()`
extends it over the barriers that have become decidable since the last
call, instead of restarting the search from op 0.  On the card the
blocks' sweeps run the witness sweep kernel (csrc/witness_sweep.cu),
on the CPU the plain sweep.

Soundness — which rows and barriers may be consumed mid-run.  Let s be
the stable bound of `PackedBuilder` (history/packed.py: the
least invocation index over in-flight ops).

1. Row-prefix stability.  Rows with inv < s are final: a future row
   belongs to an in-flight op (inv >= s) or to an op not yet invoked,
   so new rows only append after the inv-sorted prefix.  The carried
   window (row indices in `prev_active`) stays valid.
2. Barrier-prefix stability.  A barrier (ok row) with ret < s is final
   in the ret-sorted barrier order: a future completion comes after
   every current event, and an in-flight op has inv >= s, hence ret >
   s.  So the first `n_stable_bars` barriers have final ranks, and a
   block whose K barriers are all stable has a final window (its
   entrants have inv < end_ret < s).

`advance()` therefore runs only full blocks of K stable barriers.  Rows
in those windows whose own barrier is not yet stable carry a
provisional rank >= n_stable_bars, and inside a processed block the
engine only tests `rank < k_rank` and `rank >= k0`, which the
provisional and the final rank decide alike.  A re-plan on a longer
prefix reproduces the processed blocks exactly, so the carry composes.

The window width W only grows as the history lengthens; the member
matrix grows by False rows (positions past the old width were never
occupied), and the re-gather indexes only positions < len(prev_active).

What ends a frontier (it is then dead, and the caller escalates to the
post-hoc checkers, so a death costs latency, never the verdict): the
planner's int32 overflow, a window wider than `max_window`, a witness
death, and a device out-of-memory error (recorded as a degradation
step).  Nothing else: a kernel that does not build or launch, or a
missing card, raises out of `advance` and `finalize`.  A fault raised
in the middle of a run of chunks leaves the carry between two blocks,
so the frontier keeps it and raises it again from every later call: it
never advances past the fault, and never reports True.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Union

import numpy as np
import torch

from .. import device as _device
from .. import telemetry
from ..history.packed import ST_OK, PackedOps
from ..models.base import PackedModel
from ..ops import degrade
from ..ops.wgl import _bucket, packed_enabled
from ..ops.wgl_witness import (NARROW_INFO_WINDOW, _plan_blocks,
                               compact_width, initial_carry, run_chunks)

log = logging.getLogger(__name__)


class FrontierCarry:
    """Carries the witness search's device state across stable-prefix
    snapshots of one packed stream.

    `advance(packed, s)` after each ingest with the PackedBuilder's current
    snapshot; `finalize(packed)` once with the finished pack.  finalize
    returns True when a witness survives the whole stream (exact: it is
    linearizable) or None when the frontier died — escalate, never
    report invalid from here.  Counts "online_advances", "online_chunks"
    and "frontier_deaths" in `device.counters`; `device_s` and `plan_s`
    sum the host-clock time of the chunk runs and of the plans."""

    def __init__(
        self,
        pm: PackedModel,
        *,
        beam: int = 8,
        bars_per_block: int = 1024,
        blocks_per_call: int = 8,
        depth: int = 5,
        info_window: Optional[int] = NARROW_INFO_WINDOW,
        max_window: int = 32768,
        device: Union[str, torch.device, None] = "cuda",
    ):
        self.pm = pm
        self.dev = _device.resolve(device)
        self.B = _bucket(beam, lo=8)
        self.K = bars_per_block
        self.NB = blocks_per_call
        self.D = depth
        self.info_window = info_window
        self.max_window = max_window
        #: the carried window as 32-bit words (`JEPSEN_WGL_PACKED`)
        self.packed = packed_enabled()

        self.dead = False
        self.dead_reason: Optional[str] = None
        #: a fault raised out of a chunk run, raised again by every call
        self.fault: Optional[BaseException] = None
        self.blocks_done = 0
        self.bars_done = 0
        self.chunks = 0
        self.device_s = 0.0
        self.plan_s = 0.0

        self._W = 0
        # (W, B) bool, or (W, ceil(B/32)) int32 words when packed
        self._member: Optional[torch.Tensor] = None
        self._states: Optional[torch.Tensor] = None   # (B, SW) int32
        self._alive: Optional[torch.Tensor] = None    # (B,) bool
        self._prev_active: Optional[np.ndarray] = None

    # -- internals ----------------------------------------------------------

    def _die(self, reason: str) -> None:
        self.dead = True
        self.dead_reason = reason
        # A dead frontier never resumes: free the device carry.
        self._member = self._states = self._alive = None
        _device.count("frontier_deaths")
        telemetry.count("wgl.online.frontier-deaths")
        log.info("online frontier died: %s (after %d blocks)",
                 reason, self.blocks_done)

    def _ensure_width(self, W: int) -> None:
        """Grows the window to W rows on the device, padding the carried
        member matrix with empty rows."""
        if W <= self._W:
            return
        if self._member is not None:
            m = self._member
            pad = torch.zeros((W - m.shape[0], m.shape[1]), dtype=m.dtype,
                              device=self.dev)
            self._member = torch.cat([self._member, pad])
        self._W = W

    def _run_blocks(self, packed: PackedOps, plan, upto: int) -> bool:
        """Runs blocks [blocks_done, upto) from the carry.  Returns False
        when the frontier died."""
        blocks = plan[4]
        if upto <= self.blocks_done:
            return True
        todo = blocks[self.blocks_done:upto]
        W_need = _bucket(max(self._W, 1, max(len(a) for _, _, a in todo)))
        if W_need > self.max_window:
            self._die(f"window {W_need} exceeds max {self.max_window}")
            return False
        t0 = time.monotonic()
        try:
            self._ensure_width(W_need)
            if self._member is None:
                self._member, self._states, self._alive, _ = initial_carry(
                    self.pm, self._W, self.B, self.dev, self.packed)
            carry = (self._member, self._states, self._alive,
                     self._prev_active)
            chunks = run_chunks(
                self.pm, packed, plan, todo, carry, K=self.K, NB=self.NB,
                D=self.D, compact=compact_width(self._W, self.info_window),
                dev=self.dev)
            for _ in range(-(-len(todo) // self.NB)):
                with telemetry.span("wgl.online.chunk"):
                    carry, nblk, failed, _ = next(chunks)
                self.device_s += time.monotonic() - t0
                self.chunks += 1
                _device.count("online_chunks")
                telemetry.count("wgl.online.chunks")
                self.blocks_done += nblk
                self.bars_done = sum(len(b[1])
                                     for b in blocks[:self.blocks_done])
                (self._member, self._states, self._alive,
                 self._prev_active) = carry
                if failed:
                    self._die("frontier died (witness cannot prove)")
                    return False
                t0 = time.monotonic()
        except Exception as e:  # noqa: BLE001 — only out-of-memory ends it
            if not degrade.is_resource_error(e):
                self.fault = e
                raise
            degrade.record("frontier", "die", e)
            self._die(f"device out of memory: {type(e).__name__}: {e}")
            return False
        return True

    def _plan(self, packed: PackedOps):
        t0 = time.monotonic()
        try:
            return _plan_blocks(packed, self.K, self.info_window)
        except OverflowError:
            self._die("timeline exceeds int32")
            return None
        finally:
            self.plan_s += time.monotonic() - t0

    # -- API ----------------------------------------------------------------

    def rebase(self, rows_dropped: int, bars_dropped: int) -> None:
        """Shifts the carry after the PackedBuilder discarded a stable prefix
        (`PackedBuilder.discard_stable_prefix`): row indices fall by
        `rows_dropped`, barrier ranks by `bars_dropped`.  The discard's
        conditions make the dropped rows a row prefix holding the
        lowest barrier ranks, and keep the newest processed block
        resident, so the carried window names only retained rows; the
        device tensors hold no row indices and carry over untouched."""
        if self.dead or rows_dropped <= 0:
            return
        if bars_dropped % self.K != 0:
            self._die(f"rebase of {bars_dropped} bars misaligned to "
                      f"K={self.K}")
            return
        blocks_gone = bars_dropped // self.K
        if blocks_gone >= self.blocks_done:
            self._die(f"rebase would drop {blocks_gone} of "
                      f"{self.blocks_done} processed blocks")
            return
        self.blocks_done -= blocks_gone
        self.bars_done -= bars_dropped
        telemetry.count("wgl.online.rebase")
        telemetry.count("wgl.online.rebase-bars", bars_dropped)
        if self._prev_active is not None:
            if (self._prev_active.size
                    and int(self._prev_active.min()) < rows_dropped):
                self._die("rebase dropped a row still in the carry window")
                return
            self._prev_active = self._prev_active - rows_dropped

    def advance(self, packed: PackedOps, s: int) -> None:
        """Consumes the newly decidable barriers of a stable-prefix
        snapshot (`packed`, stable bound `s`).  Only full blocks of K
        barriers with ret < s run; the rest wait for the next call or
        for finalize()."""
        if self.fault is not None:
            raise self.fault
        if self.dead or packed.n == 0 or packed.n_ok == 0:
            return
        _device.count("online_advances")
        with telemetry.span("wgl.online.advance", rows=packed.n):
            plan = self._plan(packed)
            if plan is None:
                return
            n_stable_bars = int(np.count_nonzero(
                (packed.status == ST_OK) & (packed.ret < s)))
            upto = min(n_stable_bars // self.K, len(plan[4]))
            self._run_blocks(packed, plan, upto)

    def finalize(self, packed: PackedOps) -> Optional[bool]:
        """Runs the remaining blocks over the finished pack: True = a
        witness survives (the stream is linearizable), None = escalate
        post-hoc."""
        if self.fault is not None:
            raise self.fault
        if self.dead:
            return None
        if packed.n == 0 or packed.n_ok == 0:
            return True  # no barriers: trivially linearizable
        plan = self._plan(packed)
        if plan is None:
            return None
        if not self._run_blocks(packed, plan, len(plan[4])):
            return None
        if self._alive is None or not _device.host(self._alive.any()):
            self._die("frontier empty at finalize")
            return None
        return True
