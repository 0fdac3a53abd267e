"""Rolling-window online checking for a standing monitor.

The port of `jepsen_tpu/monitor/rolling.py`.  A monitor run never
finishes: ops keep arriving, and the verdict must stay current while
memory stays bounded.  The streaming session (streaming/pipeline.py)
checks incrementally but keeps every row until finish(); this adds
history discard.

Per key, a `RollingChecker` owns a `PackedBuilder` and a
`FrontierCarry` and, after each advance, asks the PackedBuilder to drop the
longest stable prefix the frontier can never revisit
(`PackedBuilder.discard_stable_prefix`) and shifts the carry in
lockstep (`FrontierCarry.rebase`).  The discard's conditions keep the
retained computation identical to the undiscarded run, so resident
history per key is bounded by the advance cadence plus one processed
block.

Once a prefix is gone, the post-hoc fallback a dead frontier escalates
to is impossible.  A frontier death therefore becomes an epoch
restart: the dying epoch's verdict is recorded as "unknown" (never
"valid"), and a fresh packer and frontier start a new epoch from the
live stream.  A device fault is no death: it raises out of `feed`,
`pump` and `finish` (a host fault at finish is an "unknown", as in the
reference).
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Any, Hashable, Optional, Union

import torch

from .. import telemetry
from ..history.packed import PackedBuilder
from ..models.base import PackedModel
from ..ops import degrade
from ..streaming.frontier import FrontierCarry

log = logging.getLogger(__name__)

#: Rough resident cost of one packed row tuple (8 ints and the tuple),
#: for `resident_bytes`.
ROW_BYTES = 120

#: Per-key ring of (rows, time) points for the verdict-lag estimate.
LAG_POINTS = 256


class _KeyState:
    __slots__ = (
        "packer", "frontier", "rows_at_advance", "discarded_rows",
        "discarded_bars", "epoch", "unknown_epochs", "lag_points",
        "last_reason",
    )

    def __init__(self, packer: PackedBuilder, frontier: FrontierCarry):
        self.packer = packer
        self.frontier = frontier
        self.rows_at_advance = 0
        self.discarded_rows = 0
        self.discarded_bars = 0
        self.epoch = 0
        self.unknown_epochs = 0
        self.lag_points: collections.deque = collections.deque(
            maxlen=LAG_POINTS)
        self.last_reason: Optional[str] = None


class RollingChecker:
    """Keyed rolling online checker: feed ops, memory stays bounded.

    `discard=False` runs the same computation without dropping history
    (the parity baseline).  Frontiers run on `device` (the card by
    default)."""

    def __init__(
        self,
        pm: PackedModel,
        *,
        bars_per_block: int = 64,
        blocks_per_call: int = 4,
        beam: int = 8,
        advance_rows: int = 1024,
        discard: bool = True,
        max_window: int = 32768,
        info_window: Optional[int] = None,
        device: Union[str, torch.device, None] = "cuda",
    ):
        self.pm = pm
        self.K = bars_per_block
        self.NB = blocks_per_call
        self.beam = beam
        self.advance_rows = max(1, advance_rows)
        self.discard = discard
        self.max_window = max_window
        self.info_window = info_window
        self.device = device
        self._keys: dict[Hashable, _KeyState] = {}

    # -- internals ----------------------------------------------------------

    def _fresh(self) -> tuple[PackedBuilder, FrontierCarry]:
        return (
            PackedBuilder(self.pm.encode),
            FrontierCarry(self.pm, beam=self.beam, bars_per_block=self.K,
                          blocks_per_call=self.NB,
                          max_window=self.max_window,
                          info_window=self.info_window, device=self.device),
        )

    def _state(self, key: Hashable) -> _KeyState:
        ks = self._keys.get(key)
        if ks is None:
            ks = self._keys[key] = _KeyState(*self._fresh())
        return ks

    def _restart_epoch(self, key: Hashable, ks: _KeyState,
                       reason: str) -> None:
        """The frontier died after history was discarded: the epoch's
        verdict is unknown; a fresh pair takes up the live stream (its
        PackedBuilder tolerates completions whose invocations died with the
        old epoch)."""
        ks.unknown_epochs += 1
        ks.epoch += 1
        ks.last_reason = reason
        ks.packer, ks.frontier = self._fresh()
        ks.rows_at_advance = 0
        ks.discarded_rows = 0
        ks.discarded_bars = 0
        ks.lag_points.clear()
        telemetry.count("monitor.epoch-restarts")
        log.warning("monitor key %r: epoch restart (%s)", key, reason)

    def _advance(self, key: Hashable, ks: _KeyState,
                 now: Optional[float]) -> None:
        packed, s = ks.packer.snapshot()
        ks.frontier.advance(packed, s)
        ks.rows_at_advance = ks.packer.n_rows
        if now is not None:
            ks.lag_points.append((ks.discarded_bars + ks.packer.n_rows, now))
        if ks.frontier.dead:
            self._restart_epoch(key, ks,
                                ks.frontier.dead_reason or "frontier died")
            return
        if not self.discard:
            return
        rows, bars, _ = ks.packer.discard_stable_prefix(
            bars_per_block=self.K, blocks_done=ks.frontier.blocks_done)
        if rows:
            ks.frontier.rebase(rows, bars)
            if ks.frontier.dead:
                self._restart_epoch(key, ks,
                                    ks.frontier.dead_reason or "rebase failed")
                return
            ks.discarded_rows += rows
            ks.discarded_bars += bars
            ks.rows_at_advance = ks.packer.n_rows
            telemetry.count("monitor.discards")
            telemetry.count("monitor.discarded-rows", rows)

    # -- API ----------------------------------------------------------------

    def feed(self, key: Hashable, op: Any,
             now: Optional[float] = None) -> None:
        """Appends one op to `key`'s stream, advancing (and discarding)
        when the cadence is due."""
        ks = self._state(key)
        ks.packer.append(op)
        if ks.packer.n_rows - ks.rows_at_advance >= self.advance_rows:
            self._advance(key, ks, now)

    def feed_many(self, key: Hashable, ops: list,
                  now: Optional[float] = None) -> None:
        """feed() for a burst of one key's ops: one columnar append,
        then at most one advance."""
        ks = self._state(key)
        ks.packer.append_many(ops)
        if ks.packer.n_rows - ks.rows_at_advance >= self.advance_rows:
            self._advance(key, ks, now)

    def pump(self, now: Optional[float] = None) -> None:
        """Advances every key whatever the cadence (idle flush)."""
        for key, ks in list(self._keys.items()):
            if ks.packer.n_rows > ks.rows_at_advance:
                self._advance(key, ks, now)

    def finish(self) -> dict:
        """Closes every stream: {key: True | "unknown"}.  True means a
        witness survived the whole retained run and no epoch was lost;
        anything else is unknown (with history discarded there is no
        escalation, so this never claims invalid)."""
        verdicts: dict = {}
        for key, ks in self._keys.items():
            ok = None
            if not ks.frontier.dead:
                try:
                    ok = ks.frontier.finalize(ks.packer.finish())
                except Exception as e:  # noqa: BLE001 — an honest unknown
                    if degrade.is_device_fault(e):
                        raise
                    log.warning("monitor key %r finalize failed: %r",
                                key, e)
            verdicts[key] = (True if ok and ks.unknown_epochs == 0
                             else "unknown")
        return verdicts

    # -- observability ------------------------------------------------------

    def resident_rows(self) -> int:
        return sum(ks.packer.n_rows for ks in self._keys.values())

    def resident_bytes(self) -> int:
        """Estimated resident history: packed rows plus each key's
        carried device window."""
        total = 0
        for ks in self._keys.values():
            total += ks.packer.n_rows * ROW_BYTES
            f = ks.frontier
            if f._member is not None:
                total += f._member.numel() * f._member.element_size()
                total += f.B * (self.pm.state_width * 4 + 1)
            if f._prev_active is not None:
                total += int(f._prev_active.nbytes)
        return total

    def proven_rows(self) -> int:
        return sum(ks.discarded_bars + ks.frontier.bars_done
                   for ks in self._keys.values())

    def verdict_lag_s(self, now: Optional[float] = None) -> float:
        """Seconds since the oldest row not yet proven was fed: exact
        for all-OK streams (every row is a barrier), an approximation
        with info ops."""
        if now is None:
            now = time.monotonic()
        worst = 0.0
        for ks in self._keys.values():
            proven = ks.discarded_bars + ks.frontier.bars_done
            pts = ks.lag_points
            while pts and pts[0][0] <= proven:
                pts.popleft()
            if pts:
                worst = max(worst, now - pts[0][1])
        return worst

    def epochs(self) -> dict:
        """{key: {"epoch", "unknown", "last-reason"}}."""
        return {key: {"epoch": ks.epoch, "unknown": ks.unknown_epochs,
                      "last-reason": ks.last_reason}
                for key, ks in self._keys.items()}

    def status(self) -> dict:
        keys = self._keys.values()
        return {
            "keys": len(self._keys),
            "resident-rows": self.resident_rows(),
            "resident-bytes": self.resident_bytes(),
            "discarded-rows": sum(ks.discarded_rows for ks in keys),
            "blocks-done": sum(ks.frontier.blocks_done for ks in keys),
            "epoch-restarts": sum(ks.unknown_epochs for ks in keys),
        }
