"""Disk-budgeted retention sweeper for standing monitor runs.

The port's copy of `jepsen_tpu/monitor/retention.py` (host code).

A standing tenant accumulates two kinds of disk state under its store
dir: verdict/fault dossiers (`forensics/monitor/*.json`, one JSON per
non-valid epoch or fault postmortem) and the tiered series store
(`series-t{0,1,2}.jtpu` plus at most one rotated `.1` predecessor per
tier).  The monitor bounds RSS but nothing bounded disk — a
months-long run grows forever.  `sweep()` enforces three independent
ceilings per tenant:

  - **count** (`retain_dossiers`): keep at most N dossiers, deleting
    oldest-first by mtime;
  - **age** (`retain_days`): delete dossiers and rotated series
    generations older than D days;
  - **bytes** (`budget_bytes`): if the tenant's total dossier+series
    footprint still exceeds the budget, delete more oldest-first
    dossiers, then the oldest rotated series generations.

Invariants, in every phase: the *newest* dossier is never deleted
(the most recent forensic evidence always survives a sweep, however
old), and an *open* series file (`series-t{t}.jtpu`, the one the
writer holds) is never touched — only rotated `.1` generations are
GC-able.  Sweeps are idempotent: a second pass over an already-swept
store deletes nothing.

Counters live under `fleet.retention.*` (sweeps, dossiers-deleted,
series-deleted, bytes-freed, errors) so the fleet supervisor's
periodic sweeps are observable per scrape.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

from .. import telemetry
from ..forensics import FORENSICS_DIR

MONITOR_FORENSICS = "monitor"

#: Open (writer-held) series files — never deleted.  Rotated
#: generations carry a ``.1`` suffix and are the only GC-able tier
#: files.
_OPEN_SERIES = tuple(f"series-t{t}.jtpu" for t in range(3))


@dataclass(frozen=True)
class RetentionPolicy:
    """Per-tenant retention knobs (CLI: --retain-dossiers,
    --retain-days, --retain-bytes)."""

    retain_dossiers: int = 64
    retain_days: float = 14.0
    budget_bytes: Optional[int] = None


def _mtime_size(path: str) -> Tuple[float, int]:
    st = os.stat(path)
    return st.st_mtime, st.st_size


def _dossiers(store_dir: str) -> List[Tuple[float, int, str]]:
    """(mtime, size, path) for every monitor dossier, oldest first."""
    d = os.path.join(store_dir, FORENSICS_DIR, MONITOR_FORENSICS)
    out = []
    for p in glob.glob(os.path.join(d, "*.json")):
        try:
            mt, sz = _mtime_size(p)
        except OSError:
            continue
        out.append((mt, sz, p))
    out.sort()
    return out


def _rotated_series(store_dir: str) -> List[Tuple[float, int, str]]:
    """(mtime, size, path) for rotated series generations, oldest
    first.  Open tier files are excluded by construction."""
    out = []
    for p in glob.glob(os.path.join(store_dir, "series-t*.jtpu.1")):
        try:
            mt, sz = _mtime_size(p)
        except OSError:
            continue
        out.append((mt, sz, p))
    out.sort()
    return out


def disk_bytes(store_dir: str) -> int:
    """Total dossier + series footprint for one tenant store — the
    figure the byte budget and the fleet dashboard both report."""
    total = 0
    for _, sz, _ in _dossiers(store_dir):
        total += sz
    for _, sz, _ in _rotated_series(store_dir):
        total += sz
    for name in _OPEN_SERIES:
        try:
            total += os.path.getsize(os.path.join(store_dir, name))
        except OSError:
            pass
    return total


def _unlink(path: str, report: dict) -> int:
    """Best-effort delete; returns bytes freed (0 on failure)."""
    try:
        sz = os.path.getsize(path)
        os.unlink(path)
    except OSError:
        telemetry.count("fleet.retention.errors")
        return 0
    report["deleted"].append(os.path.basename(path))
    return sz


def sweep(store_dir: str, policy: RetentionPolicy,
          now: Optional[float] = None) -> dict:
    """One retention pass over a tenant store.  Returns a report dict
    ({deleted, dossiers-deleted, series-deleted, bytes-freed,
    disk-bytes}); safe to call concurrently with a live monitor (it
    only ever removes closed files)."""
    import time as _time
    now = _time.time() if now is None else now
    telemetry.count("fleet.retention.sweeps")
    report: dict = {"deleted": [], "dossiers-deleted": 0,
                    "series-deleted": 0, "bytes-freed": 0}

    dossiers = _dossiers(store_dir)
    # Phase 1 — count ceiling: oldest beyond retain_dossiers go, but
    # the newest dossier always survives (retain_dossiers >= 1).
    keep = max(1, int(policy.retain_dossiers))
    excess = dossiers[:-keep] if len(dossiers) > keep else []
    # Phase 2 — age ceiling on the remainder, newest still exempt.
    cutoff = now - policy.retain_days * 86400.0
    aged = [d for d in dossiers[len(excess):-1] if d[0] < cutoff]
    for _, _, p in excess + aged:
        freed = _unlink(p, report)
        if freed:
            report["dossiers-deleted"] += 1
            report["bytes-freed"] += freed

    # Phase 2b — rotated series generations past the age ceiling.
    rotated = _rotated_series(store_dir)
    stale = [r for r in rotated if r[0] < cutoff]
    for _, _, p in stale:
        freed = _unlink(p, report)
        if freed:
            report["series-deleted"] += 1
            report["bytes-freed"] += freed

    # Phase 3 — byte budget: more oldest-first dossiers (newest
    # exempt), then oldest rotated generations, until under budget.
    if policy.budget_bytes is not None:
        total = disk_bytes(store_dir)
        if total > policy.budget_bytes:
            survivors = _dossiers(store_dir)
            for _, _, p in survivors[:-1]:
                if total <= policy.budget_bytes:
                    break
                freed = _unlink(p, report)
                if freed:
                    report["dossiers-deleted"] += 1
                    report["bytes-freed"] += freed
                    total -= freed
            for _, _, p in _rotated_series(store_dir):
                if total <= policy.budget_bytes:
                    break
                freed = _unlink(p, report)
                if freed:
                    report["series-deleted"] += 1
                    report["bytes-freed"] += freed
                    total -= freed

    if report["dossiers-deleted"]:
        telemetry.count("fleet.retention.dossiers-deleted",
                        report["dossiers-deleted"])
    if report["series-deleted"]:
        telemetry.count("fleet.retention.series-deleted",
                        report["series-deleted"])
    if report["bytes-freed"]:
        telemetry.count("fleet.retention.bytes-freed",
                        report["bytes-freed"])
    report["disk-bytes"] = disk_bytes(store_dir)
    return report
