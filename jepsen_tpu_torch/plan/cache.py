"""The persistent plan memo.

The port's copy of `jepsen_tpu/plan/cache.py`.  With a cache directory
(`JEPSEN_PLAN_CACHE=<dir>` or `configure(dir)`; none means no on-disk
state and the in-memory settle memo behaves as before), settled
plan-node verdicts are journaled to `<dir>/plan-memo.jtpu`, an
append-only file in the store's block framing (store/format.py,
`BLOCK_PLAN` blocks; the same bytes the JAX package writes, so either
package replays the other's journal).  The key is
`sha256(packed digest | plan identity)`, where the identity covers the
model, algorithm and budget: changing any of them misses, a
byte-identical resubmission hits, and a restarted process re-checking
the same history skips the search.  A torn tail (a crash mid-append)
is truncated on reopen.

Only decisive, sanitized verdicts are journaled: callers strip the
positional fields (final-configs, crashed-op) before `put`, as the
in-memory settle memo does.

Left out: the reference's XLA compile cache beside the memo.  Torch
compiles nothing here, and the CUDA kernels' build is cached under
build/ by a hash of their source; `stats()` reports `xla_files: 0`.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from typing import Optional

from .. import telemetry
from ..store import format as fmt

log = logging.getLogger(__name__)

MEMO_FILE = "plan-memo.jtpu"

#: Journal entries larger than this are not memoized: the memo is a
#: verdict cache, not a certificate store.
MAX_ENTRY_BYTES = 1 << 20


def memo_key(digest: str, identity: dict) -> str:
    """Cache key for one settled unit of work: `digest` is the packed
    history's digest (`parallel.independent._settle_digest`), `identity`
    every plan fact whose change must invalidate (model, algorithm,
    budget, plan kind)."""
    blob = json.dumps(identity, sort_keys=True, separators=(",", ":"),
                      default=repr)
    return hashlib.sha256(f"{digest}|{blob}".encode()).hexdigest()


class PlanMemo:
    """The journaled verdict memo; thread-safe, one per process per
    cache directory."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._mem: dict[str, dict] = {}
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.loaded = 0
        self._writer: Optional[fmt.BlockWriter] = None
        self._load()

    def _load(self) -> None:
        """Replays the journal (the last write per key wins); the
        writer opened after it truncates a torn tail before appending."""
        if os.path.exists(self.path):
            try:
                with open(self.path, "rb") as f:
                    if f.read(len(fmt.MAGIC)) == fmt.MAGIC:
                        size = os.path.getsize(self.path)
                        while True:
                            rec = fmt._read_block(f, size)
                            if rec is None:
                                break
                            _, btype, payload = rec
                            if btype != fmt.BLOCK_PLAN:
                                continue
                            k, v = payload.get("k"), payload.get("v")
                            if isinstance(k, str) and isinstance(v, dict):
                                self._mem[k] = v
            except OSError as e:
                log.warning("plan memo %s unreadable: %r", self.path, e)
        self.loaded = len(self._mem)
        self._writer = fmt.BlockWriter(self.path)

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            v = self._mem.get(key)
            if v is None:
                self.misses += 1
                telemetry.count("wgl.plan.memo-miss")
                return None
            self.hits += 1
        telemetry.count("wgl.plan.memo-hit")
        return json.loads(json.dumps(v))  # caller-owned copy

    def put(self, key: str, verdict: dict) -> None:
        entry = {"k": key, "v": verdict, "ts": round(time.time(), 3)}
        try:
            blob = json.dumps(verdict, default=repr)
        except (TypeError, ValueError):
            return
        if len(blob) > MAX_ENTRY_BYTES:
            telemetry.count("wgl.plan.memo-oversize")
            return
        with self._lock:
            if key in self._mem:
                return
            self._mem[key] = json.loads(json.dumps(verdict, default=repr))
            self.puts += 1
            if self._writer is not None:
                try:
                    self._writer.append(fmt.BLOCK_PLAN, entry)
                    self._writer.sync()
                except OSError as e:
                    log.warning("plan memo append failed: %r", e)
        telemetry.count("wgl.plan.memo-store")

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)

    def stats(self) -> dict:
        with self._lock:
            return {
                "path": self.path,
                "entries": len(self._mem),
                "loaded": self.loaded,
                "hits": self.hits,
                "misses": self.misses,
                "puts": self.puts,
            }

    def close(self) -> None:
        with self._lock:
            if self._writer is not None:
                self._writer.close()
                self._writer = None


# ---------------------------------------------------------------------------
# Process-wide activation
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_memo: Optional[PlanMemo] = None
_dir: Optional[str] = None
_configured = False


def configure(cache_dir: Optional[str]) -> None:
    """Points the process at a cache directory, or at None to run
    purely in memory; without a call, JEPSEN_PLAN_CACHE decides."""
    global _memo, _dir, _configured
    with _lock:
        if _memo is not None:
            _memo.close()
        _memo = None
        _dir = cache_dir
        _configured = True


def cache_dir() -> Optional[str]:
    """The memo's directory: the configured one, else JEPSEN_PLAN_CACHE;
    None (no memo) with `JEPSEN_PLAN=0`."""
    from . import CACHE_ENV, enabled

    if not enabled():
        return None
    with _lock:
        if _configured:
            return _dir
    return os.environ.get(CACHE_ENV) or None


def active_memo() -> Optional[PlanMemo]:
    """The process's plan memo, or None when no cache dir is set."""
    global _memo
    d = cache_dir()
    if not d:
        return None
    with _lock:
        if _memo is not None and _memo.path == os.path.join(d, MEMO_FILE):
            return _memo
        try:
            os.makedirs(d, exist_ok=True)
            _memo = PlanMemo(os.path.join(d, MEMO_FILE))
        except OSError as e:
            log.warning("plan cache dir %s unusable: %r", d, e)
            _memo = None
        return _memo


def stats() -> dict:
    """The cache's state: its directory and the memo's counts."""
    d = cache_dir()
    m = active_memo() if d else None
    return {
        "dir": d,
        "memo": m.stats() if m is not None else None,
        "xla_files": 0,
        "xla_enabled": False,
    }


def reset_for_tests() -> None:
    """Drops the process-wide cache state (closes the memo, forgets the
    configured directory): the next check stands for a fresh process."""
    global _memo, _dir, _configured
    with _lock:
        if _memo is not None:
            _memo.close()
        _memo = None
        _dir = None
        _configured = False
