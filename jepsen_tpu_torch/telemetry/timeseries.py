"""Durable, tiered time-series history + in-process quantile rings.

The port's copy of `jepsen_tpu/telemetry/timeseries.py`.  Its files are
the reference's block framing (store/format.py `BLOCK_SERIES`), byte
for byte, so a series directory written by either package reads in the
other.  What differs: `SeriesTail` reads unbuffered, so a tail opened
on a torn file before a restarted writer truncates it follows the new
blocks (the reference's buffered reader re-reads the torn bytes).

The scrape surface (``prometheus_text``) is a point in
time; a standing monitor run needs *history* — what was the
verdict lag an hour ago, when did the queue start growing — that
survives process restarts and costs bounded disk over a week.  Two
pieces live here:

``SeriesStore``
    A crash-safe, tiered store of sampled series built on the same
    block framing as test files (store/format.py): each cadence tick
    appends one ``BLOCK_SERIES`` frame ``{"t": unix_s, "s": {name:
    value}}``.  A torn tail (SIGKILL mid-append) fails its CRC and is
    truncated by ``BlockWriter`` on reopen, so restarts resume cleanly.

    Disk stays bounded by two mechanisms: *downsampling tiers* and
    *rotation*.  Tier 0 holds raw samples at the monitor cadence;
    tier 1 aggregates each series over ``TIER1_S`` buckets
    (min/max/mean/last/n); tier 2 over ``TIER2_S``.  Each tier is one
    file plus at most one rotated predecessor (``.1``), rotated when it
    crosses ``max_tier_bytes`` — so a week-long run holds at most
    ``3 * 2 * max_tier_bytes`` of series history while tier 2 still
    spans days.  In-memory rings (bounded deques per series) are
    rebuilt from disk on open, which is what lets the ``/monitor``
    dashboard serve sparklines across a monitor-process restart.

``observe()`` / ``quantile_gauges()``
    A small in-process ring of raw observations per named series
    (e.g. every streaming verdict-lag sample), from which p50/p95/p99
    are computed on demand.  ``prometheus_text`` exports these as a
    Prometheus summary family and the SLO engine thresholds on the
    ``<name>.p95`` gauge instead of a single last-sample gauge.

``Sampler``
    The cadence collector: one ``sample()`` call flattens the
    telemetry registry (counters, gauges), SLO firing states, chip
    health, and per-pass profile medians (with the cost-model
    predicted-vs-measured drift ratio when a trained model is active)
    into one flat ``{name: float}`` dict and appends it to the store.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Any, Iterator, Optional

from ..store.format import BLOCK_SERIES, MAGIC, BlockWriter, _read_block

log = logging.getLogger(__name__)

#: Default downsampling bucket widths (seconds).
TIER1_S = 30.0
TIER2_S = 300.0

#: Default per-tier file-size rotation threshold.  3 tiers x 2
#: generations x 4 MiB = 24 MiB worst-case disk for a week of history.
MAX_TIER_BYTES = 4 * 1024 * 1024

#: In-memory ring length per series per tier (what the dashboard can
#: sparkline without touching disk).
MEM_POINTS = 720

#: File-name stem for tier files inside the store directory.
SERIES_STEM = "series-t{tier}.jtpu"

_QUANTS = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))

#: Raw observations kept per quantile ring.
QUANT_RING = 1024

_rings_lock = threading.Lock()
_rings: dict[str, collections.deque] = {}


# ---------------------------------------------------------------------------
# Quantile rings (in-process, feeding prometheus summaries + SLO gauges)
# ---------------------------------------------------------------------------


def observe(name: str, value: Any) -> None:
    """Records one raw observation into `name`'s quantile ring."""
    try:
        v = float(value)
    except (TypeError, ValueError):
        return
    with _rings_lock:
        ring = _rings.get(name)
        if ring is None:
            ring = _rings[name] = collections.deque(maxlen=QUANT_RING)
        ring.append(v)


def quantiles(name: str) -> dict[str, float]:
    """{"p50": v, "p95": v, "p99": v} over `name`'s ring (empty when
    nothing observed)."""
    with _rings_lock:
        ring = _rings.get(name)
        vals = sorted(ring) if ring else []
    if not vals:
        return {}
    n = len(vals)
    out = {}
    for label, q in _QUANTS:
        # Nearest-rank on the sorted ring: robust, no interpolation.
        i = min(n - 1, max(0, int(round(q * (n - 1)))))
        out[label] = vals[i]
    return out


def quantile_gauges() -> dict[str, float]:
    """Flat {"<series>.p50": v, ...} over every observed ring — the
    extra-gauge dict SLO rules threshold on (a p95 over the ring is a
    far steadier alert input than the last single sample)."""
    with _rings_lock:
        names = list(_rings.keys())
    out: dict[str, float] = {}
    for name in names:
        for label, v in quantiles(name).items():
            out[f"{name}.{label}"] = v
    return out


def ring_names() -> list[str]:
    with _rings_lock:
        return sorted(_rings.keys())


def reset_rings() -> None:
    with _rings_lock:
        _rings.clear()


# ---------------------------------------------------------------------------
# Durable tiered store
# ---------------------------------------------------------------------------


def _iter_series_file(path: str) -> Iterator[dict]:
    """Every intact BLOCK_SERIES payload in `path`, in file order; torn
    or foreign blocks end the scan (the BlockWriter reopen truncates
    them before new writes, so readers just stop at the tear)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    try:
        with open(path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                return
            while True:
                rec = _read_block(f, size)
                if rec is None:
                    return
                _, btype, payload = rec
                if btype == BLOCK_SERIES and isinstance(payload, dict):
                    yield payload
    except OSError:
        return


def series_path(directory: str, tier: int = 0) -> str:
    """Tier file path inside a monitor store dir (no store needed)."""
    return os.path.join(directory, SERIES_STEM.format(tier=tier))


def _agg_value(v: Any) -> Optional[float]:
    """Numeric value of one stored sample: raw float for tier 0, the
    mean (falling back to last) for tier 1/2 aggregate rows."""
    if isinstance(v, dict):
        v = v.get("mean", v.get("last"))
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def read_disk_names(directory: str, tier: int = 0) -> list[str]:
    """Series names present in a tier's files on disk — the dashboard's
    cross-process listing (a detached `jepsen serve` has no SeriesStore
    in memory for the monitor's dir)."""
    names: set[str] = set()
    path = series_path(directory, tier)
    for p in (path + ".1", path):
        for payload in _iter_series_file(p):
            s = payload.get("s")
            if isinstance(s, dict):
                names.update(s.keys())
    return sorted(names)


def read_disk_series(
    directory: str,
    name: str,
    *,
    tier: int = 0,
    since: Optional[float] = None,
    limit: int = 0,
) -> list[tuple[float, float]]:
    """[(t, value)] for one series straight from a tier's files on
    disk, oldest first (rotated generation before current)."""
    pts: list[tuple[float, float]] = []
    path = series_path(directory, tier)
    for p in (path + ".1", path):
        for payload in _iter_series_file(p):
            s = payload.get("s")
            if not isinstance(s, dict) or name not in s:
                continue
            try:
                t = float(payload.get("t"))
            except (TypeError, ValueError):
                continue
            if since is not None and t < since:
                continue
            v = _agg_value(s[name])
            if v is not None:
                pts.append((t, v))
    if limit and len(pts) > limit:
        pts = pts[-limit:]
    return pts


class SeriesTail:
    """Incremental reader of one tier file for the SSE stream: each
    `poll()` returns the sample payloads appended since the last call.

    A half-written block (the writer is live, not crashed) fails its
    CRC and simply isn't consumed — the position stays put and the next
    poll picks it up once complete.  Rotation (the file replaced by
    `.1`) is detected by inode change or shrink: the old handle is
    drained to its tear, then the new file is followed from its top.
    """

    def __init__(self, path: str, *, from_end: bool = True):
        self.path = path
        self.f: Optional[Any] = None
        self.pos = 0
        self.ino: Optional[int] = None
        if from_end:
            # Swallow existing history: the SSE client bootstraps from
            # /api/series and only wants what comes after.
            self.poll()

    def _open(self) -> bool:
        # Unbuffered: a restarted writer truncates a torn tail and
        # writes new blocks over it, and a buffered reader seeking back
        # to the tear would keep reading the garbage from its buffer.
        try:
            f = open(self.path, "rb", buffering=0)
        except OSError:
            return False
        if f.read(len(MAGIC)) != MAGIC:
            f.close()
            return False
        self.f = f
        self.pos = len(MAGIC)
        try:
            self.ino = os.fstat(f.fileno()).st_ino
        except OSError:
            self.ino = None
        return True

    def _drain(self) -> list[dict]:
        out: list[dict] = []
        f = self.f
        if f is None:
            return out
        try:
            size = os.fstat(f.fileno()).st_size
            f.seek(self.pos)
            while True:
                rec = _read_block(f, size)
                if rec is None:
                    return out
                self.pos = f.tell()
                _, btype, payload = rec
                if btype == BLOCK_SERIES and isinstance(payload, dict):
                    out.append(payload)
        except OSError:
            return out

    def poll(self) -> list[dict]:
        out: list[dict] = []
        try:
            st: Optional[os.stat_result] = os.stat(self.path)
        except OSError:
            st = None
        if self.f is not None and st is not None and (
            st.st_ino != self.ino or st.st_size < self.pos
        ):
            out.extend(self._drain())  # finish the rotated generation
            self.close()
        if self.f is None:
            if st is None or not self._open():
                return out
        out.extend(self._drain())
        return out

    def close(self) -> None:
        if self.f is not None:
            try:
                self.f.close()
            except OSError as e:
                log.debug("series tail close failed: %r", e)
            self.f = None


class _Agg:
    """One open downsampling bucket: per-series [min, max, sum, n, last]."""

    __slots__ = ("bucket", "stats")

    def __init__(self, bucket: int):
        self.bucket = bucket
        self.stats: dict[str, list] = {}

    def add(self, samples: dict[str, float]) -> None:
        for name, v in samples.items():
            st = self.stats.get(name)
            if st is None:
                self.stats[name] = [v, v, v, 1, v]
            else:
                if v < st[0]:
                    st[0] = v
                if v > st[1]:
                    st[1] = v
                st[2] += v
                st[3] += 1
                st[4] = v

    def payload(self) -> dict[str, dict]:
        return {
            name: {
                "min": st[0],
                "max": st[1],
                "mean": st[2] / st[3],
                "last": st[4],
                "n": st[3],
            }
            for name, st in self.stats.items()
        }


class SeriesStore:
    """The durable tiered series store for one monitor directory.

    Thread-safe: `append` may race `query` (the web handler samples
    from a different thread than the monitor loop)."""

    def __init__(
        self,
        directory: str,
        *,
        max_tier_bytes: int = MAX_TIER_BYTES,
        mem_points: int = MEM_POINTS,
        tier1_s: float = TIER1_S,
        tier2_s: float = TIER2_S,
    ):
        self.directory = directory
        self.max_tier_bytes = max_tier_bytes
        self.mem_points = mem_points
        self.tier_widths = (0.0, float(tier1_s), float(tier2_s))
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)
        #: tier -> {series name -> deque[(t, value)]}
        self._mem: list[dict[str, collections.deque]] = [{}, {}, {}]  # guarded-by: self._lock
        #: open aggregation buckets for tiers 1 and 2 (index by tier).
        self._aggs: list[Optional[_Agg]] = [None, None, None]  # guarded-by: self._lock
        self._writers: list[Optional[BlockWriter]] = [None, None, None]  # guarded-by: self._lock
        self._rebuild()

    # -- paths / files ------------------------------------------------------

    def tier_path(self, tier: int) -> str:
        return os.path.join(self.directory, SERIES_STEM.format(tier=tier))

    def _writer(self, tier: int) -> BlockWriter:
        w = self._writers[tier]
        if w is None:
            w = self._writers[tier] = BlockWriter(self.tier_path(tier))
        return w

    def _rebuild(self) -> None:
        """Reloads the in-memory rings from disk (rotated generation
        first, then current) so a restarted monitor serves continuous
        sparklines."""
        for tier in range(3):
            rings: dict[str, collections.deque] = {}
            path = self.tier_path(tier)
            for p in (path + ".1", path):
                for payload in _iter_series_file(p):
                    t = payload.get("t")
                    samples = payload.get("s")
                    if not isinstance(samples, dict):
                        continue
                    self._mem_add(rings, t, samples, tier)
            self._mem[tier] = rings

    def _mem_add(
        self, rings: dict, t: Any, samples: dict, tier: int
    ) -> None:
        try:
            t = float(t)
        except (TypeError, ValueError):
            return
        for name, v in samples.items():
            if isinstance(v, dict):  # tier 1/2 aggregate rows
                v = v.get("mean", v.get("last"))
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            ring = rings.get(name)
            if ring is None:
                ring = rings[name] = collections.deque(
                    maxlen=self.mem_points
                )
            ring.append((t, v))

    def _rotate_if_needed(self, tier: int) -> None:
        w = self._writers[tier]
        if w is None:
            return
        try:
            if w.f.tell() < self.max_tier_bytes:
                return
            # fsync before the close+rename: the rotated-out `.1`
            # generation is the archive readers trust — renaming bytes
            # the kernel hasn't durably written would let a power cut
            # eat the end of a file we just promoted to "sealed".
            w.sync()
            w.close()
        except (OSError, ValueError):
            pass
        self._writers[tier] = None
        path = self.tier_path(tier)
        try:
            os.replace(path, path + ".1")
        except OSError as e:
            log.warning("series tier %d rotate failed: %r", tier, e)

    # -- write path ---------------------------------------------------------

    def append(
        self, samples: dict[str, Any], t: Optional[float] = None
    ) -> None:
        """Appends one cadence tick of raw samples.  Non-numeric values
        are dropped; tiers 1/2 flush their previous bucket when `t`
        crosses a bucket boundary."""
        if t is None:
            t = time.time()
        clean: dict[str, float] = {}
        for name, v in samples.items():
            try:
                clean[name] = float(v)
            except (TypeError, ValueError):
                continue
        if not clean:
            return
        with self._lock:
            self._append_tier(0, t, clean)
            self._mem_add(self._mem[0], t, clean, 0)
            for tier in (1, 2):
                self._roll_agg(tier, t, clean)

    def _append_tier(self, tier: int, t: float, payload: dict) -> None:
        try:
            w = self._writer(tier)
            w.append(BLOCK_SERIES, {"t": round(t, 3), "s": payload})
            self._rotate_if_needed(tier)
        except OSError as e:
            log.warning("series tier %d append failed: %r", tier, e)

    def _roll_agg(self, tier: int, t: float, samples: dict) -> None:
        width = self.tier_widths[tier]
        bucket = int(t // width)
        agg = self._aggs[tier]
        if agg is not None and agg.bucket != bucket:
            self._flush_agg(tier, agg)
            agg = None
        if agg is None:
            agg = self._aggs[tier] = _Agg(bucket)
        agg.add(samples)

    def _flush_agg(self, tier: int, agg: _Agg) -> None:
        width = self.tier_widths[tier]
        t_end = (agg.bucket + 1) * width
        payload = agg.payload()
        self._append_tier(tier, t_end, payload)
        self._mem_add(self._mem[tier], t_end, payload, tier)

    def flush(self) -> None:
        """Flushes open aggregation buckets and fsyncs every tier —
        call on orderly shutdown (crash loses only open buckets and the
        torn tail)."""
        with self._lock:
            for tier in (1, 2):
                agg = self._aggs[tier]
                if agg is not None and agg.stats:
                    self._flush_agg(tier, agg)
                    self._aggs[tier] = None
            for w in self._writers:
                if w is not None:
                    try:
                        w.sync()
                    except OSError:
                        pass

    def close(self) -> None:
        self.flush()
        with self._lock:
            for i, w in enumerate(self._writers):
                if w is not None:
                    try:
                        w.close()
                    except OSError as e:
                        log.debug("series tier %d close failed: %r",
                                  i, e)
                    self._writers[i] = None

    # -- read path ----------------------------------------------------------

    def names(self) -> list[str]:
        with self._lock:
            seen: set[str] = set()
            for rings in self._mem:
                seen.update(rings.keys())
            return sorted(seen)

    def query(
        self,
        name: str,
        *,
        tier: int = 0,
        since: Optional[float] = None,
        limit: int = 0,
    ) -> list[tuple[float, float]]:
        """[(t, value)] for one series from the in-memory ring of a
        tier, oldest first.  `since` filters by timestamp; `limit`
        keeps the newest N."""
        with self._lock:
            ring = self._mem[tier].get(name)
            pts = list(ring) if ring else []
        if since is not None:
            pts = [p for p in pts if p[0] >= since]
        if limit and len(pts) > limit:
            pts = pts[-limit:]
        return pts

    def disk_bytes(self) -> int:
        total = 0
        for tier in range(3):
            path = self.tier_path(tier)
            for p in (path, path + ".1"):
                try:
                    total += os.path.getsize(p)
                except OSError:
                    pass
        return total

    def resident_points(self) -> int:
        """Total in-memory ring points across every tier and series —
        the bounded number the memory-ceiling test asserts on."""
        with self._lock:
            return sum(
                len(r) for rings in self._mem for r in rings.values()
            )


# ---------------------------------------------------------------------------
# Cadence sampler
# ---------------------------------------------------------------------------

#: Gauge prefixes sampled raw into the store every tick (counters are
#: stored as their cumulative values; the dashboard diffs for rates).
_SKIP_PREFIXES = ("lint.",)


def _profile_medians(path: str, *, tail: int = 400) -> dict[str, float]:
    """{"profile.<pass>.median-s": v} over the newest `tail` records of
    a profile store, plus the cost-model drift ratio
    (measured / predicted, median over the same window) when a trained
    model covers the pass."""
    from ..plan import costmodel

    try:
        from . import profile as _profile

        records = _profile.read(path)[-tail:]
    except Exception:  # noqa: BLE001 — sampling never raises
        return {}
    if not records:
        return {}
    by_pass: dict[str, list[float]] = {}
    ratios: list[float] = []
    model = None
    try:
        model = costmodel.active_model()
    except Exception:  # noqa: BLE001
        model = None
    for rec in records:
        measured = costmodel.record_cost_s(rec)
        if measured <= 0:
            continue
        by_pass.setdefault(rec["pass"], []).append(measured)
        if model is not None:
            try:
                pred = model.predict_s(
                    rec["pass"], rec["features"], rec["plan"]
                )
            except Exception:  # noqa: BLE001
                pred = None
            if pred is not None and pred > 0:
                ratios.append(measured / pred)
    out: dict[str, float] = {}
    for name, vals in by_pass.items():
        vals.sort()
        out[f"profile.{name}.median-s"] = vals[len(vals) // 2]
    if ratios:
        ratios.sort()
        out["monitor.cost-drift-ratio"] = ratios[len(ratios) // 2]
    return out


class Sampler:
    """Collects one flat sample dict per cadence tick and appends it to
    a SeriesStore.  Profile medians (a file read) refresh every
    `profile_every` ticks, not every tick."""

    def __init__(
        self,
        store: SeriesStore,
        *,
        profile_path: Optional[str] = None,
        profile_every: int = 6,
    ):
        self.store = store
        self.profile_path = profile_path
        self.profile_every = max(1, profile_every)
        self._ticks = 0
        self._profile_cache: dict[str, float] = {}

    def collect(self, extra: Optional[dict] = None) -> dict[str, float]:
        from . import summary as _summary
        from . import slo as _slo

        samples: dict[str, float] = {}
        try:
            summ = _summary()
            for name, v in summ.get("counters", {}).items():
                if name.startswith(_SKIP_PREFIXES):
                    continue
                try:
                    samples[name] = float(v)
                except (TypeError, ValueError):
                    continue
            for name, g in summ.get("gauges", {}).items():
                try:
                    samples[name] = float(g["last"])
                except (TypeError, ValueError, KeyError):
                    continue
        except Exception:  # noqa: BLE001 — sampling never raises
            pass
        try:
            for name, v in _slo.firing_gauges().items():
                samples[f"slo.{name}"] = float(v)
        except Exception:  # noqa: BLE001
            pass
        for name, v in quantile_gauges().items():
            samples[name] = v
        self._ticks += 1
        if self.profile_path and (
            self._ticks % self.profile_every == 1 or not self._profile_cache
        ):
            self._profile_cache = _profile_medians(self.profile_path)
        samples.update(self._profile_cache)
        if extra:
            for name, v in extra.items():
                try:
                    samples[name] = float(v)
                except (TypeError, ValueError):
                    continue
        return samples

    def sample(
        self, extra: Optional[dict] = None, t: Optional[float] = None
    ) -> dict[str, float]:
        samples = self.collect(extra)
        if samples:
            self.store.append(samples, t)
        return samples
