"""The checkerd overload control plane: degrade gracefully, never lie.

The port's copy of `jepsen_tpu/checkerd/overload.py`.  Four mechanisms,
composed through the daemon (scheduler, server, client):

* **Weighted fair queueing** (`FairQueue`).  Deficit round-robin over
  per-tenant queues replaces the scheduler's FIFO list: each tenant
  accumulates `quantum * weight` key-credits per scheduling round and
  a request is served once its tenant's credit covers its key count.
  A whale tenant can saturate its own queue without starving a light
  tenant — the light tenant's head is always at most one round away.
  Quota becomes a *weight*, not a cliff: an over-subscribed tenant
  waits proportionally longer instead of being hard-rejected.

* **Deadline-aware load shedding** (`LatencyEstimator` +
  `OverloadShed`).  A SUBMIT may carry a client ``deadline-s``; at
  admission the scheduler estimates queue wait plus predicted verdict
  latency — the plan cost model's per-pass regressors
  (plan/costmodel.py) when trained, the observed per-key verdict rate
  otherwise — and sheds *early* with a structured RETRY-AFTER reply
  (F_SHED) instead of burning device time on a verdict nobody will
  read.  A shed is an honest, machine-readable refusal: the client
  retries after the hint or falls back in-process, never hangs.

* **Brownout ladder** (`BrownoutController`).  Under sustained
  pressure (queue-depth / RSS samples breaching their thresholds for
  `up_count` consecutive samples) the fleet drops optional plan passes
  first — level 1 skips the stream-witness beam, level 2 also drops
  the batched-BFS accelerator and doubles the shed estimate — before
  anything degrades to honest-unknown.  Transitions are recorded
  through the degradation machinery (ops/degrade.record), so
  brownouts appear in flight recorder dumps and result metadata like
  every other degradation.  All tiers that remain are sound: the
  witness beam and BFS accelerator only ever *prove* keys early;
  dropping them routes work to the exact CPU tiers.

* **Client-side circuit breakers** (`CircuitBreaker`).  RemoteChecker
  consults a per-address breaker before dialing: after
  `failure_threshold` consecutive transport failures the breaker opens
  and holds requests off the address for a jittered exponential
  backoff, then half-opens to let one probe through.  A browning-out
  fleet is not hammered by retry storms.

Counters/gauges live in the ``checkerd.overload.*`` namespace.
"""

from __future__ import annotations

import math
import os
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from .. import telemetry

# ---------------------------------------------------------------------------
# Shed replies
# ---------------------------------------------------------------------------


class OverloadShed(Exception):
    """An admission refused by the overload control plane.  Carries the
    structured F_SHED payload; the server turns it into a frame,
    the client into a bounded retry or an in-process fallback — never a
    silent loss."""

    def __init__(self, reason: str, retry_after_s: float, *,
                 tenant: Optional[str] = None,
                 estimate_s: Optional[float] = None,
                 deadline_s: Optional[float] = None):
        super().__init__(reason)
        self.reason = reason
        self.retry_after_s = max(0.1, float(retry_after_s))
        self.tenant = tenant
        self.estimate_s = estimate_s
        self.deadline_s = deadline_s

    def payload(self) -> dict:
        out: dict[str, Any] = {
            "shed": True,
            "reason": self.reason,
            "retry-after-s": round(self.retry_after_s, 3),
        }
        if self.tenant is not None:
            out["tenant"] = self.tenant
        if self.estimate_s is not None:
            out["estimate-s"] = round(self.estimate_s, 3)
        if self.deadline_s is not None:
            out["deadline-s"] = self.deadline_s
        return out

    @classmethod
    def from_payload(cls, payload: dict) -> "OverloadShed":
        # Wire-facing: a malformed shed from a buggy peer degrades to
        # the default backoff, never a client-side parse crash.
        try:
            retry = float(payload.get("retry-after-s") or 1.0)
        except (TypeError, ValueError):
            retry = 1.0
        return cls(
            str(payload.get("reason") or "shed"),
            retry,
            tenant=payload.get("tenant"),
            estimate_s=payload.get("estimate-s"),
            deadline_s=payload.get("deadline-s"),
        )


# ---------------------------------------------------------------------------
# Weighted fair queueing (deficit round-robin)
# ---------------------------------------------------------------------------

#: Key-credits granted per tenant per scheduling round.  One round
#: serves roughly one quantum-sized request per active tenant, so the
#: worst-case wait for a light tenant's head is one cohort per heavier
#: tenant — the starvation bound tests/test_overload.py pins down.
DEFAULT_QUANTUM = 8.0


def request_cost(req: Any) -> float:
    """The DRR cost of serving one request, in key-units."""
    return max(1.0, float(getattr(req, "n_keys", 0) or 0))


class FairQueue:
    """Deficit round-robin over per-tenant FIFO queues.

    NOT thread-safe: the scheduler calls it under its own condition
    lock, like the list it replaces.  Requests need ``tenant``,
    ``compat``, ``n_keys`` and ``abandoned`` attributes.

    Deficits only accumulate while a tenant has queued work and reset
    to zero when its queue drains (standard DRR: no banking credit
    while idle).  Requests that join another tenant's cohort via the
    compat merge (`take_compat`) are charged too — merged service is
    cheap for the fleet but still counts as service for fairness.
    """

    def __init__(self, *, quantum: float = DEFAULT_QUANTUM,
                 weights: Optional[dict[str, float]] = None):
        self.quantum = float(quantum)
        self.weights: dict[str, float] = dict(weights or {})
        self._queues: dict[str, deque] = {}
        self._deficit: dict[str, float] = {}
        self._ring: list[str] = []
        self._cursor = 0

    def weight(self, tenant: str) -> float:
        w = self.weights.get(tenant, 1.0)
        return w if w > 0 else 1.0

    def set_weight(self, tenant: str, weight: float) -> None:
        self.weights[tenant] = float(weight)

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def push(self, req: Any) -> None:
        t = str(getattr(req, "tenant", None) or "anonymous")
        q = self._queues.get(t)
        if q is None:
            q = self._queues[t] = deque()
            self._deficit.setdefault(t, 0.0)
            self._ring.append(t)
        q.append(req)

    def requests(self) -> list:
        """Snapshot of every queued request (stats/iteration)."""
        return [r for q in self._queues.values() for r in q]

    def _retire(self, tenant: str) -> None:
        """Drops a drained tenant from the ring, resetting its credit."""
        if not self._queues.get(tenant):
            self._queues.pop(tenant, None)
            self._deficit[tenant] = 0.0
            try:
                i = self._ring.index(tenant)
            except ValueError:
                return
            del self._ring[i]
            if i < self._cursor:
                self._cursor -= 1
            if self._ring:
                self._cursor %= len(self._ring)
            else:
                self._cursor = 0

    def drop_abandoned(self) -> list:
        """Removes and returns every abandoned request (the scheduler
        settles them as honest unknowns at the cohort boundary)."""
        condemned = []
        for t in list(self._queues):
            q = self._queues[t]
            keep = deque(r for r in q if not r.abandoned)
            condemned.extend(r for r in q if r.abandoned)
            self._queues[t] = keep
            self._retire(t)
        return condemned

    def next_head(self) -> Optional[Any]:
        """Pops the next request DRR order serves, advancing every
        active tenant's deficit by however many whole rounds the pick
        needs (equivalent to running the classic visit loop, but O(n)
        per pop instead of O(rounds * n))."""
        if not self._ring:
            return None
        n = len(self._ring)
        best: Optional[tuple[tuple[int, int], str]] = None
        for dist in range(n):
            t = self._ring[(self._cursor + dist) % n]
            head = self._queues[t][0]
            need = request_cost(head) - self._deficit[t]
            per_round = self.quantum * self.weight(t)
            rounds = 0 if need <= 0 else int(math.ceil(need / per_round))
            key = (rounds, dist)
            if best is None or key < best[0]:
                best = (key, t)
        (rounds, _dist), tenant = best
        if rounds:
            for t in self._ring:
                self._deficit[t] += rounds * self.quantum * self.weight(t)
        req = self._queues[tenant].popleft()
        self._deficit[tenant] -= request_cost(req)
        n = len(self._ring)
        self._cursor = (self._ring.index(tenant) + 1) % n
        self._retire(tenant)
        return req

    def take_compat(self, compat: Any) -> list:
        """Pops every queued request whose compat key matches —
        they ride the forming cohort for free fleet-wise, but each
        tenant is charged for its own keys."""
        taken = []
        for t in list(self._queues):
            q = self._queues[t]
            matched = [r for r in q if r.compat == compat]
            if not matched:
                continue
            self._queues[t] = deque(r for r in q if r.compat != compat)
            for r in matched:
                self._deficit[t] -= request_cost(r)
            taken.extend(matched)
            self._retire(t)
        return taken

    def snapshot(self) -> dict[str, dict]:
        """Per-tenant queue state for stats()/the /fleet panel."""
        return {
            t: {
                "queued": len(q),
                "queued-keys": int(sum(r.n_keys for r in q)),
                "deficit": round(self._deficit.get(t, 0.0), 3),
                "weight": self.weight(t),
            }
            for t, q in self._queues.items()
        }


# ---------------------------------------------------------------------------
# Per-tenant service accounting (queue-wait p95, served/shed counts)
# ---------------------------------------------------------------------------

_WAIT_WINDOW = 256


class TenantStats:
    """Rolling per-tenant service record.  Thread-safe (one lock; every
    call is O(1) except the p95 snapshot)."""

    def __init__(self, window: int = _WAIT_WINDOW):
        self._lock = threading.Lock()
        self._window = window
        self._waits: dict[str, deque] = {}
        self._served: dict[str, int] = {}
        self._shed: dict[str, int] = {}

    def observe_wait(self, tenant: str, wait_s: float) -> None:
        with self._lock:
            d = self._waits.get(tenant)
            if d is None:
                d = self._waits[tenant] = deque(maxlen=self._window)
            d.append(float(wait_s))
            self._served[tenant] = self._served.get(tenant, 0) + 1

    def record_shed(self, tenant: str) -> None:
        with self._lock:
            self._shed[tenant] = self._shed.get(tenant, 0) + 1

    def shed_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._shed)

    def wait_p95(self, tenant: str) -> Optional[float]:
        with self._lock:
            d = self._waits.get(tenant)
            if not d:
                return None
            xs = sorted(d)
        return xs[min(len(xs) - 1, int(math.ceil(0.95 * len(xs))) - 1)]

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            tenants = set(self._waits) | set(self._served) | set(self._shed)
            out = {}
            for t in tenants:
                d = self._waits.get(t)
                xs = sorted(d) if d else []
                p95 = (xs[min(len(xs) - 1,
                              int(math.ceil(0.95 * len(xs))) - 1)]
                       if xs else None)
                out[t] = {
                    "served": self._served.get(t, 0),
                    "shed": self._shed.get(t, 0),
                    "queue-wait-p95-s": round(p95, 4)
                    if p95 is not None else None,
                }
            return out


# ---------------------------------------------------------------------------
# Deadline shedding: predicted verdict latency + queue wait
# ---------------------------------------------------------------------------

#: Heuristic per-key verdict cost before any observation or trained
#: model exists (conservative: a fresh daemon under-sheds rather than
#: over-sheds).
DEFAULT_PER_KEY_S = 0.05
DEFAULT_BASE_S = 0.2

#: Cost-model passes summed into a predicted verdict latency; the
#: subset that dominates a cohort's wall clock.
_PREDICT_PASSES = ("stream-witness", "refute-screen", "packs-exact",
                   "settle-exact")


class LatencyEstimator:
    """Predicted verdict latency for an incoming submission.

    Prefers the trained plan cost model (per-pass ridge regressors on
    log1p shape features — the learned-performance-model approach);
    falls back to the observed per-key verdict rate over a rolling
    window, then to a fixed heuristic.  Thread-safe.
    """

    def __init__(self, window: int = 128):
        self._lock = threading.Lock()
        self._obs: deque = deque(maxlen=window)  # (keys, check_s)

    def observe(self, keys: int, check_s: float) -> None:
        if keys <= 0 or check_s < 0:
            return
        with self._lock:
            self._obs.append((int(keys), float(check_s)))

    def _observed_per_key_s(self) -> Optional[float]:
        with self._lock:
            if not self._obs:
                return None
            total_k = sum(k for k, _ in self._obs)
            total_s = sum(s for _, s in self._obs)
        if total_k <= 0:
            return None
        return total_s / total_k

    def predict_s(self, n_keys: int, n_ops: int = 0) -> float:
        """Predicted check seconds for one submission."""
        n_keys = max(1, int(n_keys))
        try:
            from ..plan import costmodel

            m = costmodel.active_model()
        except Exception:  # noqa: BLE001 — estimation must never fail
            m = None
        if m is not None:
            feats = {"keys": n_keys, "ops": max(n_ops, n_keys)}
            total = 0.0
            covered = 0
            for p in _PREDICT_PASSES:
                y = m.predict_s(p, feats, {})
                if y is not None:
                    total += y
                    covered += 1
            if covered:
                telemetry.count("checkerd.overload.predict-model")
                return total
        per_key = self._observed_per_key_s()
        if per_key is not None:
            telemetry.count("checkerd.overload.predict-observed")
            return DEFAULT_BASE_S + per_key * n_keys
        telemetry.count("checkerd.overload.predict-heuristic")
        return DEFAULT_BASE_S + DEFAULT_PER_KEY_S * n_keys

    def queue_wait_s(self, queued_keys: int) -> float:
        """Estimated wait until a submission admitted *now* starts:
        the backlog's keys at the observed (or heuristic) rate."""
        if queued_keys <= 0:
            return 0.0
        per_key = self._observed_per_key_s()
        if per_key is None:
            per_key = DEFAULT_PER_KEY_S
        return per_key * queued_keys


# ---------------------------------------------------------------------------
# Brownout ladder
# ---------------------------------------------------------------------------

#: Env override for chaos/testing: force a brownout level (0..2)
#: regardless of samples.  Read on every sample so a restarted daemon
#: under test picks it up without code changes.  The value is either a
#: literal level or ``file:PATH`` — the level lives in PATH's contents
#: (missing/empty file = no force), so a chaos harness can drive
#: memory-pressure faults in a child daemon it cannot re-env.
FORCE_ENV = "JEPSEN_BROWNOUT_FORCE"


def _env_indirect(value: Optional[str]) -> Optional[str]:
    """Resolves a fault-env value, following one ``file:PATH`` hop."""
    if not value:
        return None
    if value.startswith("file:"):
        try:
            with open(value[5:], "r", encoding="utf-8") as f:
                return f.read().strip() or None
        except OSError:
            return None
    return value

#: Optional pass families the ladder drops, by level.  Both only ever
#: prove keys early (witness/accelerator tiers); the exact tiers they
#: defer to are sound, so browning out trades latency, never truth.
LEVEL_DROPS = {1: ("stream",), 2: ("stream", "batched")}


class BrownoutController:
    """Hysteresis ladder over sustained pressure samples.

    ``sample(queue_depth, rss_mb)`` is called once per scheduler loop
    iteration.  Pressure at tier N means queue depth >= queue_high *
    2**(N-1) or RSS >= rss_high_mb * (1 + 0.25*(N-1)).  `up_count`
    consecutive samples at or above the next tier escalate one level;
    `down_count` consecutive samples below the current tier
    de-escalate.  Transitions are recorded via degrade.record and the
    current level is exported as the
    ``checkerd.overload.brownout-level`` gauge.
    """

    def __init__(self, *, queue_high: float = 32.0,
                 rss_high_mb: Optional[float] = 8192.0,
                 up_count: int = 3, down_count: int = 6,
                 max_level: int = 2):
        self.queue_high = float(queue_high)
        self.rss_high_mb = rss_high_mb
        self.up_count = max(1, int(up_count))
        self.down_count = max(1, int(down_count))
        self.max_level = int(max_level)
        self._lock = threading.Lock()
        self._level = 0
        self._above = 0
        self._below = 0
        self.transitions = 0

    @property
    def level(self) -> int:
        forced = _env_indirect(os.environ.get(FORCE_ENV))
        if forced:
            try:
                return max(0, min(self.max_level, int(forced)))
            except ValueError:
                pass
        with self._lock:
            return self._level

    def dropped_passes(self) -> tuple:
        """Plan pass ids the current level drops (plan/compiler.py
        consults this when building cohort/packs plans)."""
        return LEVEL_DROPS.get(self.level, ())

    def _pressure_tier(self, queue_depth: float,
                       rss_mb: Optional[float]) -> int:
        tier = 0
        for n in range(1, self.max_level + 1):
            hot = queue_depth >= self.queue_high * (2 ** (n - 1))
            if (not hot and rss_mb is not None
                    and self.rss_high_mb is not None):
                hot = rss_mb >= self.rss_high_mb * (1 + 0.25 * (n - 1))
            if hot:
                tier = n
        return tier

    def sample(self, queue_depth: float,
               rss_mb: Optional[float] = None) -> int:
        """Feeds one pressure sample; returns the (possibly new) level."""
        from ..ops import degrade

        tier = self._pressure_tier(queue_depth, rss_mb)
        with self._lock:
            level = self._level
            if tier > level:
                self._above += 1
                self._below = 0
                if self._above >= self.up_count:
                    self._level = min(level + 1, self.max_level)
                    self._above = 0
            elif tier < level:
                self._below += 1
                self._above = 0
                if self._below >= self.down_count:
                    self._level = max(level - 1, 0)
                    self._below = 0
            else:
                self._above = self._below = 0
            new = self._level
            changed = new != level
            if changed:
                self.transitions += 1
        if changed:
            action = (f"enter-level-{new}" if new > level
                      else f"exit-to-level-{new}")
            degrade.record("brownout", action)
            telemetry.count(f"checkerd.overload.brownout-{action}")
        telemetry.gauge("checkerd.overload.brownout-level", self.level)
        return self.level

    def shed_factor(self) -> float:
        """Multiplier on the shed estimate: a browning-out fleet sheds
        deadline'd work earlier (level 2 doubles the estimate)."""
        lvl = self.level
        return 1.0 if lvl < 2 else 2.0


#: Process-wide brownout controller — the scheduler samples it, the
#: plan compiler consults it (lazy import, no cycle), tests swap it.
_brownout = BrownoutController()
_brownout_lock = threading.Lock()


def brownout() -> BrownoutController:
    return _brownout


def set_brownout(ctrl: Optional[BrownoutController]) -> BrownoutController:
    """Installs a controller (None = a fresh default); returns it."""
    global _brownout
    with _brownout_lock:
        _brownout = ctrl if ctrl is not None else BrownoutController()
        return _brownout


def brownout_level() -> int:
    return _brownout.level


def dropped_passes() -> tuple:
    return _brownout.dropped_passes()


def process_rss_mb() -> Optional[float]:
    """Current RSS in MiB from /proc (Linux; None elsewhere) — the
    brownout ladder's memory gauge."""
    try:
        with open("/proc/self/statm", "rb") as f:
            fields = f.read().split()
        pages = int(fields[1])
        return pages * (os.sysconf("SC_PAGE_SIZE") / (1024.0 * 1024.0))
    except (OSError, IndexError, ValueError):
        return None


# ---------------------------------------------------------------------------
# Client-side circuit breakers
# ---------------------------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"


class CircuitBreaker:
    """Per-address circuit breaker with jittered exponential backoff.

    closed -> open after `failure_threshold` consecutive failures;
    open -> half-open once the backoff expires (one probe allowed);
    half-open -> closed on success, -> open (longer backoff) on
    failure.  `clock` and `rng` are injectable for deterministic tests.
    """

    def __init__(self, *, failure_threshold: int = 3,
                 base_backoff_s: float = 0.5,
                 max_backoff_s: float = 30.0,
                 jitter: float = 0.25,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Callable[[], float] = random.random):
        self.failure_threshold = max(1, int(failure_threshold))
        self.base_backoff_s = float(base_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self._clock = clock
        self._rng = rng
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opens = 0
        self._open_until = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            if (self._state == OPEN
                    and self._clock() >= self._open_until):
                return HALF_OPEN
            return self._state

    def _backoff_s(self) -> float:
        b = min(self.max_backoff_s,
                self.base_backoff_s * (2 ** max(0, self._opens - 1)))
        return b * (1.0 + self.jitter * (2.0 * self._rng() - 1.0))

    def allow(self) -> bool:
        """Whether a call may be attempted now.  In half-open exactly
        one caller gets True (the probe) until it reports back."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._clock() < self._open_until:
                return False
            if self._probing:
                return False
            self._state = HALF_OPEN
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            was = self._state
            self._state = CLOSED
            self._failures = 0
            self._opens = 0
            self._probing = False
        if was != CLOSED:
            telemetry.count("checkerd.overload.breaker-closed")

    def record_failure(self) -> None:
        with self._lock:
            self._probing = False
            if self._state == HALF_OPEN:
                self._opens += 1
                self._state = OPEN
                self._open_until = self._clock() + self._backoff_s()
                opened = True
            else:
                self._failures += 1
                if (self._state == CLOSED
                        and self._failures >= self.failure_threshold):
                    self._opens += 1
                    self._state = OPEN
                    self._open_until = self._clock() + self._backoff_s()
                    opened = True
                else:
                    opened = False
        if opened:
            telemetry.count("checkerd.overload.breaker-opened")

    def stats(self) -> dict:
        with self._lock:
            return {"state": self._state, "failures": self._failures,
                    "opens": self._opens}


_breakers: dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker_for(addr: str) -> CircuitBreaker:
    """The process-wide breaker for one daemon address."""
    with _breakers_lock:
        b = _breakers.get(addr)
        if b is None:
            b = _breakers[addr] = CircuitBreaker()
        return b


def reset_breakers() -> None:
    with _breakers_lock:
        _breakers.clear()
