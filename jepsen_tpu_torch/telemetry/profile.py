"""Per-pass cost profiles: the training set of the plan's cost model.

The port's copy of `jepsen_tpu/telemetry/profile.py`.  Every checking
pass (witness / stream / frontier / batched / BFS / settle / exact-CPU)
runs under `capture()`, which assembles one record — history-shape
features, plan knobs, the measured execute time, the device it ran on
and the outcome — and appends it to a crash-safe JSONL store
(`set_store`).  `append` opens, appends and closes one line per record,
so a kill mid-run loses at most the line being written; `read` skips
torn lines.

Record schema (`SCHEMA_VERSION` 2, the reference's):

    {"v", "ts", "trace_id", "pass", "features": {...},
     "plan": {...}, "timing": {"compile_s", "execute_s", "total_s"},
     "cost": {"flops", "bytes_accessed", "transcendentals",
              "device_calls"},
     "roofline": {...},
     "device": {"platform", "device_kind", "peak_bytes"},
     "outcome", "degraded"}

`cost` sums what the pass's device calls noted (`note_cost`: the
explicit counts of telemetry/roofline.py, since the port has no XLA
cost analysis), and `roofline` places it against the device's peaks
(`roofline.annotate`).  A pass that noted no cost keeps both blocks as
explicit nulls, as the reference writes them on backends without cost
analysis.  `device` names the
card a pass ran on: {"platform": "gpu", "device_kind":
torch.cuda.get_device_name, "peak_bytes": torch.cuda's
max_memory_allocated, the high-water mark of the caching allocator}, or
platform "cpu" for a pass on CPU tensors.

Execute time rides the span taxonomy: spans ending ``.chunk`` /
``.block`` add to execute_s, ``.compile`` to compile_s, through the
per-thread span-exit hook, so a nested capture (a settle cohort running
the batched BFS) also sees its children's device time.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import Any, Iterator, Optional

from . import _pass_hook, enabled, set_pass_hook, trace_id
from . import count as _count

log = logging.getLogger(__name__)

SCHEMA_VERSION = 2

#: File name of the profile store inside a store/run directory.
PROFILE_FILE = "profiles.jsonl"

#: Span-name suffixes classified as compilation / device execution.
COMPILE_SUFFIXES = (".compile",)
EXECUTE_SUFFIXES = (".chunk", ".block")

#: Explicit-null templates: a record always carries every key, None
#: marking "this backend could not report it".
COST_NULL = {"flops": None, "bytes_accessed": None,
             "transcendentals": None, "device_calls": 0}
ROOFLINE_NULL = {
    "achieved_flops_per_s": None, "achieved_bytes_per_s": None,
    "arithmetic_intensity": None, "flops_ratio": None,
    "bandwidth_ratio": None, "knee_intensity": None, "bound": None,
    "peak_flops_per_s": None, "peak_bytes_per_s": None,
    "peak_source": None,
}
DEVICE_NULL = {"platform": None, "device_kind": None, "peak_bytes": None}

_lock = threading.Lock()
_store_path: Optional[str] = None

#: Per-thread cost hook: `capture()` installs a callback
#: `(cost: dict) -> None`; `note_cost` reports one device call to it.
_cost_hook = threading.local()


def cost_hooked() -> bool:
    """Whether a capture on this thread listens for device-call costs:
    call sites compute a cost only then, so an unprofiled check pays
    nothing for it."""
    return getattr(_cost_hook, "cb", None) is not None


def note_cost(cost: dict) -> None:
    """Reports one device call's {flops, bytes_accessed,
    transcendentals} to the active capture (no-op outside one).  A hook
    failure never changes the pass."""
    cb = getattr(_cost_hook, "cb", None)
    if cb is None:
        return
    try:
        cb(cost)
    except Exception:  # noqa: BLE001 — profiling must not raise
        log.debug("cost hook failed", exc_info=True)


def set_store(directory: Optional[str]) -> Optional[str]:
    """Points the process's profile store at
    `<directory>/profiles.jsonl` (None clears it).  Returns the path."""
    global _store_path
    with _lock:
        _store_path = (None if directory is None
                       else os.path.join(directory, PROFILE_FILE))
        return _store_path


def store_path() -> Optional[str]:
    with _lock:
        return _store_path


def append(record: dict) -> Optional[str]:
    """Appends one record line to the store.  No-op when telemetry is
    disabled or no store is set; returns the path written, else None.
    A write failure never changes a pass's outcome."""
    if not enabled():
        return None
    path = store_path()
    if path is None:
        return None
    try:
        line = json.dumps(record, sort_keys=True, default=repr)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with _lock, open(path, "a") as f:
            f.write(line + "\n")
        _count("profile.records")
        return path
    except (OSError, TypeError, ValueError) as e:
        log.warning("profile append to %s failed: %r", path, e)
        return None


def normalize(rec: dict) -> dict:
    """A raw store record coerced to the canonical v2 shape: missing or
    mistyped keys degrade to neutral values (pass -> "unknown", dicts ->
    {}, cost/roofline/device -> explicit nulls) instead of raising."""
    name = rec.get("pass")
    out = dict(rec)
    out["pass"] = name if isinstance(name, str) and name else "unknown"
    for k in ("features", "plan", "timing"):
        v = rec.get(k)
        out[k] = v if isinstance(v, dict) else {}
    timing = {}
    for k, v in out["timing"].items():
        try:
            timing[k] = float(v)
        except (TypeError, ValueError):
            continue
    out["timing"] = timing
    for k, template in (("cost", COST_NULL), ("roofline", ROOFLINE_NULL),
                        ("device", DEVICE_NULL)):
        v = rec.get(k)
        block = dict(template)
        if isinstance(v, dict):
            block.update(v)
        out[k] = block
    v = rec.get("v")
    out["v"] = v if isinstance(v, int) else 1
    return out


def read(path: str) -> list[dict]:
    """Every intact record in a profile store, normalized; torn or
    garbage lines are skipped."""
    out: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(normalize(rec))
    except OSError:
        pass
    return out


def count_records(path: Optional[str] = None) -> int:
    """Intact-record count of a store (defaults to the active one)."""
    p = path or store_path()
    return len(read(p)) if p else 0


def by_pass(path: Optional[str] = None) -> dict[str, int]:
    """{pass-name: record count} for a store."""
    p = path or store_path()
    agg: dict[str, int] = {}
    if not p:
        return agg
    for rec in read(p):
        agg[rec["pass"]] = agg.get(rec["pass"], 0) + 1
    return agg


def _device_info(device: Any) -> dict:
    """{"platform", "device_kind", "peak_bytes"} of the device a pass
    ran on (a torch.device or its name; None leaves the nulls).  Each
    field fails open on its own."""
    info: dict[str, Any] = dict(DEVICE_NULL)
    if device is None:
        return info
    try:
        import torch

        dev = torch.device(device)
    except (TypeError, ValueError, RuntimeError):
        return info
    if dev.type != "cuda":
        info["platform"] = info["device_kind"] = dev.type
        return info
    info["platform"] = "gpu"
    try:
        info["device_kind"] = torch.cuda.get_device_name(dev)
    except Exception:  # noqa: BLE001 — profiling never raises
        pass
    try:
        info["peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    except Exception:  # noqa: BLE001
        pass
    return info


class Capture:
    """The mutable record under assembly; `capture()` yields it."""

    __slots__ = ("pass_name", "features", "plan", "outcome", "degraded",
                 "device", "_compile_ns", "_execute_ns", "_t0", "_cost",
                 "_device_calls")

    def __init__(self, pass_name: str, device: Any = None):
        self.pass_name = pass_name
        self.features: dict[str, Any] = {}
        self.plan: dict[str, Any] = {}
        self.outcome: Any = None
        self.degraded: Any = None
        self.device = device
        self._compile_ns = 0
        self._execute_ns = 0
        self._cost: dict[str, float] = {}
        self._device_calls = 0
        self._t0 = time.perf_counter_ns()

    def feature(self, **kw: Any) -> None:
        self.features.update(kw)

    def knob(self, **kw: Any) -> None:
        self.plan.update(kw)

    def _on_span(self, name: str, dur_ns: int) -> None:
        if name.endswith(COMPILE_SUFFIXES):
            self._compile_ns += dur_ns
        elif name.endswith(EXECUTE_SUFFIXES):
            self._execute_ns += dur_ns

    def add_cost(self, cost: dict, n: int = 1) -> None:
        """Accumulates `n` device calls' reported cost."""
        self._device_calls += n
        for key in ("flops", "bytes_accessed", "transcendentals"):
            v = cost.get(key)
            if isinstance(v, (int, float)):
                self._cost[key] = self._cost.get(key, 0.0) + float(v) * n

    def record(self) -> dict:
        total = time.perf_counter_ns() - self._t0
        timing = {
            "compile_s": round(self._compile_ns / 1e9, 6),
            "execute_s": round(self._execute_ns / 1e9, 6),
            "total_s": round(total / 1e9, 6),
        }
        cost = dict(COST_NULL)
        cost["device_calls"] = self._device_calls
        for k, v in self._cost.items():
            cost[k] = round(v, 3)
        device = _device_info(self.device)
        roofline = dict(ROOFLINE_NULL)
        if self._cost:
            try:
                from . import roofline as _roofline

                roofline.update(_roofline.annotate(timing, cost, device))
            except Exception:  # noqa: BLE001 — the roofline block is
                # advisory; its failure must not drop the record
                log.debug("roofline annotate failed", exc_info=True)
        return {
            "v": SCHEMA_VERSION,
            "ts": time.time(),
            "trace_id": trace_id(),
            "pass": self.pass_name,
            "features": dict(self.features),
            "plan": dict(self.plan),
            "timing": timing,
            "cost": cost,
            "roofline": roofline,
            "device": device,
            "outcome": self.outcome,
            "degraded": self.degraded,
        }


#: Innermost-first stack of live captures per thread: a callee that
#: resolves a knob (the witness block chooser) records it on the record
#: its caller opened (`annotate`).
_active = threading.local()


def annotate(**knobs: Any) -> None:
    """Merges `knobs` into this thread's innermost active capture's plan
    block; a no-op outside any capture."""
    stack = getattr(_active, "stack", None)
    if stack:
        stack[-1].knob(**knobs)


@contextlib.contextmanager
def capture(pass_name: str, *, device: Any = None,
            **features: Any) -> Iterator[Capture]:
    """Profiles one checking pass on `device`: installs the span-exit
    and cost hooks (chained with an enclosing capture's), times the
    body, and appends the record on exit.  A cheap no-op when telemetry
    is disabled."""
    cap = Capture(pass_name, device)
    cap.features.update(features)
    if not enabled():
        yield cap
        return
    prev = getattr(_pass_hook, "cb", None)
    prev_cost = getattr(_cost_hook, "cb", None)

    def hook(name: str, dur_ns: int) -> None:
        cap._on_span(name, dur_ns)
        if prev is not None:
            prev(name, dur_ns)

    def cost_cb(cost: dict) -> None:
        cap.add_cost(cost)
        if prev_cost is not None:
            prev_cost(cost)

    stack = getattr(_active, "stack", None)
    if stack is None:
        stack = _active.stack = []
    set_pass_hook(hook)
    _cost_hook.cb = cost_cb
    stack.append(cap)
    try:
        yield cap
    except Exception as e:
        if cap.outcome is None:
            cap.outcome = f"error:{type(e).__name__}"
        raise
    finally:
        stack.pop()
        set_pass_hook(prev)
        _cost_hook.cb = prev_cost
        rec = cap.record()
        append(rec)
        try:
            from . import roofline as _roofline

            _roofline.export_gauges(rec)
        except Exception:  # noqa: BLE001 — gauges are side output
            log.debug("roofline gauge export failed", exc_info=True)
