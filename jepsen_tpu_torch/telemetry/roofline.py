"""Roofline accounting: per-pass FLOP/byte cost against device peaks.

The port's copy of `jepsen_tpu/telemetry/roofline.py`.  The reference
reads XLA's cost analysis off each jitted call (`instrument`); PyTorch
runs eagerly and reports no cost, so the port counts instead: one cost
function per device call site the reference instruments, each
returning `{flops, bytes_accessed, transcendentals}` from the call's
shapes and inputs.  Each call site hands its cost to
`profile.note_cost`, only while a profile capture is listening
(`profile.cost_hooked`), so an unprofiled check pays nothing.  The
counts read the same work whatever implements it (the CUDA sweep kernel
or the plain PyTorch version), so the cost model and a benchmark's
roofline share compare like with like.

Counting rules, shared by every function here: each input is read once
and each output written once (bytes at their stored width: bool 1,
int32 4, bfloat16 2, float32 4); where the work depends on the data (a
sweep that dies early, a BFS that stops at a level) the count is what
this call's data needs.  "flops" counts the call's elementwise and
matrix operations as stated per function (integer selects and compares
count as operations; a matrix product 2 per multiply-add).

  * `sweep_cost`        — the witness sweep kernel (the reference's
                          instrumented chunk, wgl_witness.py:872/947);
  * `chain_round_cost`  — one chain round of `_Block.heavy`;
  * `bfs_level_cost`    — one frontier-BFS level (wgl.py:297);
  * `packed_level_cost` — one packed frontier-BFS level, counted from
                          its live rows (wgl.py:145);
  * `batched_level_cost`— one batched-BFS level over K keys
                          (wgl_batched.py:297);
  * `closure_cost`      — the Elle closure screen (scc.py:102-110);
  * `extract_cost`      — the witness-cycle extraction (scc.py:209):
                          its closure and its BFS levels.

The peak registry keeps the reference's TPU generations, so its records
still annotate, and adds the H100 SXM (989 TFLOP/s dense bf16, 3.35
TB/s; NVIDIA's data sheet) matched on the CUDA device name.  An unknown
CUDA device gets the reference's calibration probe run on that device
(a bf16 matmul and a device copy), cached on disk; a CPU gets the
reference's numpy probe.  `annotate`, `export_gauges` and `summarize`
are the reference's.  Everything here is advisory: an unknown device or
a cache write error degrades to explicit nulls, never a dropped record
or a changed verdict.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from pathlib import Path
from typing import Any, Optional, Sequence

from . import enabled as _enabled
from . import gauge as _gauge

log = logging.getLogger(__name__)

#: Cost keys every record carries (explicit None when unknown).
COST_KEYS = ("flops", "bytes_accessed", "transcendentals")

#: Roofline keys `annotate` emits (explicit None when underivable).
ROOFLINE_KEYS = (
    "achieved_flops_per_s", "achieved_bytes_per_s",
    "arithmetic_intensity", "flops_ratio", "bandwidth_ratio",
    "knee_intensity", "bound",
)

#: Peak FLOP/s and HBM bytes/s by TPU generation, matched as a
#: substring of the record's device_kind (the reference's registry).
TPU_PEAKS = (
    # (kind substring, peak_flops_per_s, peak_bytes_per_s)
    ("v6", 918e12, 1640e9),
    ("v5p", 459e12, 2765e9),
    ("v5e", 197e12, 819e9),
    ("v5 lite", 197e12, 819e9),
    ("v4", 275e12, 1228e9),
    ("v3", 123e12, 900e9),
    ("v2", 45e12, 700e9),
)

#: H100 SXM peaks (NVIDIA's data sheet: dense bf16 tensor-core rate and
#: HBM3 bandwidth, at the 700 W power limit), matched as a substring of
#: torch.cuda.get_device_name, lower-cased.
H100_FLOPS_PER_S = 989e12
H100_BYTES_PER_S = 3.35e12
GPU_PEAKS = (
    ("h100 80gb hbm3", H100_FLOPS_PER_S, H100_BYTES_PER_S),
    ("h100 sxm", H100_FLOPS_PER_S, H100_BYTES_PER_S),
)

#: On-disk cache of calibrated peaks (one file per device kind; empty
#: string disables the disk), by default under the repository's
#: build directory.
CACHE_ENV = "JEPSEN_ROOFLINE_CACHE"
_DEFAULT_CACHE_DIR = (Path(__file__).resolve().parents[2] / "build"
                      / "jepsen_tpu_torch" / "roofline")

_lock = threading.Lock()
_calibrated: dict[str, dict] = {}  # device kind -> peaks (process memo)

# ------------------------------------------------------------------ cost


def _cost(flops: float, n_bytes: float) -> dict:
    return {"flops": float(flops), "bytes_accessed": float(n_bytes),
            "transcendentals": 0.0}


def sweep_bytes(start_k: int, death: int, K: int, cols: Sequence[int],
                B: int, SW: int) -> int:
    """Bytes the sweep must move for this input: the bars columns it
    reads (start_k .. death, 5 int32 words each: window column, real,
    f, a0, a1; the ret row is never read), each distinct member row
    those barriers name (B bool bytes), the states (int32) and alive
    (bool) read once, the outputs written once, and the death word."""
    last = min(death, K - 1)
    n = max(0, last - start_k + 1)
    distinct = len(set(cols[start_k:last + 1])) if n else 0
    return 4 * 5 * n + B * distinct + 2 * (4 * SW * B + B) + 4


def sweep_cost(start_k: int, death: int, K: int, cols: Sequence[int],
               B: int, SW: int, stream: bool = False) -> dict:
    """One sweep call (`ops.wgl_witness.sweep`): `sweep_bytes`, plus the
    (SW,) initial state a stream sweep reads; operations: per barrier
    swept and beam lane, one legality test and one select per state
    word."""
    last = min(death, K - 1)
    n = max(0, last - start_k + 1)
    nbytes = sweep_bytes(start_k, death, K, cols, B, SW)
    return _cost(n * B * (SW + 1), nbytes + (4 * SW if stream else 0))


def chain_round_cost(W: int, R: int, B: int, SW: int) -> dict:
    """One chain round of `_Block.heavy` over a (W, B) window with an
    R-row candidate tile: reads the member window (W x B bool), the
    beam states and alive mask, the R helper rows' f/a0/a1 (int32), and
    writes the next member window, states and alive.  Operations: the
    direct step (B lanes), the helper step and the barrier step of each
    (helper, lane) pair (2 R B), each a legality test and SW selects,
    and the children's float32 state hash (a multiply-add per word:
    2 R B SW)."""
    nbytes = 2 * (W * B + 4 * B * SW + B) + 12 * R
    steps = (B + 2 * R * B) * (SW + 1)
    return _cost(steps + 2 * R * B * SW, nbytes)


def bfs_level_cost(W: int, B: int, SW: int, n_slots: int) -> dict:
    """One frontier-BFS level (`ops.wgl._expand_level` and its dedup)
    over B configurations of a W-op window with `n_slots` candidate ops
    each: reads the configurations (W x B bool, B x SW int32, B alive)
    and the window's ops (inv, ret, f, a0, a1: 5 x 4 W bytes), writes
    the next level's configurations.  Operations: each (configuration,
    candidate) child's model step (a legality test and SW selects), and
    its two float32 hashes over its W member bits and SW state words (a
    multiply-add each)."""
    children = B * n_slots
    nbytes = 2 * (W * B + 4 * B * SW + B) + 20 * W
    return _cost(children * (SW + 1) + children * 2 * 2 * (W + SW), nbytes)


def packed_level_cost(W: int, SW: int, rows_in: int, children: int,
                      rows_out: int) -> dict:
    """One packed frontier-BFS level (`ops.wgl._expand_level_packed`
    and its dedup) as this level's data needs it: reads the `rows_in`
    live configurations and writes the `rows_out` kept ones (each
    ceil(W / 32) int32 member words, SW int32 state words and an alive
    byte), and reads the window's ops (5 x 4 W bytes).  Operations: each
    of the `children` live children's model step (a legality test and
    SW selects) and its two uint32 hashes over its member and state
    words (a multiply-add each)."""
    words = -(-W // 32)
    row = 4 * words + 4 * SW + 1
    return _cost(children * (SW + 1 + 2 * 2 * (words + SW)),
                 (rows_in + rows_out) * row + 20 * W)


def batched_level_cost(K: int, W: int, B: int, SW: int,
                       n_slots: int) -> dict:
    """One batched-BFS level (`ops.wgl_batched`): `bfs_level_cost` for
    each of the K keys' frontiers."""
    one = bfs_level_cost(W, B, SW, n_slots)
    return _cost(K * one["flops"], K * one["bytes_accessed"])


def closure_steps(V: int) -> int:
    """Squarings of a V-vertex closure, ceil(log2 V) (at least 1): each
    doubles the path length covered.  `ops.scc` runs this many, so the
    count exists once."""
    return max(1, math.ceil(math.log2(max(V, 2))))


def closure_ops(K: int, V: int) -> float:
    """Floating-point operations of one closure: ceil(log2 V) batched
    V x V products, 2 V^3 each per graph."""
    return closure_steps(V) * 2.0 * K * V ** 3


def closure_cost(K: int, V: int) -> dict:
    """The Elle closure screen (`ops.scc.has_cycle`) on K graphs of V
    vertices: reads the (K, V, V) bool adjacency, writes K flags;
    `closure_ops` operations."""
    return _cost(closure_ops(K, V), K * V * V + K)


def extract_cost(K: int, V: int, graph_levels: int) -> dict:
    """The witness-cycle extraction (`ops.scc.extract_batch`) over K
    graphs of V vertices whose BFS ran `graph_levels` graph-levels in
    all: the closure, and per graph-level a (V, V) vector-matrix step
    (2 V^2 operations); reads the two (K, V, V) bool adjacencies (all
    edges, required edges), writes per graph the found flag, u, v, the
    SCC size and V parent pointers (int32)."""
    return _cost(closure_ops(K, V) + graph_levels * 2.0 * V * V,
                 2 * K * V * V + 4 * K * (V + 4))


def bound(ops: float, n_bytes: float,
          peak_flops_per_s: float = H100_FLOPS_PER_S,
          peak_bytes_per_s: float = H100_BYTES_PER_S) -> tuple:
    """(bound ms, "operations" or "bytes"): the least time the card can
    take, the larger of the operations at the peak rate and the bytes
    at the memory rate (the H100's by default)."""
    t_ops = ops / peak_flops_per_s * 1e3
    t_bytes = n_bytes / peak_bytes_per_s * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# --------------------------------------------------------------- peaks


def _cache_path(kind: str) -> Optional[str]:
    """The calibration cache file of one device kind: JEPSEN_ROOFLINE_
    CACHE names a directory (empty string disables the disk)."""
    d = os.environ.get(CACHE_ENV)
    if d == "":
        return None
    safe = "".join(c if c.isalnum() else "_" for c in kind.lower())
    return os.path.join(d or str(_DEFAULT_CACHE_DIR), f"roofline_{safe}.json")


def _calibrate_cpu_probe() -> dict:
    """One tiny matmul + memcpy probe: measured CPU peak FLOP/s and
    bytes/s for the roofline denominator.  ~100ms once per machine."""
    import numpy as np

    n = 256
    a = np.random.default_rng(0).random((n, n), dtype=np.float32)
    b = a.copy()
    best_flops = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        a @ b
        dt = time.perf_counter() - t0
        if dt > 0:
            best_flops = max(best_flops, 2.0 * n * n * n / dt)
    buf = np.zeros(4 << 20, dtype=np.uint8)
    best_bw = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        buf.copy()
        dt = time.perf_counter() - t0
        if dt > 0:
            best_bw = max(best_bw, 2.0 * buf.nbytes / dt)
    return {
        "peak_flops_per_s": best_flops or None,
        "peak_bytes_per_s": best_bw or None,
        "source": "cpu-calibrated",
        "calibrated_at": time.time(),
    }


def _calibrate_cuda_probe(kind: str) -> dict:
    """The reference's probe, on the card: the best of three 4096^3
    bfloat16 matmuls (FLOP/s) and of three 256 MiB device copies (bytes
    read and written per second), timed with CUDA events."""
    import torch

    dev = torch.device("cuda")
    n = 4096
    a = torch.randn((n, n), device=dev, dtype=torch.bfloat16)
    buf = torch.empty(256 << 20, device=dev, dtype=torch.uint8)

    def best(fn, work: float) -> float:
        fn()
        torch.cuda.synchronize(dev)
        rate = 0.0
        for _ in range(3):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            torch.cuda.synchronize(dev)
            ms = t0.elapsed_time(t1)
            if ms > 0:
                rate = max(rate, work / (ms / 1e3))
        return rate

    flops = best(lambda: a @ a, 2.0 * n ** 3)
    bw = best(lambda: buf.clone(), 2.0 * buf.numel())
    return {"peak_flops_per_s": flops or None, "peak_bytes_per_s": bw or None,
            "source": "gpu-calibrated", "device_kind": kind,
            "calibrated_at": time.time()}


def _calibrate(kind: str, probe, force: bool = False) -> dict:
    """Calibrated peaks of one device kind: process memo -> disk cache
    -> run `probe` (then persist both).  `force` re-measures."""
    with _lock:
        if kind in _calibrated and not force:
            return dict(_calibrated[kind])
    path = _cache_path(kind)
    if path and not force:
        try:
            with open(path) as f:
                got = json.load(f)
            if isinstance(got, dict) and got.get("peak_flops_per_s"):
                with _lock:
                    _calibrated[kind] = got
                return dict(got)
        except (OSError, ValueError):
            pass
    peaks = probe()
    with _lock:
        _calibrated[kind] = peaks
    if path:
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(peaks, f)
            os.replace(tmp, path)
        except OSError:
            pass
    return dict(peaks)


def calibrate_cpu(force: bool = False) -> dict:
    """The calibrated CPU peaks (the reference's numpy probe)."""
    return _calibrate("cpu", _calibrate_cpu_probe, force)


def calibrate_cuda(kind: str, force: bool = False) -> dict:
    """The calibrated peaks of a CUDA device the registry does not know,
    measured on the current card."""
    return _calibrate(kind, lambda: _calibrate_cuda_probe(kind), force)


def peaks_for_device(device: Optional[dict]) -> dict:
    """{peak_flops_per_s, peak_bytes_per_s, source} for a record's
    `device` block.  TPU -> the reference's generation registry by
    device_kind substring; GPU -> the H100 entry by name, else the
    device's calibration probe; CPU -> the calibrated numpy probe;
    anything else -> nulls."""
    null = {"peak_flops_per_s": None, "peak_bytes_per_s": None,
            "source": None}
    if not isinstance(device, dict):
        return null
    platform = (device.get("platform") or "").lower()
    if platform == "tpu":
        kind = (device.get("device_kind") or "").lower()
        for sub, flops, bw in TPU_PEAKS:
            if sub in kind:
                return {"peak_flops_per_s": flops,
                        "peak_bytes_per_s": bw,
                        "source": f"tpu-registry:{sub}"}
        return null
    if platform == "gpu":
        kind = (device.get("device_kind") or "").lower()
        for sub, flops, bw in GPU_PEAKS:
            if sub in kind:
                return {"peak_flops_per_s": flops,
                        "peak_bytes_per_s": bw,
                        "source": f"gpu-registry:{sub}"}
        if not kind:
            return null
        try:
            got = calibrate_cuda(kind)
        except Exception:  # noqa: BLE001 — the probe must fail open
            return null
        return {"peak_flops_per_s": got.get("peak_flops_per_s"),
                "peak_bytes_per_s": got.get("peak_bytes_per_s"),
                "source": got.get("source", "gpu-calibrated")}
    if platform == "cpu":
        try:
            got = calibrate_cpu()
        except Exception:  # noqa: BLE001 — numpy probe must fail open
            return null
        return {"peak_flops_per_s": got.get("peak_flops_per_s"),
                "peak_bytes_per_s": got.get("peak_bytes_per_s"),
                "source": got.get("source", "cpu-calibrated")}
    return null


# ------------------------------------------------------------ annotate


def _num(v: Any) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) else None


def _sig(v: float) -> float:
    """6 significant figures: decimal-place rounding flattens
    achieved/peak ratios (25 B/s over a 1.2 TB/s peak is 2e-11 — zero
    at round(_, 9)) while keeping the JSON short."""
    return float(f"{v:.6g}")


def annotate(timing: Optional[dict], cost: Optional[dict],
             device: Optional[dict] = None) -> dict:
    """The record's `roofline` block: achieved rates, intensity, and
    position against the device peaks.  Every underivable field is an
    explicit None so consumers index without KeyError."""
    out: dict[str, Any] = {k: None for k in ROOFLINE_KEYS}
    peaks = peaks_for_device(device)
    pf = _num(peaks.get("peak_flops_per_s"))
    pb = _num(peaks.get("peak_bytes_per_s"))
    out["peak_flops_per_s"] = pf
    out["peak_bytes_per_s"] = pb
    out["peak_source"] = peaks.get("source")
    if pf and pb:
        out["knee_intensity"] = round(pf / pb, 4)
    ex = _num((timing or {}).get("execute_s"))
    flops = _num((cost or {}).get("flops"))
    byt = _num((cost or {}).get("bytes_accessed"))
    if ex and ex > 0:
        if flops is not None:
            out["achieved_flops_per_s"] = round(flops / ex, 3)
        if byt is not None:
            out["achieved_bytes_per_s"] = round(byt / ex, 3)
    if flops is not None and byt:
        out["arithmetic_intensity"] = round(flops / byt, 6)
    if out["achieved_flops_per_s"] is not None and pf:
        out["flops_ratio"] = _sig(out["achieved_flops_per_s"] / pf)
    if out["achieved_bytes_per_s"] is not None and pb:
        out["bandwidth_ratio"] = _sig(out["achieved_bytes_per_s"] / pb)
    ai, knee = out["arithmetic_intensity"], out["knee_intensity"]
    if ai is not None and knee is not None:
        out["bound"] = "compute" if ai >= knee else "memory"
    return out


def export_gauges(record: dict) -> None:
    """Publishes one record's roofline numbers as wgl.roofline.* gauges
    (pass-scoped), so /metrics scrapes carry the latest achieved-vs-
    peak position per pass with zero extra plumbing."""
    if not _enabled():
        return
    name = record.get("pass") or "unknown"
    roof = record.get("roofline")
    cost = record.get("cost")
    if not isinstance(roof, dict):
        return
    for key in ("achieved_flops_per_s", "achieved_bytes_per_s",
                "arithmetic_intensity", "flops_ratio",
                "bandwidth_ratio"):
        v = roof.get(key)
        if isinstance(v, (int, float)):
            _gauge(f"wgl.roofline.{name}.{key}", v)
    if isinstance(cost, dict):
        for key in ("flops", "bytes_accessed"):
            v = cost.get(key)
            if isinstance(v, (int, float)):
                _gauge(f"wgl.roofline.{name}.{key}", v)


# ------------------------------------------------------------ summarize


def _median(vals: list[float]) -> Optional[float]:
    if not vals:
        return None
    vals = sorted(vals)
    n = len(vals)
    mid = n // 2
    if n % 2:
        return vals[mid]
    return (vals[mid - 1] + vals[mid]) / 2.0


def summarize(records: list[dict]) -> dict:
    """Per-pass roofline aggregate over normalized records: medians of
    the achieved/ratio fields, the consensus bound, and coverage (how
    many records actually carried cost numbers) — the shape the
    checkerd STATS block, /fleet panel, and bench JSON all share."""
    by_pass: dict[str, dict[str, list]] = {}
    for rec in records:
        name = rec.get("pass") or "unknown"
        slot = by_pass.setdefault(name, {
            "n": [], "execute_s": [], "flops": [], "bytes_accessed": [],
            "achieved_flops_per_s": [], "achieved_bytes_per_s": [],
            "arithmetic_intensity": [], "flops_ratio": [],
            "bandwidth_ratio": [], "bound": [], "knee": [],
        })
        slot["n"].append(1)
        cost = rec.get("cost") if isinstance(rec.get("cost"), dict) \
            else {}
        roof = rec.get("roofline") \
            if isinstance(rec.get("roofline"), dict) else {}
        ex = _num((rec.get("timing") or {}).get("execute_s"))
        if ex is not None:
            slot["execute_s"].append(ex)
        for key in ("flops", "bytes_accessed"):
            v = _num(cost.get(key))
            if v is not None:
                slot[key].append(v)
        for key in ("achieved_flops_per_s", "achieved_bytes_per_s",
                    "arithmetic_intensity", "flops_ratio",
                    "bandwidth_ratio"):
            v = _num(roof.get(key))
            if v is not None:
                slot[key].append(v)
        if roof.get("bound") in ("compute", "memory"):
            slot["bound"].append(roof["bound"])
        v = _num(roof.get("knee_intensity"))
        if v is not None:
            slot["knee"].append(v)
    out: dict[str, dict] = {}
    for name, slot in sorted(by_pass.items()):
        bound = None
        if slot["bound"]:
            bound = max(set(slot["bound"]), key=slot["bound"].count)
        out[name] = {
            "n": len(slot["n"]),
            "with_cost": len(slot["flops"]),
            "median_execute_s": _median(slot["execute_s"]),
            "median_flops": _median(slot["flops"]),
            "median_bytes_accessed": _median(slot["bytes_accessed"]),
            "median_achieved_flops_per_s":
                _median(slot["achieved_flops_per_s"]),
            "median_achieved_bytes_per_s":
                _median(slot["achieved_bytes_per_s"]),
            "median_arithmetic_intensity":
                _median(slot["arithmetic_intensity"]),
            "median_flops_ratio": _median(slot["flops_ratio"]),
            "median_bandwidth_ratio": _median(slot["bandwidth_ratio"]),
            "knee_intensity": _median(slot["knee"]),
            "bound": bound,
        }
    return out
