"""Device resolution and host-sync accounting.

`resolve` turns an entry point's `device` argument into a
`torch.device`.  It never substitutes one device for another: asking
for CUDA where there is none raises, so a run that was meant for the
card cannot silently measure the CPU.

`local_devices` lists this process's cards for the mesh.

`host` is the one place device values come back to Python in the
search loops; it counts the reads that had to wait for the card
(`counters["host_syncs"]`), so a run can report what its host-driven
loops cost.  `count` adds to the counters under a lock: the many-key
checker runs searches from worker threads.  `exact_float32` pins
full-precision float32 products around the search's dedup hashes.

While telemetry is on, `host` also adds the nanoseconds it waited to
`counters["sync_ns"]`, and `timed(name)` adds the host nanoseconds of a
block, less those waits, to `counters[name]`.  They are counters, not
spans, for parts of a check that run thousands of times: a span each
would be a trace event each.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from contextlib import contextmanager, nullcontext
from typing import Any, Iterator, Union

import torch

from . import telemetry

#: Event counts of the host-driven loops: "host_syncs" (device reads
#: that waited for the card), "heavy_rounds" (witness chain searches,
#: one per death barrier, whatever the name says), "chain_rounds" (the
#: rounds of those searches, at most the chain depth each),
#: "bfs_levels" (frontier and batched BFS levels), the many-key
#: path's "stream_passes", "stream_restarts" and "stream_keys_proven",
#: online checking's "online_advances", "online_chunks",
#: "frontier_deaths", "online_rechecks" and "online_consumed", and the
#: Elle cycle search's "scc_screens", "scc_extractions",
#: "scc_bfs_levels" and "scc_bfs_graph_levels" (ops/scc.py).  With
#: telemetry on, host nanoseconds besides: "sync_ns" (waiting in
#: `host`) and the witness's "sweep_ns" and "chain_ns"
#: (ops/wgl_witness.py, through `timed`).  Process-wide: callers reset
#: by `.clear()`.
counters: Counter = Counter()
_counters_lock = threading.Lock()
#: Per thread, the nanoseconds `host` has waited (telemetry on).
_waited = threading.local()


def count(name: str, n: int = 1) -> None:
    """Adds `n` to `counters[name]`."""
    with _counters_lock:
        counters[name] += n


class DeviceUnavailable(RuntimeError):
    """CUDA was asked for and torch sees no CUDA device."""


def resolve(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """The torch.device for `device`; raises DeviceUnavailable when CUDA
    is asked for but torch sees no CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def local_devices() -> list[torch.device]:
    """This process's cards, `cuda:0` .. `cuda:n-1` (empty without
    one): the one device list the mesh (parallel/mesh.py) reads."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


_tf32_lock = threading.Lock()
_tf32_depth = 0
_tf32_saved: Any = None


def _tf32_swap(value: Any) -> Any:
    """Sets the process-wide float32 matmul precision of CUDA products
    to `value` (full precision when None) and returns the setting it
    replaced.  Uses `fp32_precision` where torch has it: reading the
    legacy `allow_tf32` after a caller set the new API raises."""
    m = torch.backends.cuda.matmul
    if hasattr(m, "fp32_precision"):
        prev = m.fp32_precision
        m.fp32_precision = "ieee" if value is None else value
    else:
        prev = m.allow_tf32
        m.allow_tf32 = False if value is None else value
    return prev


@contextmanager
def exact_float32() -> Iterator[None]:
    """Float32 matrix products at full precision inside the block.

    The search paths hash configurations with float32 products and
    rely on equal configurations hashing equal; TF32 would round the
    operands to 10 mantissa bits.  The setting is process-wide and the
    many-key checker runs searches in threads, so entries are counted
    under a lock: the first thread in saves the caller's setting and
    pins full precision, the last one out restores it."""
    global _tf32_depth, _tf32_saved
    with _tf32_lock:
        if _tf32_depth == 0:
            _tf32_saved = _tf32_swap(None)
        _tf32_depth += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_depth -= 1
            if _tf32_depth == 0:
                _tf32_swap(_tf32_saved)
                _tf32_saved = None


def host(t: torch.Tensor) -> Any:
    """`t` as Python scalars (`.tolist()`), counting a host sync when
    `t` lives on the card (and, telemetry on, the wait's ns)."""
    if t.device.type == "cpu":
        return t.tolist()
    count("host_syncs")
    if not telemetry.enabled():
        return t.tolist()
    t0 = time.perf_counter_ns()
    out = t.tolist()
    ns = time.perf_counter_ns() - t0
    count("sync_ns", ns)
    _waited.ns = getattr(_waited, "ns", 0) + ns
    return out


class _Timed:
    __slots__ = ("name", "t0", "w0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self.w0 = getattr(_waited, "ns", 0)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc: Any) -> bool:
        ns = time.perf_counter_ns() - self.t0
        count(self.name, ns - (getattr(_waited, "ns", 0) - self.w0))
        return False


_UNTIMED = nullcontext()


def timed(name: str) -> Any:
    """Context manager adding the host nanoseconds of its block, less
    this thread's waits in `host` inside it, to `counters[name]` while
    telemetry is on; one shared no-op otherwise."""
    return _Timed(name) if telemetry.enabled() else _UNTIMED
