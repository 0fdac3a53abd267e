"""Device resolution and host-sync accounting.

`resolve` turns an entry point's `device` argument into a
`torch.device`.  It never substitutes one device for another: asking
for CUDA where there is none raises, so a run that was meant for the
card cannot silently measure the CPU.

`host` is the one place device values come back to Python in the
search loops; it counts the reads that had to wait for the card
(`counters["host_syncs"]`), so a run can report what its host-driven
loops cost.  `count` adds to the counters under a lock: the many-key
checker runs searches from worker threads.  `exact_float32` pins
full-precision float32 products around the search's dedup hashes.
"""

from __future__ import annotations

import threading
from collections import Counter
from contextlib import contextmanager
from typing import Any, Iterator, Union

import torch

#: Event counts of the host-driven loops: "host_syncs" (device reads
#: that waited for the card), "heavy_rounds" (witness chain searches),
#: "bfs_levels" (frontier and batched BFS levels), and the many-key
#: path's "stream_passes", "stream_restarts" and "stream_keys_proven".
#: Callers reset by `.clear()`.
counters: Counter = Counter()
_counters_lock = threading.Lock()


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


@contextmanager
def exact_float32() -> Iterator[None]:
    """Float32 matrix products at full precision inside the block.

    The search paths hash configurations with float32 products and
    rely on equal configurations hashing equal; TF32 would round the
    operands to 10 mantissa bits.  PyTorch's default is already off
    (`torch.backends.cuda.matmul.allow_tf32` False); this pins it for
    the block and restores the caller's setting."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def host(t: torch.Tensor) -> Any:
    """`t` as Python scalars (`.tolist()`), counting a host sync when
    `t` lives on the card."""
    if t.device.type != "cpu":
        count("host_syncs")
    return t.tolist()
