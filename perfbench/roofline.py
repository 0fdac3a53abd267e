"""The bytes a sweep kernel launch needs, and the card's published
bandwidth.

`sweep_bytes` is a frozen copy of the port's
`telemetry/roofline.sweep_bytes` (a test holds the two equal), so a
later change to the port's arithmetic cannot move the yardstick.  The
sweep's operations (one legality test and one select per barrier, lane
and state word) sit four orders of magnitude under the card's compute
peak for these bytes, so the bytes bound the least time.  The peak is
the data sheet's, never a calibration.
"""

from __future__ import annotations

from typing import Optional, Sequence

#: HBM bytes/s by the name `torch.cuda.get_device_name` gives, from
#: NVIDIA's data sheet (H100 SXM5 80 GB: 3.35 TB/s at the 700 W
#: limit).
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


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


def launch_bytes(start_k: int, death: int, K: int, cols: Sequence[int],
                 B: int, SW: int, stream: bool) -> int:
    """`sweep_bytes`, plus the (SW,) int32 initial state that a stream
    launch reads (the port's `sweep_cost`)."""
    return sweep_bytes(start_k, death, K, cols, B, SW) + (4 * SW if stream
                                                          else 0)


def peak_bytes_per_s(device_name: str) -> Optional[float]:
    return PEAK_BYTES_PER_S.get(device_name)
