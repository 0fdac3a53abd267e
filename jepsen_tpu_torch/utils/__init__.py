"""Host utilities: synthetic histories (`histgen`) and `bounded_pmap`."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Optional, TypeVar

T = TypeVar("T")
U = TypeVar("U")


def bounded_pmap(f: Callable[[T], U], xs: Iterable[T],
                 bound: Optional[int] = None) -> list[U]:
    """Parallel map over xs with at most `bound` concurrent threads
    (default: cpu count + 2), preserving order — the reference's
    `bounded-pmap` (jepsen_tpu/utils/__init__.py:64).  The first
    exception in order propagates."""
    xs = list(xs)
    if not xs:
        return []
    if bound is None:
        bound = (os.cpu_count() or 4) + 2
    with ThreadPoolExecutor(max_workers=bound) as pool:
        return list(pool.map(f, xs))
