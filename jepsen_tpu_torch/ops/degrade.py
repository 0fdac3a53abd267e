"""Degradation-ladder support: classify device resource failures and
record every degradation step.

The port's copy of `is_resource_error`, `record` and `capture` from
`jepsen_tpu/ops/degrade.py`.  `is_resource_error` decides what counts
as "the device ran out, not the search" — now including CUDA's
out-of-memory errors — and `record` appends to the active capture so a
checker can put the ladder's path in its result.  A kernel that fails
to build or launch is not a resource error, even when CUDA's message
says "out of memory": it raises (`KernelBuildError`,
`KernelLaunchError`) and fails the run.  `is_device_fault` names the
errors that no layer may turn into a verdict.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import torch

from ..device import DeviceUnavailable
from .kernels import KernelBuildError, KernelLaunchError

#: Message fragments that mean "the device gave out", as opposed to a
#: bug in the search itself, matched case-insensitively.
_RESOURCE_MARKERS = (
    "resource_exhausted",
    "resource exhausted",
    "out of memory",
    "ran out of memory",
    "oom",
    "allocation failure",
    "failed to allocate",
)


def is_resource_error(e: BaseException) -> bool:
    """True when the exception is device memory exhaustion — the class
    of errors the ladder may degrade on.  Anything else (assertion,
    shape bug, kernel launch failure) must propagate."""
    if isinstance(e, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    if isinstance(e, (KeyboardInterrupt, SystemExit, KernelLaunchError)):
        return False
    msg = f"{type(e).__name__}: {e}".lower()
    return any(m in msg for m in _RESOURCE_MARKERS)


def is_device_fault(e: BaseException) -> bool:
    """True for a failure of the card or of a kernel — a kernel that did
    not build or launch, CUDA asked for and missing, or a CUDA error
    that is not a resource error.  The checkers re-raise these where
    the reference turns an exception into an "unknown" verdict."""
    if isinstance(e, (KernelBuildError, KernelLaunchError,
                      DeviceUnavailable)):
        return True
    return (isinstance(e, RuntimeError) and "CUDA error" in str(e)
            and not is_resource_error(e))


_tls = threading.local()


class capture:
    """Context manager collecting degradation events recorded on this
    thread:

        with degrade.capture() as steps:
            res = check_wgl_device(...)
        if steps:
            out["degradations"] = steps

    Captures nest: an inner capture's events are replayed into the
    outer one on exit."""

    def __enter__(self) -> list[dict]:
        self._outer = getattr(_tls, "events", None)
        _tls.events = []
        return _tls.events

    def __exit__(self, *exc) -> None:
        mine = _tls.events
        _tls.events = self._outer
        if self._outer is not None:
            self._outer.extend(mine)
        return None


def record(tier: str, action: str, error: Optional[Any] = None) -> None:
    """Records one degradation step in the active capture (if any)."""
    events = getattr(_tls, "events", None)
    if events is not None:
        ev = {"tier": tier, "action": action}
        if error is not None:
            ev["error"] = (f"{type(error).__name__}: {error}"
                           if isinstance(error, BaseException) else str(error))
        events.append(ev)
