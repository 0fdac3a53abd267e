"""Degradation-ladder support: classify device resource failures,
inject them for tests, and record every degradation step.

The port's copy of `is_resource_error`, `record`, `capture` and the
fault hook (`maybe_fault`, `JEPSEN_WGL_FAULT`) of
`jepsen_tpu/ops/degrade.py`.  `is_resource_error` decides what counts
as "the device ran out, not the search" — CUDA's out-of-memory errors
and the injected fault included — and `record` emits the
`wgl.degrade.<tier>.<action>` telemetry counter and appends to the
active capture, so a checker can put the ladder's path in its result.
A kernel that fails to build or launch is not a resource error, even
when CUDA's message says "out of memory": it raises (`KernelBuildError`,
`KernelLaunchError`) and fails the run.  `is_device_fault` names the
errors that no layer may turn into a verdict.

`probe_card` stands where the reference's chip reset and probe stand,
for diagnosis only: when the card runs out of resources again after
the halved retry, the error raised carries the probe's result.  Nothing
retries on the CPU.  `check_card` is the in-process check a checker
daemon runs at start.  Both set `chip_state`, the last observed card
health that STATS, `/metrics` and the SLO engine read.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
from typing import Any, Optional

import torch

from .. import telemetry
from ..device import DeviceUnavailable
from ..telemetry import flight
from .kernels import KernelBuildError, KernelLaunchError

#: Comma-separated tier names ("witness", "device", "stream",
#: "batched"), or "all": each named tier raises a synthetic resource
#: error at its device-call site, driving the ladder on any device.
FAULT_ENV = "JEPSEN_WGL_FAULT"

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


class InjectedFault(RuntimeError):
    """Raised by `maybe_fault`: a resource error to every catch site,
    exactly like a real out-of-memory error."""


class CardExhausted(RuntimeError):
    """The card ran out of resources, and the halved retry ran out
    again or overflowed its halved beam.  `probe` holds `probe_card`'s
    result.  A device fault: no layer
    turns it into a verdict or retries it on the CPU."""

    def __init__(self, msg: str, probe: dict):
        super().__init__(f"{msg}; card probe: {probe}")
        self.probe = probe


def fault_tiers() -> set[str]:
    raw = os.environ.get(FAULT_ENV, "")
    return {t.strip() for t in raw.split(",") if t.strip()}


def maybe_fault(tier: str) -> None:
    """Raises an `InjectedFault` when JEPSEN_WGL_FAULT names this tier
    (or "all").  Reads the environment on each call, so tests toggle
    tiers without reimporting."""
    tiers = fault_tiers()
    if tier in tiers or "all" in tiers:
        raise InjectedFault(
            f"RESOURCE_EXHAUSTED: injected fault for tier {tier!r} "
            f"({FAULT_ENV}={os.environ.get(FAULT_ENV)!r})")


def is_resource_error(e: BaseException) -> bool:
    """True when the exception is device memory exhaustion — the class
    of errors the ladder may degrade on.  Anything else (assertion,
    shape bug, kernel launch failure) must propagate."""
    if isinstance(e, (MemoryError, torch.cuda.OutOfMemoryError,
                      InjectedFault)):
        return True
    if isinstance(e, (KeyboardInterrupt, SystemExit, KernelLaunchError,
                      CardExhausted)):
        return False
    msg = f"{type(e).__name__}: {e}".lower()
    return any(m in msg for m in _RESOURCE_MARKERS)


def is_device_fault(e: BaseException) -> bool:
    """True for a failure of the card or of a kernel — a kernel that did
    not build or launch, CUDA asked for and missing, or a CUDA error
    that is not a resource error.  The checkers re-raise these where
    the reference turns an exception into an "unknown" verdict."""
    if isinstance(e, (KernelBuildError, KernelLaunchError,
                      DeviceUnavailable, CardExhausted)):
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
    """Records one degradation step: a `wgl.degrade.<tier>.<action>`
    telemetry counter and an event in the active capture (if any)."""
    telemetry.count(f"wgl.degrade.{tier}.{action}")
    flight.note(f"degrade.{tier}.{action}")
    events = getattr(_tls, "events", None)
    if events is not None:
        ev = {"tier": tier, "action": action}
        if error is not None:
            ev["error"] = (f"{type(error).__name__}: {error}"
                           if isinstance(error, BaseException) else str(error))
        events.append(ev)


#: Last observed card health, one of telemetry.CHIP_HEALTH_STATES:
#: "unprobed" until `probe_card` or `check_card` runs, then "ok",
#: "wedged" (the probe hung or failed) or "absent" (no CUDA card).
_chip_state = "unprobed"


def chip_state() -> str:
    """The last observed card health (see `_chip_state`)."""
    return _chip_state


def _set_chip_state(state: str) -> None:
    global _chip_state
    _chip_state = state
    flight.note("chip-probe", state=state)


def check_card(device: Any) -> torch.device:
    """The card check a checker daemon runs at start, in process: one
    small float32 matmul on `device`, synchronized.  Sets `chip_state`
    ("ok", or "absent" and raises `DeviceUnavailable` when CUDA is asked
    for and missing).  A CPU device is checked for nothing and leaves
    the state as it was."""
    from .. import device as _device

    try:
        dev = _device.resolve(device)
    except DeviceUnavailable:
        _set_chip_state("absent")
        raise
    if dev.type == "cuda":
        x = torch.ones((8, 8), device=dev)
        got = float((x @ x).sum())
        torch.cuda.synchronize(dev)
        if got != 512.0:
            _set_chip_state("wedged")
            raise DeviceUnavailable(f"card check on {dev}: matmul gave {got}")
        _set_chip_state("ok")
    return dev


#: What `probe_card` runs in a fresh interpreter: one small float32
#: matmul on the card, synchronized, and the card's name.
_PROBE_CODE = (
    "import torch\n"
    "x = torch.ones((8, 8), device='cuda')\n"
    "torch.cuda.synchronize()\n"
    "assert float((x @ x).sum()) == 512.0\n"
    "print(torch.cuda.get_device_name(0))\n"
)


def probe_card(timeout_s: float = 60.0) -> dict:
    """Card health probe for diagnosis: one small CUDA matmul in a
    subprocess under a timeout.  Returns {"ok": bool, "name": the
    card's name or None, "detail": what happened}; never raises."""
    try:
        proc = subprocess.run([sys.executable, "-c", _PROBE_CODE],
                              timeout=timeout_s, capture_output=True,
                              text=True)
    except subprocess.TimeoutExpired:
        _set_chip_state("wedged")
        return {"ok": False, "name": None,
                "detail": f"probe timed out after {timeout_s} s"}
    except OSError as e:
        return {"ok": False, "name": None, "detail": f"probe failed: {e!r}"}
    if proc.returncode != 0:
        tail = (proc.stderr.strip().splitlines() or ["no output"])[-1]
        _set_chip_state("absent" if "CUDA" in tail or "cuda" in tail
                        else "wedged")
        return {"ok": False, "name": None,
                "detail": f"probe exit {proc.returncode}: {tail}"}
    _set_chip_state("ok")
    return {"ok": True, "name": proc.stdout.strip() or None,
            "detail": "matmul ok"}
