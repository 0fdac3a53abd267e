"""The checker protocol, validity merging and `check_safe`.

The port's copy of the parts of `jepsen_tpu/checker/core.py` the
many-key checker uses (the reference's checker.clj:34-90).  Results are
plain dicts with a "valid" key: True, False or "unknown", merged with
false > unknown > true.

`check_safe` differs from the reference in one way: a device fault (a
kernel that did not build or launch, CUDA asked for and missing, a CUDA
error; `ops.degrade.is_device_fault`) propagates instead of becoming an
"unknown" verdict, so a run meant for the card cannot hide a failing
card or kernel.  The reference's wall-clock budget watchdog is left out.
"""

from __future__ import annotations

import traceback
from typing import Any, Iterable, Optional

from ..history.core import History
from ..ops import degrade

UNKNOWN = "unknown"


def valid_rank(v: Any) -> int:
    """false > unknown > true when merging (checker.clj:34-55)."""
    if v is False:
        return 0
    if v is True:
        return 2
    return 1


def merge_valid(vs: Iterable[Any]) -> Any:
    out = True
    for v in vs:
        if valid_rank(v) < valid_rank(out):
            out = v
    return out


class Checker:
    """Analyzes a history and returns {"valid": ...} plus details
    (checker.clj:57-72).  `opts` carries context such as
    "history_key"."""

    def check(self, test: dict, history: History, opts: dict) -> dict:
        raise NotImplementedError


def check_safe(c: Checker, test: dict, history: History,
               opts: Optional[dict] = None) -> dict:
    """`c.check`, with any exception but a device fault turned into a
    {"valid": "unknown"} result (checker.clj:79-90)."""
    try:
        return c.check(test, history, opts or {})
    except Exception as e:  # noqa: BLE001
        if degrade.is_device_fault(e):
            raise
        return {
            "valid": UNKNOWN,
            "error": repr(e),
            "traceback": traceback.format_exc(),
        }
