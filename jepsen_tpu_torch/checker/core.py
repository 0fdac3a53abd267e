"""The checker protocol, validity merging and `check_safe`.

The port's copy of the parts of `jepsen_tpu/checker/core.py` the
many-key checker uses (the reference's checker.clj:34-90).  Results are
plain dicts with a "valid" key: True, False or "unknown", merged with
false > unknown > true.

`check_safe` differs from the reference in one way: a device fault (a
kernel that did not build or launch, CUDA asked for and missing, a CUDA
error; `ops.degrade.is_device_fault`) propagates instead of becoming an
"unknown" verdict, so a run meant for the card cannot hide a failing
card or kernel.  Each call is a `checker.<Name>` telemetry span, as in
the reference, and its wall-clock budget (`budget_s`, or the test's
"checker_budget") turns a checker that runs past it into "unknown",
noted in the flight recorder, which dumps a postmortem.
"""

from __future__ import annotations

import traceback
from typing import Any, Iterable, Optional

from .. import telemetry
from ..history.core import History
from ..ops import degrade
from ..telemetry import flight

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


def checker_name(c: Any) -> str:
    """A checker's span label: its `name` attribute or its class name."""
    n = getattr(c, "name", None)
    return n if isinstance(n, str) and n else type(c).__name__


#: Sentinel distinguishing "budget expired" from any checker result.
_BUDGET_BLOWN = object()


def check_safe(c: Checker, test: dict, history: History,
               opts: Optional[dict] = None, *,
               budget_s: Optional[float] = None) -> dict:
    """`c.check`, with any exception but a device fault turned into a
    {"valid": "unknown"} result (checker.clj:79-90).  With a budget
    (`budget_s`, by default `test["checker_budget"]` in seconds) the
    check runs in a watchdog thread (`utils.timeout`) and is abandoned
    when it expires: the verdict is "unknown", never a guess.  A checker
    that supervises its own children (`supervises_children`, e.g. the
    checker daemon's client) is exempt, as in the reference."""
    if budget_s is None:
        budget_s = (test or {}).get("checker_budget")
    if budget_s is not None and getattr(c, "supervises_children", False):
        budget_s = None

    def go() -> dict:
        if telemetry.enabled():
            with telemetry.span(f"checker.{checker_name(c)}"):
                return c.check(test, history, opts or {})
        return c.check(test, history, opts or {})

    try:
        if budget_s is None:
            return go()
        from ..utils import timeout as _timeout

        res = _timeout(budget_s * 1000.0, go, default=_BUDGET_BLOWN)
        if res is _BUDGET_BLOWN:
            telemetry.count("checker.budget-exceeded")
            flight.note("checker-budget-exceeded",
                        checker=type(c).__name__, budget_s=budget_s)
            flight.dump("checker-budget-exceeded")
            return {
                "valid": UNKNOWN,
                "error": f"checker {checker_name(c)} exceeded its "
                         f"{budget_s} s wall-clock budget "
                         f"(checker_budget); thread abandoned",
            }
        return res
    except Exception as e:  # noqa: BLE001
        if degrade.is_device_fault(e):
            raise
        return {
            "valid": UNKNOWN,
            "error": repr(e),
            "traceback": traceback.format_exc(),
        }
