"""The linearizable checker, dispatching by algorithm:

  "wgl-tpu"      refutation screen, then the device search
                 (ops/wgl.py), then the exact CPU engines for anything
                 the device left unsettled (the name is the reference's
                 label, kept so results compare like for like)
  "competition"  the same, with no budget on the exact settling pass
  "wgl"/"event"  the exact CPU engines as asked
  "settle"       the many-key cohort's entry (parallel/independent.py):
                 refutation screen, then the exact CPU engine — the
                 device tiers already had their shot

Models with no packed form, histories that do not pack (an
indeterminate dequeue) and histories the model's `validate_packed`
refuses go to the host-model search ("wgl-host",
"wgl-host-unpackable").

The port of `jepsen_tpu/checker/linearizable.py`; streaming sessions
and the plan executor wait for later slices.
"""

from __future__ import annotations

import time
from typing import Optional, Union

import torch

from .. import device as _device
from ..history.core import History
from ..history.packed import pack_history
from ..models.base import Model, PackedModel
from ..ops import degrade
from .core import Checker
from .refute import check_refute
from .wgl_cpu import WGLResult, check_wgl_cpu, check_wgl_host_model
from .wgl_event import check_wgl_event

#: Budget for the exact settling pass when the device search returns
#: unknown and the checker has no configured time limit.
DEFAULT_SETTLE_BUDGET_S = 120.0

CPU_ALGORITHMS = ("wgl", "linear", "cpu", "event")
_DEVICE_ALGORITHMS = ("wgl-tpu", "competition")


class Linearizable(Checker):
    def __init__(
        self,
        model: Optional[Model] = None,
        algorithm: str = "wgl-tpu",
        *,
        beam: int = 1024,
        max_beam: int = 4096,
        block: int = 256,
        time_limit_s: Optional[float] = None,
        max_configs: int = 5_000_000,
        device: Union[str, torch.device, None] = "cuda",
    ):
        if algorithm not in CPU_ALGORITHMS + _DEVICE_ALGORITHMS + ("settle",):
            raise ValueError(f"unknown linearizability algorithm {algorithm!r}")
        self.model = model
        self.algorithm = algorithm
        self.beam = beam
        self.max_beam = max_beam
        self.block = block
        self.time_limit_s = time_limit_s
        self.max_configs = max_configs
        self.device = device

    def check(self, test: dict, history: History, opts: dict) -> dict:
        """The verdict on `history` as a result dict ("valid",
        "algorithm", ...).  Raises when the checker's device is CUDA and
        there is none."""
        dev = _device.resolve(self.device)
        model = self.model or (test or {}).get("model")
        if model is None:
            raise ValueError("linearizable checker needs a model")
        # Record every degradation step taken while checking, so the
        # result shows the path taken to the verdict.
        with degrade.capture() as steps:
            out = self._check(history, model, dev)
        if steps:
            out["degradations"] = steps
        return out

    def _check(self, history: History, model: Model,
               dev: torch.device) -> dict:
        try:
            pm = model.packed()
        except NotImplementedError:
            return self._host_fallback(history, model, "wgl-host")
        try:
            packed = pack_history(history, pm.encode)
        except ValueError:
            # Ops the packed form cannot encode soundly (e.g. an
            # indeterminate dequeue): host-model search.
            return self._host_fallback(history, model, "wgl-host-unpackable")
        if pm.validate_packed is not None:
            reason = pm.validate_packed(packed)
            if reason is not None:
                return self._host_fallback(history, model,
                                           "wgl-host-unpackable", reason)
        if self.algorithm in CPU_ALGORITHMS:
            res, engine = self._cpu_exact(packed, pm, self.algorithm)
            return self._render(res, packed, engine, pm)
        if self.algorithm == "settle":
            t0 = time.monotonic()
            ref = check_refute(packed, pm, time_limit_s=self.time_limit_s)
            if ref is not None:
                return self._render(ref, packed, "refute-screen", pm)
            remaining = None
            if self.time_limit_s is not None:
                remaining = max(
                    1.0, self.time_limit_s - (time.monotonic() - t0))
            res, engine = self._cpu_exact(packed, pm, time_limit_s=remaining)
            return self._render(res, packed, engine, pm)
        return self._device_first(packed, pm, dev)

    def _host_fallback(self, history: History, model: Model, label: str,
                       reason: Optional[str] = None) -> dict:
        res = check_wgl_host_model(history, model,
                                   max_configs=self.max_configs,
                                   time_limit_s=self.time_limit_s)
        out = self._render(res, None, label, None)
        if reason is not None:
            out["packed-fallback-reason"] = reason
        return out

    def _device_first(self, packed, pm: PackedModel, dev: torch.device) -> dict:
        """Sound refutation screens, the device search, and the exact
        CPU settling passes — one budget for the whole chain."""
        from ..ops.wgl import check_wgl_device

        t_start = time.monotonic()
        ref = check_refute(packed, pm, time_limit_s=self.time_limit_s)
        if ref is not None:
            return self._render(ref, packed, "refute-screen", pm)
        budget_left = None
        if self.time_limit_s is not None:
            budget_left = max(
                1.0, self.time_limit_s - (time.monotonic() - t_start))

        def _budget_now():
            if self.time_limit_s is None:
                return None
            return max(1.0, self.time_limit_s - (time.monotonic() - t_start))

        def _device_search(beam, max_beam, block, budget):
            return check_wgl_device(packed, pm, beam=beam, max_beam=max_beam,
                                    block=block, time_limit_s=budget,
                                    device=dev)

        try:
            res = _device_search(self.beam, self.max_beam, self.block,
                                 budget_left)
        except Exception as e:
            if not degrade.is_resource_error(e):
                raise
            # The device ran out of memory: retry the search once at half
            # size on the same device.  A second failure raises — the
            # verdict never silently moves to the CPU engines.
            degrade.record("dispatch", "retry-halved", e)
            res = _device_search(max(self.beam // 2, 64),
                                 max(self.max_beam // 2, 64),
                                 max(self.block // 2, 32), _budget_now())
        used = "wgl-tpu"
        if res.valid is False and not res.final_configs:
            # The device BFS settles the verdict but carries no
            # counterexample; re-derive final configs on the CPU for the
            # report, with what remains of the budget.
            remaining = 30.0
            if budget_left is not None:
                remaining = max(1.0, budget_left - res.elapsed_s)
            cpu, _ = self._cpu_exact(packed, pm, time_limit_s=remaining)
            if cpu.valid is False:
                res = cpu
                used = "wgl-tpu+cpu-report"
        if res.valid == "unknown":
            # Settle with the exact engine: the configured limit's
            # remainder, a default when none is set, or — under
            # "competition" — no limit at all.
            if self.algorithm == "competition":
                remaining = (None if budget_left is None
                             else max(1.0, budget_left - res.elapsed_s))
            elif budget_left is not None:
                remaining = max(1.0, budget_left - res.elapsed_s)
            else:
                remaining = DEFAULT_SETTLE_BUDGET_S
            cpu, _ = self._cpu_exact(packed, pm, time_limit_s=remaining)
            if cpu.valid != "unknown":
                res = cpu
                used = "wgl-tpu+cpu-fallback"
            else:
                budget_txt = ("unbounded" if remaining is None
                              else f"{remaining:.1f}s")
                reason = cpu.reason or res.reason or "search exhausted"
                res.reason = (f"{reason} (exact settling pass budget "
                              f"{budget_txt} also exhausted)")
        return self._render(res, packed, used, pm)

    def _cpu_exact(self, packed, pm, algorithm: str = "auto",
                   time_limit_s: Optional[float] = None):
        """The exact host search -> (result, engine label): the event
        walk with the info-class quotient when indeterminate ops are
        present, else the memoized DFS."""
        limit = self.time_limit_s if time_limit_s is None else time_limit_s
        if algorithm == "event" or (
                algorithm != "wgl" and packed.n > packed.n_ok):
            return check_wgl_event(packed, pm, max_configs=self.max_configs,
                                   time_limit_s=limit), "event"
        return check_wgl_cpu(packed, pm, max_configs=self.max_configs,
                             time_limit_s=limit), "wgl"

    def _render(self, res: WGLResult, packed, algorithm: str,
                pm: Optional[PackedModel]) -> dict:
        out = {
            "valid": res.valid,
            "algorithm": algorithm,
            "configs-explored": res.configs_explored,
            "elapsed-s": round(res.elapsed_s, 6),
        }
        if res.reason:
            out["unknown-reason"] = res.reason
        if res.valid in (False, "unknown") and res.final_configs:
            out["final-configs"] = res.final_configs[:10]
        if (res.valid is False and res.final_configs
                and res.crashed_at is not None and packed is not None):
            a = res.crashed_at
            out["crashed-op"] = {
                "history-index": int(packed.src_index[a]),
                "op": (pm.describe_op(int(packed.f[a]), int(packed.a0[a]),
                                      int(packed.a1[a]))
                       if pm.describe_op else None),
            }
        return out


def linearizable(model=None, algorithm: str = "wgl-tpu", **kw) -> Linearizable:
    return Linearizable(model, algorithm, **kw)
