"""Elle-equivalent: transactional anomaly checking via dependency
graphs and cycle search — the port of `jepsen_tpu/checker/elle`.

`append` and `wr` provide the analyses and generators, `graph` the
host SCC/cycle machinery; the checkers here run the cycle search
through the device screen of `ops/scc.py` (the card by default) or,
with `device="off"`, on the host alone.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ... import device as _device
from ...history.core import History
from ..core import Checker
from . import graph
from .append import AppendGen, analyze as analyze_append
from .graph import DepGraph, check_cycles
from .wr import WrGen, analyze as analyze_wr

__all__ = [
    "AppendChecker",
    "AppendGen",
    "DepGraph",
    "WrChecker",
    "WrGen",
    "analyze_append",
    "analyze_wr",
    "check_cycles",
    "graph",
    "write_artifacts",
]


def _device_cycle_fn(device: Union[str, torch.device]):
    """None (host Tarjan) for "off", else the device-screened search
    (ops/scc.py check_cycles_device) on `device`: the closure screen
    settles acyclic graphs; small flagged graphs get the exact host
    layered extraction, large flagged ones extract their witness cycles
    on the device too — the same anomaly-type verdicts, but one
    certificate per layer rather than the host's one per SCC per layer.
    The reference's "auto" and "on" mean the card.  The device is
    resolved here, so a missing card raises before any analysis and
    nothing runs on the CPU unless `device` says so."""
    if device == "off":
        return None
    dev = _device.resolve("cuda" if device in ("auto", "on") else device)

    def screened(g: DepGraph):
        from ...ops.scc import check_cycles_device

        return check_cycles_device([g], device=dev)[0]

    return screened


def write_artifacts(result: dict, opts: Optional[dict],
                    subdir: str = "elle") -> None:
    """Persists an invalid analysis into the store directory the way
    elle writes its :directory artifacts (the reference's
    tests/cycle/append.clj :directory option): a JSON anomaly dump plus
    one Graphviz DOT file per reported cycle, so a human can
    `dot -Tsvg` the dependency cycle that failed the test."""
    import json
    import logging
    import os

    directory = (opts or {}).get("dir")
    if not directory or result.get("valid") is True:
        return
    try:
        out = os.path.join(directory, subdir)
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "anomalies.json"), "w") as f:
            json.dump(
                {
                    "valid": result.get("valid"),
                    "anomaly-types": result.get("anomaly-types"),
                    "anomalies": result.get("anomalies"),
                },
                f, indent=2, default=repr,
            )
        cycles = result.get("anomalies")
        if isinstance(cycles, dict):
            cycles = [c for v in cycles.values() if isinstance(v, list)
                      for c in v if isinstance(c, dict) and "cycle" in c]
        elif isinstance(cycles, list):
            cycles = [c for c in cycles
                      if isinstance(c, dict) and "cycle" in c]
        else:
            cycles = []
        for i, c in enumerate(cycles):
            lines = ["digraph cycle {"]
            for step in c.get("steps", []):
                label = ",".join(step.get("types", []))
                lines.append(
                    f'  "T{step["from"]}" -> "T{step["to"]}" '
                    f'[label="{label}"];'
                )
            lines.append("}")
            name = f"cycle-{i}-{c.get('type', 'cycle')}.dot"
            with open(os.path.join(out, name), "w") as f:
                f.write("\n".join(lines) + "\n")
    except Exception as e:
        # A side-output failure (read-only/deleted store dir, full
        # disk, or a malformed anomaly payload that json.dump / the
        # DOT writer chokes on) must never escape and turn an
        # already-computed invalid verdict into an error.
        logging.getLogger(__name__).warning(
            "could not write elle artifacts to %s: %r", directory, e
        )


class AppendChecker(Checker):
    """Checker for list-append workloads (the reference's
    tests/cycle/append.clj).  `device`: a torch device for the cycle
    screen (the card by default; "auto" and "on" mean the card), or
    "off" to keep the cycle search on the host."""

    def __init__(self, consistency_model: str = "serializable",
                 device: Union[str, torch.device] = "cuda"):
        self.consistency_model = consistency_model
        self.device = device

    def check(self, test: dict, history: History, opts: dict) -> dict:
        res = analyze_append(
            history.client_ops(),
            consistency_model=self.consistency_model,
            cycle_fn=_device_cycle_fn(self.device),
        )
        write_artifacts(res, opts, "elle-append")
        return res


class WrChecker(Checker):
    """Checker for rw-register workloads (the reference's
    tests/cycle/wr.clj).  `device` as in AppendChecker.
    `sequential_keys` opts into the declared per-key sequential-write
    version-order inference (see wr.analyze) for systems that promise
    it."""

    def __init__(self, consistency_model: str = "serializable",
                 device: Union[str, torch.device] = "cuda",
                 sequential_keys: bool = False):
        self.consistency_model = consistency_model
        self.device = device
        self.sequential_keys = sequential_keys

    def check(self, test: dict, history: History, opts: dict) -> dict:
        res = analyze_wr(
            history.client_ops(),
            consistency_model=self.consistency_model,
            cycle_fn=_device_cycle_fn(self.device),
            sequential_keys=self.sequential_keys,
        )
        write_artifacts(res, opts, "elle-wr")
        return res
