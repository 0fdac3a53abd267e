"""Clock-offset plot.

Equivalent of jepsen/src/jepsen/checker/clock.clj:
collects the {"clock-offsets": {node: offset}} values that the clock
nemesis attaches to its completions (:14-35 history->datasets) and
plots per-node offsets over time.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Any

from ..history.core import History
from .core import Checker


def datasets(history: History) -> dict[Any, list[tuple[float, float]]]:
    """{node: [(t_secs, offset_secs)]} (clock.clj:14-35)."""
    out: dict[Any, list] = defaultdict(list)
    for op in history:
        v = op.value
        if isinstance(v, dict) and "clock-offsets" in v:
            t = op.time / 1e9
            for node, off in (v["clock-offsets"] or {}).items():
                try:
                    out[node].append((t, float(off)))
                except (TypeError, ValueError):
                    continue
    return dict(out)


class ClockPlot(Checker):
    def check(self, test: dict, history: History, opts: dict) -> dict:
        d = opts.get("dir")
        data = datasets(history)
        if not data:
            return {"valid": True, "note": "no clock data"}
        if not d:
            return {"valid": True, "note": "no dir; skipped"}
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(d, exist_ok=True)
        fig, ax = plt.subplots(figsize=(10, 4))
        for node, pts in sorted(data.items(), key=lambda kv: str(kv[0])):
            xs = [p[0] for p in pts]
            ys = [p[1] for p in pts]
            ax.plot(xs, ys, marker="o", markersize=3, label=str(node))
        ax.set_xlabel("time (s)")
        ax.set_ylabel("clock offset (s)")
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=8)
        path = os.path.join(d, "clock.png")
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return {"valid": True, "file": path}


def clock_plot() -> ClockPlot:
    return ClockPlot()
