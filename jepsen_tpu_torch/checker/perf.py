"""Performance graphs: latency quantiles and throughput over time.

Equivalent of jepsen/src/jepsen/checker/perf.clj
(`bucket-points` :43, `quantiles` :52, `latencies->quantiles` :64,
`invokes-by-type` :96, nemesis activity shading) and the
latency-graph/rate-graph/perf checkers (checker.clj:821-853) — rendered
with matplotlib instead of gnuplot, and bucketed with numpy instead of
host loops.
"""

from __future__ import annotations

import logging
import os
from collections import defaultdict
from typing import Any, Optional, Sequence

import numpy as np

from ..history.core import History, Op
from ..utils import nemesis_intervals
from .core import Checker

log = logging.getLogger(__name__)

DEFAULT_QUANTILES = (0.5, 0.95, 0.99, 1.0)
DT_S = 1.0  # bucket width in seconds

_TYPE_COLORS = {"ok": "#81BFFC", "info": "#FFA400", "fail": "#FF1E90"}


def points(history: History) -> dict[str, dict[Any, np.ndarray]]:
    """{type: {f: array[(t_secs, latency_ms)]}} for completed client
    ops (perf.clj:96-130)."""
    out: dict[str, dict[Any, list]] = {
        "ok": defaultdict(list),
        "info": defaultdict(list),
        "fail": defaultdict(list),
    }
    for op in history:
        if op.is_invoke or not op.is_client_op:
            continue
        inv = history.invocation(op)
        if inv is None:
            continue
        t = inv.time / 1e9
        latency_ms = (op.time - inv.time) / 1e6
        if op.type in out:
            out[op.type][op.f].append((t, latency_ms))
    return {
        typ: {f: np.asarray(v) for f, v in d.items() if v}
        for typ, d in out.items()
    }


def latencies_to_quantiles(
    pts: np.ndarray,
    qs: Sequence[float] = DEFAULT_QUANTILES,
    dt: float = DT_S,
) -> dict[float, np.ndarray]:
    """Buckets (t, latency) points into dt-wide windows and takes
    latency quantiles per window (perf.clj:43-94) — vectorized."""
    if len(pts) == 0:
        return {q: np.zeros((0, 2)) for q in qs}
    t = pts[:, 0]
    lat = pts[:, 1]
    buckets = np.floor(t / dt).astype(np.int64)
    order = np.argsort(buckets, kind="stable")
    buckets, lat = buckets[order], lat[order]
    uniq, starts = np.unique(buckets, return_index=True)
    out: dict[float, list] = {q: [] for q in qs}
    for i, b in enumerate(uniq):
        lo = starts[i]
        hi = starts[i + 1] if i + 1 < len(starts) else len(lat)
        window = lat[lo:hi]
        mid = (b + 0.5) * dt
        for q in qs:
            out[q].append((mid, float(np.quantile(window, q))))
    return {q: np.asarray(v) for q, v in out.items()}


def rates(history: History, dt: float = DT_S) -> dict[tuple, np.ndarray]:
    """{(f, type): array[(t, ops/sec)]} (perf.clj rate graphs)."""
    counts: dict[tuple, dict[int, int]] = defaultdict(lambda: defaultdict(int))
    for op in history:
        if op.is_invoke or not op.is_client_op:
            continue
        b = int(op.time / 1e9 / dt)
        counts[(op.f, op.type)][b] += 1
    out = {}
    for key, bs in counts.items():
        out[key] = np.asarray(
            [((b + 0.5) * dt, n / dt) for b, n in sorted(bs.items())]
        )
    return out


def _nemesis_spans(test: dict, history: History) -> list[tuple[float, float]]:
    spans = []
    nem_ops = [o for o in history if not o.is_client_op]
    for a, b in nemesis_intervals(nem_ops):
        t0 = a.time / 1e9 if a is not None else 0.0
        t1 = b.time / 1e9 if b is not None else (
            history[-1].time / 1e9 if len(history) else t0
        )
        spans.append((t0, t1))
    return spans


def _plot_common(ax, test: dict, history: History) -> None:
    for t0, t1 in _nemesis_spans(test, history):
        ax.axvspan(t0, t1, color="#FDD", alpha=0.5, zorder=0)
    ax.set_xlabel("time (s)")
    ax.grid(True, alpha=0.3)


def plot_latencies(test: dict, history: History, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 5))
    pts = points(history)
    for typ, by_f in pts.items():
        for f, arr in by_f.items():
            if typ == "ok":
                qs = latencies_to_quantiles(arr)
                for q, series in qs.items():
                    if len(series):
                        ax.plot(
                            series[:, 0], series[:, 1],
                            label=f"{f} q={q}", linewidth=1,
                        )
            else:
                ax.scatter(
                    arr[:, 0], arr[:, 1], s=6,
                    color=_TYPE_COLORS.get(typ),
                    label=f"{f} {typ}", alpha=0.6,
                )
    _plot_common(ax, test, history)
    ax.set_ylabel("latency (ms)")
    ax.set_yscale("log")
    ax.set_title(f"{test.get('name', 'test')} latency")
    ax.legend(fontsize=7, ncol=2)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def plot_rates(test: dict, history: History, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 5))
    for (f, typ), arr in sorted(rates(history).items(), key=lambda kv: repr(kv[0])):
        if len(arr):
            ax.plot(
                arr[:, 0], arr[:, 1],
                label=f"{f} {typ}",
                color=_TYPE_COLORS.get(typ),
                alpha=0.9, linewidth=1.2,
            )
    _plot_common(ax, test, history)
    ax.set_ylabel("throughput (ops/s)")
    ax.set_title(f"{test.get('name', 'test')} rate")
    ax.legend(fontsize=7, ncol=2)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


class LatencyGraph(Checker):
    """checker.clj:821-836."""

    def check(self, test, history, opts):
        d = opts.get("dir")
        if not d:
            return {"valid": True, "note": "no dir; skipped"}
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "latency-raw.png")
        plot_latencies(test, history, path)
        return {"valid": True, "file": path}


class RateGraph(Checker):
    """checker.clj:838-848."""

    def check(self, test, history, opts):
        d = opts.get("dir")
        if not d:
            return {"valid": True, "note": "no dir; skipped"}
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "rate.png")
        plot_rates(test, history, path)
        return {"valid": True, "file": path}


def perf() -> Checker:
    """Both graphs (checker.clj:850-853)."""
    from .core import compose

    return compose({"latency-graph": LatencyGraph(), "rate-graph": RateGraph()})
