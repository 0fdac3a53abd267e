"""Kafka checker artifacts: conviction trail + plots in the store dir.

The port's copy of `jepsen_tpu/workloads/kafka_viz.py`: the file names
and the JSON and DOT content are the JAX package's, so a stored run
reads the same from either package.  jepsen's kafka checker doesn't
just return data — it renders plots of unseen messages over time and
per-consumer realtime lag, and writes the version-order divergences,
into the test's store directory (tests/kafka.clj:99-180 and the
plotting code around :1300).  This module is that half for the kafka
checker, in the house style of checker/elle's write_artifacts: JSON +
DOT always, matplotlib SVG plots, every write failure swallowed so a
side-output problem can never downgrade a computed verdict.

Artifacts (under <store>/kafka/):
  anomalies.json     valid / anomaly-types / anomalies (invalid runs)
  cycle-*.dot        one Graphviz file per ww/wr dependency cycle
  version-orders.json the per-key version order for every key named in
                     an inconsistent-offsets divergence
  unseen.json        final unseen values per key + the time series
  unseen.svg         acked-but-never-polled message count over time
  realtime-lag.svg   per-process poll lag over time (version-order
                     indices behind the newest sent value — an
                     index-based analogue of the reference's
                     time-based consumer lag)
"""

from __future__ import annotations

import json
import logging
import os
from collections import defaultdict
from typing import Any, Optional

from ..history.core import History, Op
from .kafka import TXN_FS, op_reads, op_writes, version_orders, reads_by_type

log = logging.getLogger(__name__)

MAX_POINTS = 1024  # downsample plots/series beyond this


def unseen_series(ops: list[Op]) -> list[tuple[float, int]]:
    """(t_seconds, total unseen count) after each completed txn:
    acked sends not yet polled by anyone (the time-resolved version
    of kafka.unseen_final, kafka.clj:1268-1303)."""
    sent: dict[Any, set] = defaultdict(set)
    polled: dict[Any, set] = defaultdict(set)
    series: list[tuple[float, int]] = []
    unseen = 0
    for op in ops:
        if op.type != "ok" or op.f not in TXN_FS:
            continue
        for k, vs in op_writes(op).items():
            for v in vs:
                if v not in sent[k]:
                    sent[k].add(v)
                    if v not in polled[k]:
                        unseen += 1
        for k, vs in op_reads(op).items():
            for v in vs:
                if v not in polled[k]:
                    polled[k].add(v)
                    if v in sent[k]:
                        unseen -= 1
        series.append(((op.time or 0) / 1e9, unseen))
    return _downsample(series)


def lag_series(ops: list[Op], orders: Optional[dict] = None,
               ) -> dict[Any, list[tuple[float, int]]]:
    """{process: [(t_seconds, lag)]} — at each completed poll, how many
    version-order positions the polled value sits behind the newest
    value sent so far on that key; a process's point is its worst key.
    Index-based analogue of the reference's realtime consumer lag.
    `orders` accepts a precomputed version-order map so one analysis
    pass can serve every artifact."""
    if orders is None:
        orders, _ = version_orders(ops, reads_by_type(ops))
    newest: dict[Any, int] = {}
    out: dict[Any, list[tuple[float, int]]] = defaultdict(list)
    for op in ops:
        if op.type != "ok" or op.f not in TXN_FS:
            continue
        for k, vs in op_writes(op).items():
            vo = orders.get(k)
            if vo is None:
                continue
            for v in vs:
                i = vo.by_value.get(v)
                if i is not None and i > newest.get(k, -1):
                    newest[k] = i
        worst: Optional[int] = None
        for k, vs in op_reads(op).items():
            vo = orders.get(k)
            if vo is None or not vs:
                continue
            i = vo.by_value.get(vs[-1])
            if i is None:
                continue
            lag = max(0, newest.get(k, i) - i)
            worst = lag if worst is None else max(worst, lag)
        if worst is not None:
            out[op.process].append(((op.time or 0) / 1e9, worst))
    return {p: _downsample(s) for p, s in out.items()}


def _downsample(series: list) -> list:
    if len(series) <= MAX_POINTS:
        return series
    step = len(series) / MAX_POINTS
    return [series[int(i * step)] for i in range(MAX_POINTS)] + [series[-1]]


def _plot_unseen(series: list, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 3))
    if series:
        t0 = series[0][0]
        ax.step([t - t0 for t, _ in series], [u for _, u in series],
                where="post", color="#FFA400")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("unseen messages")
    ax.set_title("acked sends not yet polled")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def _plot_lag(lags: dict, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 3))
    t0 = min(
        (s[0][0] for s in lags.values() if s), default=0.0
    )
    for p, series in sorted(lags.items(), key=lambda kv: repr(kv[0])):
        ax.plot([t - t0 for t, _ in series], [v for _, v in series],
                label=f"p{p}", linewidth=1)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("poll lag (version-order positions)")
    ax.set_title("realtime lag per process")
    if lags:
        ax.legend(fontsize=7, ncols=4)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def write_artifacts(result: dict, opts: Optional[dict],
                    history: History | list[Op]) -> None:
    """Persists the kafka analysis into <store>/kafka/ (see module
    doc).  Never raises: a side-output failure must not let
    check_safe downgrade the computed verdict — same policy as
    checker/elle.write_artifacts."""
    directory = (opts or {}).get("dir")
    if not directory:
        return
    try:
        ops = [o for o in history if o.f in TXN_FS]
        out = os.path.join(directory, "kafka")
        os.makedirs(out, exist_ok=True)

        # One version-order inference serves the lag plot AND the
        # divergence artifact below (each previously recomputed it on
        # top of analyze()'s own pass).
        orders, _ = version_orders(ops, reads_by_type(ops))

        series = unseen_series(ops)
        with open(os.path.join(out, "unseen.json"), "w") as f:
            json.dump(
                {"final": result.get("unseen"), "series": series},
                f, indent=2, default=repr,
            )
        _plot_unseen(series, os.path.join(out, "unseen.svg"))
        _plot_lag(lag_series(ops, orders),
                  os.path.join(out, "realtime-lag.svg"))

        if result.get("valid") is True:
            return
        anomalies = result.get("anomalies") or {}
        with open(os.path.join(out, "anomalies.json"), "w") as f:
            json.dump(
                {
                    "valid": result.get("valid"),
                    "anomaly-types": result.get("anomaly-types"),
                    "anomalies": anomalies,
                },
                f, indent=2, default=repr,
            )

        # Version orders for every key a divergence names
        # (kafka.clj's version-order artifacts).
        divergent = {
            d.get("key")
            for d in anomalies.get("inconsistent-offsets", ())
            if isinstance(d, dict)
        }
        if divergent:
            with open(os.path.join(out, "version-orders.json"),
                      "w") as f:
                json.dump(
                    {
                        repr(k): list(orders[k].by_index)
                        for k in divergent if k in orders
                    },
                    f, indent=2, default=repr,
                )

        # One DOT per dependency cycle, elle-style.
        cycles = [
            c for v in anomalies.values() if isinstance(v, list)
            for c in v if isinstance(c, dict) and "steps" in c
        ]
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
    except Exception as e:  # noqa: BLE001 — side output only
        log.warning("could not write kafka artifacts to %s: %r",
                    directory, e)
