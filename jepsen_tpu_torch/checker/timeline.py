"""HTML timeline of operations per process.

The port's copy of `jepsen_tpu/checker/timeline.py` (no JAX there either).

Equivalent of jepsen/checker/timeline.clj:
one column per process, one box per operation spanning its
invoke→completion window, colored by outcome; capped at `OP_LIMIT` ops
(:13-15).  Pure-stdlib HTML/CSS, no hiccup.
"""

from __future__ import annotations

import html
import os
from typing import Any, Optional

from ..history.core import History, Op
from .core import Checker

#: Render cap (timeline.clj:13-15).
OP_LIMIT = 10_000

_COLORS = {
    "ok": "#6DB6FE",
    "info": "#FFAA26",
    "fail": "#FEB5DA",
}

_STYLE = """
body { font-family: sans-serif; }
.timeline { position: relative; }
.process-label { position: absolute; top: 0; width: 100px;
  font-weight: bold; text-align: center; }
.op { position: absolute; width: 100px; border-radius: 2px;
  padding: 1px 2px; box-sizing: border-box; overflow: hidden;
  font-size: 9px; line-height: 1.1; border: 1px solid #0004; }
"""

_PX_PER_MS = 0.1
_MIN_HEIGHT = 12
_COL_WIDTH = 104
_HEADER = 24


def render(test: dict, history: History,
           highlight: Optional[int] = None) -> str:
    """`highlight` is a history index (invocation or completion): that
    op's box gets a red border — forensics dossiers use it to mark the
    op the linearizability search died on."""
    ops = []
    for op in history:
        if op.is_invoke:
            continue
        inv = history.invocation(op)
        if inv is None:
            continue
        ops.append((inv, op))
        if len(ops) >= OP_LIMIT:
            break

    processes = []
    seen = set()
    for inv, _ in ops:
        if inv.process not in seen:
            seen.add(inv.process)
            processes.append(inv.process)
    col = {p: i for i, p in enumerate(processes)}

    boxes = []
    for p in processes:
        boxes.append(
            f"<div class='process-label' style='left:{col[p] * _COL_WIDTH}px'>"
            f"{html.escape(str(p))}</div>"
        )
    t0 = ops[0][0].time if ops else 0
    max_bottom = _HEADER
    for inv, comp in ops:
        top = _HEADER + (inv.time - t0) / 1e6 * _PX_PER_MS
        height = max((comp.time - inv.time) / 1e6 * _PX_PER_MS, _MIN_HEIGHT)
        max_bottom = max(max_bottom, top + height)
        color = _COLORS.get(comp.type, "#DDD")
        title = html.escape(
            f"{inv.process} {inv.f} {inv.value!r} -> {comp.type} "
            f"{comp.value!r} [{inv.time / 1e6:.1f}ms - {comp.time / 1e6:.1f}ms]"
        )
        label = html.escape(f"{comp.f} {comp.value!r}")[:64]
        hot = highlight is not None and highlight in (inv.index, comp.index)
        border = "border:2px solid #D00;" if hot else ""
        boxes.append(
            f"<div class='op' title='{title}' style='"
            f"left:{col[inv.process] * _COL_WIDTH}px;"
            f"top:{top:.1f}px;height:{height:.1f}px;{border}"
            f"background:{color}'>{label}</div>"
        )
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(str(test.get('name', 'test')))} timeline</title>"
        f"<style>{_STYLE}</style></head><body>"
        f"<h1>{html.escape(str(test.get('name', 'test')))}</h1>"
        f"<div class='timeline' style='height:{max_bottom + 20:.0f}px'>"
        + "".join(boxes)
        + "</div></body></html>"
    )


class Timeline(Checker):
    def check(self, test: dict, history: History, opts: dict) -> dict:
        d = opts.get("dir")
        if not d:
            return {"valid": True, "note": "no dir; skipped"}
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "timeline.html")
        with open(path, "w") as f:
            f.write(render(test, history))
        return {"valid": True, "file": path}


def html_checker() -> Timeline:
    """timeline/html (timeline.clj)."""
    return Timeline()
