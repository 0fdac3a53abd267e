"""Non-linearizable counterexample rendering.

Equivalent of knossos's `linear.svg` as the reference invokes it
(knossos.linear.report/render-analysis! at
jepsen/src/jepsen/checker.clj:223-229): when the WGL
search proves a history non-linearizable, draw the window of operations
around the op that could not be linearized — per-process time bars with
op labels, the crashed op highlighted — plus the deepest configurations
the search reached (their model states and missing ops), so a human can
see *why* every linearization path dies.

Hand-rolled SVG: no plotting dependency, deterministic output, small
files.
"""

from __future__ import annotations

import html
from typing import Any, Optional

from ..history.packed import ST_OK, PackedOps
from ..models.base import PackedModel
from .wgl_cpu import WGLResult

#: Ops drawn before/after the crashed op.
WINDOW_BEFORE = 18
WINDOW_AFTER = 6

ROW_H = 26
BAR_H = 18
LEFT = 90
PX_PER_EVENT = 28
TOP = 34


def _describe(pm: PackedModel, packed: PackedOps, a: int) -> str:
    if pm.describe_op is not None:
        return pm.describe_op(
            int(packed.f[a]), int(packed.a0[a]), int(packed.a1[a])
        )
    return f"f={int(packed.f[a])}({int(packed.a0[a])},{int(packed.a1[a])})"


def _state_str(pm: PackedModel, state: list) -> str:
    try:
        vals = [pm.interner.value(int(s)) for s in state]
    except (IndexError, TypeError):
        vals = list(state)
    return "/".join(repr(v) for v in vals)


def render_analysis(
    packed: PackedOps,
    pm: PackedModel,
    res: WGLResult,
    path: str,
) -> Optional[str]:
    """Writes the counterexample SVG; returns the path (None when the
    result carries nothing renderable)."""
    if res.valid is not False or res.crashed_at is None:
        return None
    crash = res.crashed_at
    n = packed.n
    lo = max(0, crash - WINDOW_BEFORE)
    hi = min(n, crash + WINDOW_AFTER + 1)
    rows_ops = list(range(lo, hi))
    if not rows_ops:
        return None

    # Event-index -> x coordinate, compressed to the events we draw.
    events = sorted(
        {int(packed.inv[a]) for a in rows_ops}
        | {
            int(packed.ret[a])
            for a in rows_ops
            if packed.status[a] == ST_OK
        }
    )
    ex = {e: i for i, e in enumerate(events)}
    right_x = LEFT + (len(events) + 1) * PX_PER_EVENT

    procs = sorted({int(packed.process[a]) for a in rows_ops})
    py = {p: TOP + i * ROW_H for i, p in enumerate(procs)}

    linearized_sets = [
        set(c.get("linearized", [])) for c in res.final_configs
    ]
    in_any_config = set().union(*linearized_sets) if linearized_sets else set()

    parts: list[str] = []
    h_chart = TOP + len(procs) * ROW_H + 10
    config_lines = min(len(res.final_configs), 10)
    height = h_chart + 26 + config_lines * 18 + 16
    parts.append(
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{right_x + 20}" '
        f'height="{height}" font-family="monospace" font-size="11">'
    )
    parts.append(
        f'<text x="{LEFT}" y="16" font-size="13">non-linearizable window: '
        f"op {html.escape(_describe(pm, packed, crash))} "
        f"(history index {int(packed.src_index[crash])}) "
        f"cannot be linearized</text>"
    )

    for p in procs:
        parts.append(
            f'<text x="8" y="{py[p] + BAR_H - 5}">proc {p}</text>'
        )

    for a in rows_ops:
        p = int(packed.process[a])
        x0 = LEFT + ex[int(packed.inv[a])] * PX_PER_EVENT
        if packed.status[a] == ST_OK:
            x1 = LEFT + ex[int(packed.ret[a])] * PX_PER_EVENT + PX_PER_EVENT
        else:
            x1 = right_x  # indeterminate: open to the edge
        y = py[p]
        if a == crash:
            fill, stroke = "#fbb", "#c00"
        elif a in in_any_config:
            fill, stroke = "#bfe3bf", "#4a4"  # linearized in some config
        elif packed.status[a] == ST_OK:
            fill, stroke = "#dde6f0", "#88a"
        else:
            fill, stroke = "#eee", "#aaa"
        parts.append(
            f'<rect x="{x0}" y="{y}" width="{max(x1 - x0, 4)}" '
            f'height="{BAR_H}" fill="{fill}" stroke="{stroke}" rx="3"/>'
        )
        label = _describe(pm, packed, a)
        if packed.status[a] != ST_OK:
            label += " (info)"
        parts.append(
            f'<text x="{x0 + 3}" y="{y + BAR_H - 5}" '
            f'clip-path="none">{html.escape(label)}</text>'
        )

    y = h_chart + 14
    parts.append(
        f'<text x="8" y="{y}" font-size="12">deepest configurations '
        f"(model state | linearized count | missing ok ops):</text>"
    )
    for c in res.final_configs[:10]:
        y += 18
        missing = ", ".join(
            html.escape(_describe(pm, packed, m))
            for m in c.get("missing_ok_ops", [])[:4]
        )
        parts.append(
            f'<text x="20" y="{y}">state '
            f"{html.escape(_state_str(pm, c.get('state', [])))} | "
            f"{len(c.get('linearized', []))} linearized | missing: "
            f"{missing}</text>"
        )
    parts.append("</svg>")

    with open(path, "w") as f:
        f.write("\n".join(parts))
    return path
