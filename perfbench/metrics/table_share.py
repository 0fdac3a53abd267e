"""Percent of the traced window under the port's `wgl.witness.table`
spans (ops/wgl_witness.py `run_chunks`: the block tables built on the
host and uploaded, or gathered on the card) (host clock)."""

from perfbench.trace import layer_time


def read(ctx: dict):
    if ctx["spans_dropped"] or not ctx["window"]["seconds"]:
        return None
    t = layer_time(ctx["spans"], {"wgl.witness.table"})
    return 100.0 * t / ctx["window"]["seconds"] if t else None
