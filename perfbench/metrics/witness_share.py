"""Percent of the traced window under the port's `wgl.witness` spans
(ops/wgl.py around the witness search of ops/wgl_witness.py), less
the BFS and stream spans nested in them (host clock)."""

from perfbench.trace import layer_time

NESTED = {"wgl.bfs.block", "wgl.batched.block", "wgl.stream"}


def read(ctx: dict):
    if ctx["spans_dropped"]:
        return None
    t = layer_time(ctx["spans"], {"wgl.witness"}, NESTED)
    return 100.0 * t / ctx["window"]["seconds"] if t else None
