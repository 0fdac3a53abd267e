"""Percent of the traced window under the port's `wgl.stream` spans
(ops/wgl_stream.py: the stream witness over the keys, its sweeps and
chain rounds), less the BFS spans nested in them (host clock)."""

from perfbench.trace import layer_time

NESTED = {"wgl.bfs.block", "wgl.batched.block"}


def read(ctx: dict):
    if ctx["spans_dropped"]:
        return None
    t = layer_time(ctx["spans"], {"wgl.stream"}, NESTED)
    return 100.0 * t / ctx["window"]["seconds"] if t else None
