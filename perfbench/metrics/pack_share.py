"""Percent of the traced window under the port's `ingest.pack` spans
(history/packed.py `pack_history`: a history packed into the checker's
columns, `ingest.finish` included) (host clock)."""

from perfbench.trace import layer_time


def read(ctx: dict):
    if ctx["spans_dropped"] or not ctx["window"]["seconds"]:
        return None
    t = layer_time(ctx["spans"], {"ingest.pack"})
    return 100.0 * t / ctx["window"]["seconds"] if t else None
