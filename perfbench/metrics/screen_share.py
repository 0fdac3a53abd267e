"""Percent of the traced window under the port's `checker.refute` spans
(checker/refute.py `check_refute`: the host's refutation screen)
(host clock)."""

from perfbench.trace import layer_time


def read(ctx: dict):
    if ctx["spans_dropped"] or not ctx["window"]["seconds"]:
        return None
    t = layer_time(ctx["spans"], {"checker.refute"})
    return 100.0 * t / ctx["window"]["seconds"] if t else None
