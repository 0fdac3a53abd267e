"""Stream witness segment restarts (`device.counters["stream_restarts"]`)
per check of the traced window; nothing when no stream pass ran."""


def read(ctx: dict):
    c = ctx["counts"]["counters"]
    if not c.get("stream_passes") or not ctx["window"]["checks"]:
        return None
    return c.get("stream_restarts", 0) / ctx["window"]["checks"]
