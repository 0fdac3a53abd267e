"""Device reads the host waited for (`device.counters["host_syncs"]`)
over the traced window's checks, per 1,000 client operations."""


def read(ctx: dict):
    kops = ctx["window"]["client_ops"] / 1e3
    return ctx["counts"]["counters"].get("host_syncs", 0) / kops \
        if kops else None
