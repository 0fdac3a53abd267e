"""Launches of the witness sweep kernel B1 (`ops.kernels.launches
["witness_sweep"]`) over the traced window's checks, per 1,000 client
operations."""


def read(ctx: dict):
    kops = ctx["window"]["client_ops"] / 1e3
    return ctx["counts"]["launches"].get("witness_sweep", 0) / kops \
        if kops else None
