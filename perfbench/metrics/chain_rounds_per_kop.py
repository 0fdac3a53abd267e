"""Rounds of the witness chain search B2 (`device.counters
["chain_rounds"]`, one per round of `_Block.heavy`) over the traced
window's checks, per 1,000 client operations; nothing where the port
counts no such round."""


def read(ctx: dict):
    kops = ctx["window"]["client_ops"] / 1e3
    n = ctx["counts"]["counters"].get("chain_rounds")
    return n / kops if n and kops else None
