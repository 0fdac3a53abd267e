"""Percent of the traced window the host spent in the witness chain
search B2 (`device.counters["chain_ns"]`: ops/wgl_witness.py
`_Block.run` around each `heavy`, less the device reads inside it), the
host dispatching B2's rounds; nothing where the port keeps no such
counter."""


def read(ctx: dict):
    ns = ctx["counts"]["counters"].get("chain_ns")
    w = ctx["window"]["seconds"]
    return 100.0 * ns / 1e9 / w if ns and w else None
