"""Percent of the traced window the host spent launching the sweep
kernel B1 and reading its death barrier back, less the device reads
(`device.counters["sweep_ns"]`: ops/wgl_witness.py `_Block.run`);
nothing where the port keeps no such counter."""


def read(ctx: dict):
    ns = ctx["counts"]["counters"].get("sweep_ns")
    w = ctx["window"]["seconds"]
    return 100.0 * ns / 1e9 / w if ns and w else None
