"""Percent of the traced window the host spent blocked on reads from
the card (`device.counters["sync_ns"]`: device.py `host`, summed over
threads); nothing where the port keeps no such counter."""


def read(ctx: dict):
    ns = ctx["counts"]["counters"].get("sync_ns")
    w = ctx["window"]["seconds"]
    return 100.0 * ns / 1e9 / w if ns and w else None
