"""Seconds from the harness's start to the window's: imports, the CUDA
context, loading (on a checkout's first run, building) the sweep
kernel, making the pool from the seed, one warm check (host clock)."""


def read(ctx: dict):
    return ctx["setup_s"]
