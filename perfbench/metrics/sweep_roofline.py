"""Percent of the roofline the witness sweep kernel B1 reaches: the
least time its launches need (the bytes `perfbench/roofline.py`
counts in a pass of their own over the profiled slice's checks, at the
data sheet's HBM bandwidth) over the device time of its kernels in the
profiled slice.  Nothing when the two passes launched it a different
number of times, when it did not run, or for a card with no published
peak in the table."""

from perfbench.roofline import peak_bytes_per_s

KERNELS = ("witness_sweep", "combine_groups")


def read(ctx: dict):
    p, s = ctx["profile"], ctx["sweep"]
    peak = peak_bytes_per_s(ctx["device_name"])
    if not p or not s or not peak or not s["launches"] \
            or s["launches"] != s["profiled_launches"]:
        return None
    t = sum(v for k, v in p["kernel_s"].items()
            if any(n in k for n in KERNELS))
    return 100.0 * (s["bytes"] / peak) / t if t else None
