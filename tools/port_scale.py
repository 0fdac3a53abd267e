"""The port's scale point: the longest history decided within 300 s.

    python3 tools/port_scale.py [--ops N] [--budget S] [--device cuda]

The counterpart of `bench.py run_scale` for the PyTorch/CUDA port, on
one card.  It generates `random_register_packed(N, procs=16,
info_rate=0.05, seed=45100)` (N = 20,000,000 by default), warms the
kernels on the 50,000-op seed-7 history at the same window width, then
times one `check_wgl_device(time_limit_s=budget,
width_hint=plan_width(...))` with the packed lanes at their default
(`JEPSEN_WGL_PACKED`).  A run that is not decided within the budget is
recorded as such; then the reference's fit rule (bench.py run_scale:
N = rate * max(30, budget - 60) * 0.6, the rate measured from the
blocks the timed-out run finished, read from its witness checkpoint)
picks a smaller history, which is checked the same way.

Earlier lines print the split of each check: generation, `_plan_blocks`
and host table-build seconds, sweeps, chain rounds, host syncs and
`torch.cuda.max_memory_allocated`, and the card's name and power limit
as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
gives them.  The last line is one JSON object with the reference's
names: metric "scale_ops_to_verdict", ops, valid, elapsed_s, ops_per_s,
max_ops_at_300s (the last two when the verdict is valid).

To rehearse on the CPU at a small size: `--device cpu --ops 200000`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from jepsen_tpu_torch import device as _device  # noqa: E402
from jepsen_tpu_torch.models import cas_register  # noqa: E402
from jepsen_tpu_torch.ops import kernels, wgl_witness  # noqa: E402
from jepsen_tpu_torch.ops.wgl import check_wgl_device  # noqa: E402
from jepsen_tpu_torch.ops.wgl_witness import plan_width  # noqa: E402
from jepsen_tpu_torch.utils.histgen import random_register_packed  # noqa: E402

SEED = 45100
WARM_OPS = 50_000
WARM_SEED = 7


class Timed:
    """Wraps a module function, summing the seconds of its calls."""

    def __init__(self, mod, name: str):
        self.mod, self.name = mod, name
        self.real = getattr(mod, name)
        self.s = 0.0
        self.calls = 0
        setattr(mod, name, self)

    def __call__(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return self.real(*a, **k)
        finally:
            self.s += time.perf_counter() - t0
            self.calls += 1

    def reset(self) -> None:
        self.s, self.calls = 0.0, 0


def log(msg: str) -> None:
    print(f"port_scale: {msg}", flush=True)


def check(pm, packed, budget: float, width: int, dev, timers,
          ckpt_dir=None) -> dict:
    """One timed check with its split; the counts set to 0 just before
    it and read just after."""
    for t in timers.values():
        t.reset()
    kernels.launches.clear()
    _device.counters.clear()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = check_wgl_device(packed, pm, time_limit_s=budget,
                           width_hint=width, checkpoint_dir=ckpt_dir,
                           device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {
        "ops": int(packed.n), "valid": res.valid, "reason": res.reason,
        "elapsed_s": dt,
        "plan_s": timers["plan"].s, "plans": timers["plan"].calls,
        "table_build_s": timers["tables"].s,
        "sweeps": int(kernels.launches.get("witness_sweep", 0)),
        "chain_rounds": int(_device.counters.get("heavy_rounds", 0)),
        "host_syncs": int(_device.counters.get("host_syncs", 0)),
        "bfs_levels": int(_device.counters.get("bfs_levels", 0)),
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if dev.type == "cuda" else None),
    }


def blocks_done(ckpt_dir: str) -> int:
    """The next-block cursor of the witness checkpoint left in
    `ckpt_dir` (0 when there is none)."""
    best = 0
    for path in glob.glob(os.path.join(ckpt_dir, "wgl-witness-*.ckpt.npz")):
        with np.load(path) as z:
            best = max(best, int(z["c0"]))
    return best


def generate(pm, n: int) -> tuple:
    t0 = time.perf_counter()
    packed = random_register_packed(n, procs=16, info_rate=0.05, seed=SEED,
                                    model=pm)
    return packed, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ops", type=int, default=20_000_000)
    ap.add_argument("--budget", type=float, default=300.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = _device.resolve(args.device)
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
        t0 = time.perf_counter()
        kernels.sweep_lib()
        log(f"build: {time.perf_counter() - t0:.3f} s")
    else:
        smi = None
        log("device: cpu")
    timers = {"plan": Timed(wgl_witness, "_plan_blocks"),
              "tables": Timed(wgl_witness, "_chunk_tables")}
    pm = cas_register().packed()

    packed, gen_s = generate(pm, args.ops)
    t0 = time.perf_counter()
    width = plan_width(packed)
    width_s = time.perf_counter() - t0
    log(f"history: {packed.n} ops ({packed.n_ok} ok), generation "
        f"{gen_s:.3f} s, plan_width {width} in {width_s:.3f} s")
    warm = random_register_packed(WARM_OPS, procs=16, info_rate=0.05,
                                  seed=WARM_SEED, model=pm)
    w = check(pm, warm, 120.0, width, dev, timers)
    log(f"warm-up: {json.dumps(w)}")

    runs = []
    build = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as ckpt:
        r = check(pm, packed, args.budget, width, dev, timers, ckpt)
        r["generation_s"] = gen_s
        runs.append(r)
        log(f"check: {json.dumps(r)}")
        if r["valid"] is not True:
            # The reference's fit rule, at the rate the timed-out run
            # reached: the blocks it finished, as a share of the ops.
            kn = wgl_witness._block_knobs(packed)[0]
            done = blocks_done(ckpt) * kn["bars_per_block"]
            rate = min(packed.n, done / max(packed.n_ok, 1) * packed.n) \
                / r["elapsed_s"]
            fit = int(rate * max(30.0, args.budget - 60.0) * 0.6)
            log(f"not decided in {args.budget} s ({r['reason']}): "
                f"{done} barriers done, {rate:.1f} ops/s, fit N = {fit}")
            if fit > 0:
                del packed
                packed, gen_s = generate(pm, fit)
                r = check(pm, packed, args.budget, width, dev, timers)
                r["generation_s"] = gen_s
                r["fit_rate_ops_per_s"] = rate
                runs.append(r)
                log(f"check: {json.dumps(r)}")

    last = runs[-1]
    rec = {"metric": "scale_ops_to_verdict", "ops": last["ops"],
           "valid": last["valid"], "elapsed_s": last["elapsed_s"],
           "budget_s": args.budget, "target_ops": args.ops,
           "target_valid": runs[0]["valid"],
           "target_elapsed_s": runs[0]["elapsed_s"],
           "device": torch.cuda.get_device_name(0) if dev.type == "cuda"
           else "cpu"}
    if last["valid"] is True:
        rate = last["ops"] / last["elapsed_s"]
        rec["ops_per_s"] = rate
        rec["max_ops_at_300s"] = int(rate * 300.0)
    else:
        rec["error"] = f"verdict {last['valid']} ({last['reason']})"
    if smi is not None:
        print(smi)
    print(json.dumps(rec))
    return 0 if last["valid"] is True else 1


if __name__ == "__main__":
    sys.exit(main())
