"""Two checkouts of the port, side by side on one card: the same checks
in turns, each side in its own warm process.

    python3 tools/plan_ab.py --parent DIR [--pairs N] [--out FILE]

DIR is another checkout of the repo (unpack it with `git archive` into
a directory that .gitignore lists, such as build/); the other side is
the checkout that holds this script.  Each side runs in one worker
process, which builds its own kernels, makes the histories and then
waits for commands, so both stay warm and the checks interleave:
pair i runs parent then change when i is even, change then parent when
it is odd.  The workloads are the bench history through
`Linearizable(cas_register())` ("single", 100k ops), phase 5's
run_mixed history ("mixed", 200 keys x 100 ops, 30 bad) and the
2,000-key all-valid history ("big") through `IndependentChecker`, with
telemetry off, the settle memo cleared before each check.

Prints one line "PLAN_AB {json}": per workload and side, every wall
time, the median and quartiles, the time the garbage collector paused
the check, and the sweep launches, host syncs, verdict and failure
count of each check, which must be equal on both sides (else it exits
1).  Then one check per side and many-key workload under cProfile; the
top functions by own time go to FILE (default
chiprun_out/plan_ab_profiles.txt).
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOADS = ("single", "mixed", "big")

#: The worker: run from a checkout's root, so that it imports that
#: checkout's package and chip_smoke.  One JSON line in, one out.
WORKER = r'''
import cProfile, gc, io, json, pstats, sys, time
import torch
import chip_smoke as cs
from jepsen_tpu_torch import device as D
from jepsen_tpu_torch.checker import Linearizable
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops import kernels
from jepsen_tpu_torch.parallel import IndependentChecker, clear_settle_memo
from jepsen_tpu_torch.utils.histgen import random_register_history

dev = torch.device("cuda")
kernels.sweep_lib()
H = {"single": random_register_history(cs.BENCH_OPS, procs=cs.BENCH_PROCS,
                                       info_rate=cs.BENCH_INFO,
                                       seed=cs.BENCH_SEED),
     "mixed": cs.mixed_history(cs.MIXED_KEYS, cs.MIXED_BAD),
     "big": cs.mixed_history(cs.BIG_KEYS, 0)}
gc_pause = [0.0, None]

def on_gc(phase, info):
    if phase == "start":
        gc_pause[1] = time.perf_counter()
    elif gc_pause[1] is not None:
        gc_pause[0] += time.perf_counter() - gc_pause[1]
        gc_pause[1] = None

gc.callbacks.append(on_gc)

def check(name):
    clear_settle_memo()
    if name == "single":
        return Linearizable(cas_register(), "wgl-tpu",
                            device=dev).check({}, H[name], {})
    return IndependentChecker(Linearizable(
        cas_register(), time_limit_s=120, device=dev),
        device=dev).check({}, H[name], {})

print(json.dumps({"ready": True}), flush=True)
for line in sys.stdin:
    cmd = json.loads(line)
    kernels.launches.clear()
    D.counters.clear()
    gc_pause[0] = 0.0
    pr = cProfile.Profile() if cmd.get("profile") else None
    if pr:
        pr.enable()
    t0 = time.perf_counter()
    res = check(cmd["w"])
    torch.cuda.synchronize()
    out = {"wall_s": time.perf_counter() - t0, "gc_s": gc_pause[0],
           "sweeps": kernels.launches.get("witness_sweep", 0),
           "host_syncs": D.counters.get("host_syncs", 0),
           "valid": res["valid"], "failures": res.get("failure-count"),
           "algorithm": res.get("algorithm")}
    if pr:
        pr.disable()
        buf = io.StringIO()
        pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(15)
        out["profile"] = buf.getvalue()
    print(json.dumps(out), flush=True)
'''


class Side:
    def __init__(self, name: str, root: str):
        self.name = name
        self.p = subprocess.Popen(
            [sys.executable, "-u", "-c", WORKER], cwd=root,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def read(self) -> dict:
        line = self.p.stdout.readline()
        if not line:
            raise RuntimeError(f"{self.name}: worker exited "
                               f"({self.p.wait()})")
        return json.loads(line)

    def run(self, w: str, profile: bool = False) -> dict:
        self.p.stdin.write(json.dumps({"w": w, "profile": profile}) + "\n")
        self.p.stdin.flush()
        return self.read()

    def close(self) -> None:
        self.p.stdin.close()
        self.p.wait(timeout=60)


def spread(xs: list) -> dict:
    q = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2],
            "min": min(xs), "max": max(xs)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "plan_ab_profiles.txt"))
    args = ap.parse_args()
    sides = [Side("parent", os.path.abspath(args.parent)),
             Side("change", ROOT)]
    try:
        for s in sides:
            s.read()
        for w in WORKLOADS:  # warm-up, not counted
            for s in sides:
                s.run(w)
        runs = {w: {s.name: [] for s in sides} for w in WORKLOADS}
        for w in WORKLOADS:
            for i in range(args.pairs):
                for s in (sides if i % 2 == 0 else sides[::-1]):
                    runs[w][s.name].append(s.run(w))
        profiles = {f"{w} {s.name}": s.run(w, profile=True)["profile"]
                    for w in ("mixed", "big") for s in sides}
    finally:
        for s in sides:
            s.close()
    out: dict = {"pairs": args.pairs, "workloads": {}}
    same = True
    for w, by in runs.items():
        row = {}
        for name, rs in by.items():
            row[name] = {
                "wall_s": spread([r["wall_s"] for r in rs]),
                "gc_s": spread([r["gc_s"] for r in rs]),
                "walls": [r["wall_s"] for r in rs],
                "counts": sorted({json.dumps({k: r[k] for k in (
                    "sweeps", "host_syncs", "valid", "failures",
                    "algorithm")}, sort_keys=True) for r in rs})}
        same &= row["parent"]["counts"] == row["change"]["counts"]
        row["change_over_parent_median"] = (
            row["change"]["wall_s"]["median"]
            / row["parent"]["wall_s"]["median"])
        out["workloads"][w] = row
    out["equal_counts"] = same
    print("PLAN_AB " + json.dumps(out), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        for k, v in profiles.items():
            f.write(f"=== {k}\n{v}\n")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
