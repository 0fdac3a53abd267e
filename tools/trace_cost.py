"""What the port's telemetry costs, and whether the benchmark's shared
clock of host spans and card kernels holds.

    python3 tools/trace_cost.py off [--tree DIR]
    python3 tools/trace_cost.py on [--pairs N] [--seed S]

`off` (any host): nanoseconds per no-op span (`telemetry.span` with
telemetry off), per no-op `device.timed` block where the tree has it,
and per `device.host` call on a stand-in for a value on the card, in
the tree DIR (default: this checkout), each the median of 7 rounds of
200,000 calls.  Run it on two trees in turn to compare them.

`on` (a CUDA card): the first history of the `register-100k` cell's
pool (`perfbench/`), checked 2N times with telemetry on and 2N times
with it off, interleaved (off, on, on, off, ...), each check's wall
seconds beside this process's CPU seconds (the host's speed drifts;
its CPU seconds move with it).  Then one check under the profiler,
tied to the spans' clock by a marker kernel as `perfbench/trace.py`
ties them, with each launch of the sweep kernel in a span of this
tool's: the n-th kernel's start against the n-th launch span, and the
share of starts inside a launch span or within 50 us after its end.

Prints one line "TRACE_COST {json}".
"""

import argparse
import json
import os
import resource
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def off(tree: str) -> dict:
    sys.path.insert(0, tree)
    from jepsen_tpu_torch import device, telemetry

    class Card:
        class device:
            type = "cuda"

        def tolist(self):
            return [0]

    telemetry.enable(False)
    n, card = 200_000, Card()

    def per_call(fn) -> float:
        rounds = []
        for _ in range(7):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                fn()
            rounds.append((time.perf_counter_ns() - t0) / n)
        return statistics.median(rounds)

    def span(name="wgl.witness.table"):
        with telemetry.span(name):
            pass

    def timed():
        with device.timed("sweep_ns"):
            pass

    def empty():
        pass

    return {"tree": tree, "loop_ns": per_call(empty),
            "noop_span_ns": per_call(span),
            "noop_timed_ns": (per_call(timed)
                              if hasattr(device, "timed") else None),
            "host_ns": per_call(lambda: device.host(card))}


def _cpu() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def on(pairs: int, seed: int) -> dict:
    sys.path.insert(0, ROOT)
    from perfbench import generate, manifest, port, run

    run.clean_env()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.set_num_threads(1)
    cell = manifest.load("register-100k")
    records = generate.pool(cell.config, cell.traffic, seed)[0]
    entry = manifest.load_module(cell.entry).Entry(cell.config, "cuda")
    ops = entry.prepare(records)

    def one() -> None:
        port.clear_memo()
        assert entry.check(ops)["valid"] is True
        torch.cuda.synchronize()

    one()
    checks = {"off": [], "on": []}
    spans_per_check = []
    order = ["off", "on", "on", "off"] * pairs
    for mode in order:
        port.spans_on(mode == "on")
        w0, c0 = time.perf_counter(), _cpu()
        one()
        checks[mode].append((time.perf_counter() - w0, _cpu() - c0))
        if mode == "on":
            spans, dropped = port.take_spans()
            spans_per_check.append((len(spans), dropped))
    port.spans_on(True)

    # One check under the profiler, on the spans' clock, each sweep
    # launch in a span.
    from jepsen_tpu_torch.ops import kernels

    real = kernels.witness_sweep

    def launch(*args):
        with port.span("trace_cost.launch"):
            return real(*args)

    mark = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    port.take_spans()
    kernels.witness_sweep = launch
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with port.span("perfbench.mark"):
                pass
            mark.fill_(1.0)
            torch.cuda.synchronize()
            one()
    finally:
        kernels.witness_sweep = real
    spans, dropped = port.take_spans()
    port.spans_on(False)
    events = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda x: x[1])
    shift = [s for _, s, _, n in spans if n == "perfbench.mark"][0] \
        - events[0][1]
    launches = sorted((s, e) for _, s, e, n in spans
                      if n == "trace_cost.launch")
    starts = [s + shift for n, s, _ in events[1:] if "witness_sweep" in n]
    matched = list(zip(launches, starts))
    after = [t - e for (_, e), t in matched]
    near = sum(s <= t <= e + 50.0 for (s, e), t in matched)
    tenth = max(1, len(after) // 10)

    def pct(xs):
        xs = sorted(xs)
        return [round(xs[int(q * (len(xs) - 1))], 3)
                for q in (0.0, 0.1, 0.5, 0.9, 1.0)] if xs else None

    def summary(rows):
        return {"wall_s": [round(w, 4) for w, _ in rows],
                "cpu_s": [round(c, 4) for _, c in rows],
                "wall_median_s": statistics.median(w for w, _ in rows),
                "cpu_median_s": statistics.median(c for _, c in rows)}

    off_, on_ = summary(checks["off"]), summary(checks["on"])
    return {
        "device": torch.cuda.get_device_name(0),
        "power_limit_w": run.power_limit_w(),
        "off": off_, "on": on_,
        "wall_cost": on_["wall_median_s"] / off_["wall_median_s"] - 1,
        "cpu_cost": on_["cpu_median_s"] / off_["cpu_median_s"] - 1,
        "spans_per_check": spans_per_check,
        "clock": {"sweep_kernels": len(starts),
                  "launch_spans": len(launches),
                  "near_share": near / len(matched) if matched else None,
                  # Kernel start less its launch span's end, us:
                  # min, 10%, median, 90%, max; first and last tenth.
                  "start_after_launch_us": pct(after),
                  "first_tenth_median_us": (statistics.median(
                      after[:tenth]) if after else None),
                  "last_tenth_median_us": (statistics.median(
                      after[-tenth:]) if after else None),
                  "spans_dropped": dropped},
    }


def main() -> None:
    ap = argparse.ArgumentParser(prog="tools/trace_cost.py")
    ap.add_argument("mode", choices=("off", "on"))
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--seed", type=int, default=2**31 + 2101)
    a = ap.parse_args()
    out = off(a.tree) if a.mode == "off" else on(a.pairs, a.seed)
    print("TRACE_COST " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
