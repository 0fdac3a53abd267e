"""Runs one cell of `BENCHMARK.json` once, on the CUDA card:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

1. Set-up: clears the port's environment switches (`JEPSEN_*`: no plan
   memo on disk, no profile store, no telemetry unless traced), makes
   the cell's pool of histories from the seed, turns them into the
   port's ops, and runs one warm check at the cell's own shapes (on a
   checkout's first run this builds the sweep kernel into the
   checkout's `build/`).
2. The window: a closed loop, as a Jepsen user waits for each verdict
   before the next analysis.  Checks run back to back over the pool,
   each on a new `History` with the port's verdict memo emptied, until
   `--seconds` have passed; the check in flight then finishes, and so
   do the rest of its turn through the pool, so every history of the
   pool is checked equally often (their costs differ by up to a fifth).
3. With `--trace 1`: the window runs with the port's spans on; then the
   sweep kernel's bytes are counted in a pass of their own over the
   traffic's `profile_checks` first histories, and the same checks run
   under the profiler.
4. The port's state is freed, and the reference decides every history
   the window checked; every check's verdicts are compared with it.

Prints the compared numbers with their limits as the last lines of
standard error, and one JSON line as the last of standard output.
Exits 2, printing no result, without enough CUDA cards, and 3 when a
module of JAX or of `jepsen_tpu` is loaded after the window.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from typing import Callable, Optional  # noqa: E402

from perfbench import compare, generate, manifest, reference  # noqa: E402

#: Top-level module names no benchmark run may load.
BANNED = ("jax", "jaxlib", "flax", "jepsen_tpu")

#: Seconds the reference may take over a run's histories.
REFERENCE_BUDGET_S = 150.0


def clean_env() -> None:
    """Drops the port's switches, so it runs at its defaults, and keeps
    torch's build caches inside the checkout, at fixed paths."""
    for k in [k for k in os.environ if k.startswith("JEPSEN_")]:
        del os.environ[k]
    build = manifest.ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def power_limit_w():
    """The card's power limit by `nvidia-smi`, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _top(d: dict, n: int = 10) -> list:
    return [[k[:200], v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def _host() -> tuple:
    """(wall s, this process's user CPU s, its system CPU s).  A check's
    CPU seconds beside its wall seconds tell the host's speed apart from
    waiting: on the card's host they move together."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return time.perf_counter(), r.ru_utime, r.ru_stime


def window(cell: manifest.Cell, entry, seed: int, seconds: float,
           trace: bool, sync: Callable[[], None],
           profile: Optional[Callable] = None, log=sys.stderr,
           t_start: float = _T_START) -> tuple:
    """Set-up and the window of one run of `cell`, driving `entry` (a
    built entry: `prepare` at set-up, `check` in the window) and
    calling `sync` after each check.  With `trace`, the spans, counts
    and sweep bytes are read, and `profile` (`trace.profiled`), where
    given, profiles the slice.  -> (records, checks, ctx): the pool's
    records, (pool index, outcome) of each check, the readings."""
    from perfbench import port

    records = generate.pool(cell.config, cell.traffic, seed)
    prepared = [entry.prepare(r) for r in records]
    n_ops = [generate.client_ops(r) for r in records]
    failures: list = []
    host: list = []

    def one(i: int):
        port.clear_memo()
        try:
            with port.span("perfbench.check"):
                out = entry.check(prepared[i])
            sync()
            return out
        except Exception:  # noqa: BLE001 — a check that raised has no verdict
            failures.append(traceback.format_exc())
            return None

    one(0)
    port.clear_memo()
    # The pool is the harness's and lives through the run: kept out of
    # the collector's scans, which otherwise walk every op of it at
    # random instants of the window.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    port.spans_on(trace)
    before = port.counts()
    checks: list = []
    spans: list = []
    dropped = 0
    h0 = _host()
    t0 = h0[0]
    while True:
        i = len(checks) % len(prepared)
        checks.append((i, one(i)))
        host.append(_host())
        if trace:
            s, d = port.take_spans()
            spans += s
            dropped += d
        t1 = host[-1][0]
        if t1 - t0 >= seconds and not len(checks) % len(prepared):
            break
    answered = [(i, out) for i, out in checks if out is not None]
    steps = [tuple(round(y - x, 4) for x, y in zip(a, b))
             for a, b in zip([h0] + host, host)]
    print(f"perfbench: {cell.name} seed {seed}: {len(checks)} checks in "
          f"{t1 - t0:.4f} s, set-up {setup_s:.4f} s; process CPU user "
          f"{host[-1][1] - h0[1]:.4f} s, system {host[-1][2] - h0[2]:.4f} "
          f"s; each check's (wall s, user s, system s): {steps}", file=log)
    for f in failures[:3]:
        print(f, file=log)
    ctx = {
        "setup_s": setup_s,
        "window": {"seconds": t1 - t0, "checks": len(answered),
                   "client_ops": sum(n_ops[i] for i, _ in answered)},
    }
    if trace:
        ctx["counts"] = port.count_delta(before, port.counts())
        ctx["spans"], ctx["spans_dropped"] = spans, dropped
        slice_ = range(int(cell.traffic["profile_checks"]))
        port.spans_on(False)
        with port.counting_sweep_bytes() as tally:
            for i in slice_:
                one(i)
        port.spans_on(True)
        l0 = port.counts()["launches"].get(port.SWEEP, 0)
        ctx["profile"] = (profile(lambda: [one(i) for i in slice_],
                                  port.take_spans, port.span)
                          if profile else None)
        ctx["sweep"] = dict(
            tally, profiled_launches=port.counts()["launches"].get(
                port.SWEEP, 0) - l0)
        port.spans_on(False)
    return records, checks, ctx


def judge(cell: manifest.Cell, records: list, checks: list, ctx: dict,
          trace: bool, log=sys.stderr) -> dict:
    """The reference's verdicts on every history the window checked,
    compared with each check, and the cell's metrics -> the result's
    "correct", "attempted", "failed", "metrics" and "compared"."""
    deadline = time.monotonic() + REFERENCE_BUDGET_S
    try:
        truth = {i: reference.decide_keys(records[i], deadline)
                 for i in sorted({i for i, _ in checks})}
        compared = compare.compare(checks, truth,
                                   bool(cell.config["keyed"]))
    except reference.Undecided as e:
        print(f"perfbench: the reference decided no verdict: {e}", file=log)
        compared = {"reference_undecided": {"value": 1, "limit": 0}}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = manifest.reader(cell, m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    answered = [o for _, o in checks if o is not None]
    return {"correct": compare.correct(compared), "attempted": len(checks),
            "failed": len(checks) - len(answered) + sum(
                o["valid"] not in (True, False) for o in answered),
            "metrics": metrics, "compared": compared}


def host_entry(cell: manifest.Cell):
    """The cell's entry with the port on the CPU (tests)."""
    return manifest.load_module(cell.entry).Entry(cell.config, "cpu")


def run(cell: manifest.Cell, entry, seed: int, seconds: float,
        trace: bool = False, log=sys.stderr) -> dict:
    """One run on the host, with `entry` in the program's place: the
    port's entry built for the CPU, or the control
    (`perfbench/controls.py`).  Never a measurement."""
    records, checks, ctx = window(cell, entry, seed, seconds, trace,
                                  lambda: None, log=log)
    ctx["device_name"] = "cpu"
    return judge(cell, records, checks, ctx, trace, log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    clean_env()
    cell = manifest.load(args.workload)

    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); torch sees {have}", file=sys.stderr)
        return 2
    # One intra-op thread: the port's host work is serial dispatch, and
    # the card's host is shared; eight threads only contend for it.
    torch.set_num_threads(1)
    from perfbench import trace as tr

    entry = manifest.load_module(cell.entry).Entry(cell.config, "cuda")
    records, checks, ctx = window(cell, entry, args.seed, args.seconds,
                                  bool(args.trace), torch.cuda.synchronize,
                                  profile=tr.profiled)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": torch.cuda.max_memory_allocated(0),
              "power_limit_w": power_limit_w()}
    # The port's state goes before the reference runs.
    del entry
    gc.collect()
    torch.cuda.empty_cache()
    ctx["device_name"] = device["kind"]
    out = judge(cell, records, checks, ctx, bool(args.trace))
    p = ctx.get("profile")
    if p:
        device["busy_s"], device["window_s"] = p["busy_s"], p["window_s"]
    result = {k: out[k] for k in ("correct", "attempted", "failed",
                                  "metrics")}
    result["device"] = device
    if p:
        result["breakdown"] = {"device_ops": _top(p["kernel_s"]),
                               "idle_gaps": _top(p["gaps_s"])}
    result["compared"] = out["compared"]
    bad = banned_modules()
    if bad:
        print(f"perfbench: loaded after the window: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
