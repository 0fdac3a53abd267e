"""What merging costs in the checker daemon: the same runs as one merged
cohort and as separate submissions, and the stream pass alone at the
merged and the per-run post-death segment.

    python3 tools/daemon_ab.py [--device cuda] [--keys 200] [--bad 30]
                               [--runs 4] [--reps 2] [--trials 3]
                               [--out chiprun_out/daemon_ab.json]

The runs are chip_smoke.py phase 10a's: `--runs` run_mixed-shaped
cas-register histories of `--keys` keys (keys 0 .. `--bad` - 1 bad),
seeds DAEMON_SEED * (r + 1).  Telemetry is on throughout, as in phase
10, and the settle memo is cleared before every check.

(1) "daemon": one in-process checkerd (chip_smoke's 1 s window, its
    profile store, no plan memo, so a repeated history is checked
    again), the runs submitted in turns: "merged" (every run at once,
    uploads aligned at COMMIT: one cohort) and "apart" (one run after
    another: a cohort each), in the order merged, apart, apart, merged
    (repeated `--reps` / 2 times).  Per turn: each run's check-s (the
    daemon's own timing of its cohort), merged-runs, and the card's
    counts (stream passes and restarts, chain rounds, host syncs, sweep
    launches) and the stream records' segment (profile store).
(2) "stream": the stream witness alone (`check_wgl_witness_stream`,
    in-process) on the runs' per-key packs: every run's packs in one
    call at the default segment (max(8, ceil(K / 8)) keys for K keys),
    the same call at the per-run segment, and one call per run; wall
    (host clock, the card synchronized) and counts, in turns.
(3) "telemetry": one run through `IndependentChecker` in-process with
    telemetry off and on, in turns (off, on, on, off).
(4) "window": a daemon with a 0.25 s batch window, the runs submitted
    at once `--trials` times: merged-runs and the spread of their queue
    waits each time.

Prints the card's name and power limit (nvidia-smi), then one line
"DAEMON_AB {json}" with every reading, also written to --out.  Exits 1
if a run's verdict differs between the turns.
"""
import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

COUNTS = ("stream_passes", "stream_restarts", "stream_keys_proven",
          "heavy_rounds", "host_syncs")


def card_counts(D, kernels) -> dict:
    """This turn's device counters and sweep launches (cleared by the
    caller before the turn)."""
    out = {name: D.counters.get(name, 0) for name in COUNTS}
    out["sweep_launches"] = kernels.launches["witness_sweep"]
    return out


def stream_records(profile, seen: int) -> tuple:
    """The stream records the profile store got after its first `seen`
    -> ([{keys, segment, passes, restarts, execute_s}], records now)."""
    recs = profile.read(profile.store_path())
    out = [{"keys": r["features"].get("keys"),
            "segment": r["plan"].get("segment"),
            "passes": r["features"].get("passes"),
            "restarts": r["features"].get("restarts"),
            "execute_s": r["timing"].get("execute_s")}
           for r in recs[seen:] if r.get("pass") == "stream"]
    return out, len(recs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--keys", type=int, default=200)
    ap.add_argument("--bad", type=int, default=30)
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "daemon_ab.json"))
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from jepsen_tpu_torch import device as D
    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.history.packed import pack_history
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import kernels
    from jepsen_tpu_torch.ops.wgl_stream import check_wgl_witness_stream
    from jepsen_tpu_torch.parallel import IndependentChecker, \
        clear_settle_memo, subhistories
    from jepsen_tpu_torch.plan import cache as plan_cache
    from jepsen_tpu_torch.telemetry import flight, profile, slo

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        kernels.sweep_lib()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    runs = {f"run{r}": cs.mixed_history(args.keys, args.bad,
                                        seed0=cs.DAEMON_SEED * (r + 1))
            for r in range(args.runs)}
    pm = cas_register().packed()
    packs = {run: [pack_history(sub, pm.encode)
                   for sub in subhistories(h).values()]
             for run, h in runs.items()}
    out: dict = {"device": str(dev), "keys": args.keys, "bad": args.bad,
                 "runs": args.runs}
    verdicts: dict = {}
    bad_verdict = []

    def note_verdict(run, res, turn):
        view = {k: r["valid"] for k, r in res["results"].items()}
        if verdicts.setdefault(run, view) != view:
            bad_verdict.append(f"{turn} {run}")

    tmp = tempfile.mkdtemp(prefix="daemon-ab-")
    prior = telemetry.enabled()
    telemetry.enable(True)
    try:
        # A warm-up check: the first call's costs fall in no turn.
        clear_settle_memo()
        IndependentChecker(Linearizable(cas_register(), time_limit_s=120,
                                        device=dev), device=dev).check(
            {}, runs["run0"], {})

        # (1) merged against apart through one daemon.
        d = cs._Daemon(dev, os.path.join(tmp, "ab"), memo=False)
        seen = 0
        turns = []
        try:
            order = ["merged", "apart", "apart", "merged"]
            for i, kind in enumerate(order * max(1, args.reps // 2)):
                clear_settle_memo()
                D.counters.clear()
                kernels.launches.clear()
                got = {}
                t0 = time.perf_counter()
                if kind == "merged":
                    barrier = threading.Barrier(args.runs,
                                                timeout=cs.DAEMON_WAIT_S)
                    errors = []

                    def submit(run):
                        try:
                            got[run] = cs.daemon_check(
                                torch, dev, runs[run], run, d.addr, barrier)
                        except Exception as e:  # noqa: BLE001 — below
                            errors.append(f"{run}: {e!r}")

                    threads = [threading.Thread(target=submit, args=(r,))
                               for r in runs]
                    for th in threads:
                        th.start()
                    for th in threads:
                        th.join(cs.DAEMON_WAIT_S)
                    if errors:
                        raise AssertionError(f"merged turn: {errors}")
                else:
                    for run in runs:
                        got[run] = cs.daemon_check(torch, dev, runs[run],
                                                   run, d.addr)
                wall = time.perf_counter() - t0
                recs, seen = stream_records(profile, seen)
                per_run = {}
                for run, (res, client_s) in sorted(got.items()):
                    note_verdict(run, res, f"daemon {i} {kind}")
                    meta = res["checkerd"]
                    per_run[run] = {"check_s": meta["check-s"],
                                    "queue_wait_s": meta["queue-wait-s"],
                                    "merged_runs": meta.get("merged-runs"),
                                    "client_s": client_s}
                checks = [r["check_s"] for r in per_run.values()]
                turn = {"turn": i, "kind": kind, "wall_s": wall,
                        # One cohort's check-s is every member's; apart,
                        # the cohorts' check-s add up.
                        "check_s": (max(checks) if kind == "merged"
                                    else sum(checks)),
                        "runs": per_run, "counts": card_counts(D, kernels),
                        "stream_records": recs}
                print(f"daemon {json.dumps(turn)}", flush=True)
                turns.append(turn)
        finally:
            d.stop()
        out["daemon"] = {
            "turns": turns,
            "median_check_s": {
                kind: statistics.median(t["check_s"] for t in turns
                                        if t["kind"] == kind)
                for kind in ("merged", "apart")}}

        # (2) the stream pass alone.
        merged = [p for run in runs for p in packs[run]]
        per_run_seg = max(8, -(-args.keys // 8))

        def stream_call(kind):
            clear_settle_memo()
            D.counters.clear()
            kernels.launches.clear()
            sync()
            t0 = time.perf_counter()
            if kind == "merged-default":
                v = check_wgl_witness_stream(merged, pm, device=dev)
            elif kind == "merged-run-segment":
                v = check_wgl_witness_stream(merged, pm, device=dev,
                                             segment_keys=per_run_seg)
            else:
                v = [x for run in runs
                     for x in check_wgl_witness_stream(packs[run], pm,
                                                       device=dev)]
            sync()
            wall = time.perf_counter() - t0
            return {"kind": kind, "wall_s": wall,
                    "proven": sum(1 for x in v if x is True),
                    "counts": card_counts(D, kernels)}

        order = ["merged-default", "merged-run-segment", "apart",
                 "apart", "merged-run-segment", "merged-default"]
        calls = []
        for kind in order * max(1, args.reps // 2):
            c = stream_call(kind)
            print(f"stream {json.dumps(c)}", flush=True)
            calls.append(c)
        out["stream"] = {
            "segment": {"merged-default": max(8, -(-len(merged) // 8)),
                        "merged-run-segment": per_run_seg,
                        "apart": per_run_seg},
            "calls": calls,
            "median_wall_s": {k: statistics.median(
                c["wall_s"] for c in calls if c["kind"] == k)
                for k in dict.fromkeys(order)}}

        # (3) telemetry off against on, in-process, one run.
        chk = IndependentChecker(Linearizable(cas_register(),
                                              time_limit_s=120, device=dev),
                                 device=dev)
        tel = []
        for on in (False, True, True, False) * max(1, args.reps // 2):
            telemetry.enable(on)
            clear_settle_memo()
            sync()
            t0 = time.perf_counter()
            res = chk.check({}, runs["run0"], {})
            sync()
            tel.append({"telemetry": on,
                        "wall_s": time.perf_counter() - t0})
            note_verdict("run0", res, f"telemetry {on}")
        telemetry.enable(True)
        out["telemetry"] = {
            "walls": tel,
            "median_wall_s": {str(on).lower(): statistics.median(
                t["wall_s"] for t in tel if t["telemetry"] is on)
                for on in (False, True)}}
        print(f"telemetry {json.dumps(out['telemetry'])}", flush=True)

        # (4) the 0.25 s window.
        d = cs._Daemon(dev, os.path.join(tmp, "window"), window=0.25,
                       memo=False)
        trials = []
        try:
            for _ in range(args.trials):
                clear_settle_memo()
                got = {}
                barrier = threading.Barrier(args.runs,
                                            timeout=cs.DAEMON_WAIT_S)

                def submit_w(run):
                    got[run] = cs.daemon_check(torch, dev, runs[run], run,
                                               d.addr, barrier)

                threads = [threading.Thread(target=submit_w, args=(r,))
                           for r in runs]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(cs.DAEMON_WAIT_S)
                waits = [res["checkerd"]["queue-wait-s"]
                         for res, _ in got.values()]
                trial = {"merged_runs": sorted(
                    res["checkerd"].get("merged-runs") or 1
                    for res, _ in got.values()),
                    "commit_spread_s": max(waits) - min(waits)}
                for run, (res, _) in got.items():
                    note_verdict(run, res, "window")
                print(f"window {json.dumps(trial)}", flush=True)
                trials.append(trial)
        finally:
            d.stop()
        out["window_0.25"] = trials
    finally:
        telemetry.enable(prior)
        profile.set_store(None)
        flight.set_dir(None)
        slo.reset()
        plan_cache.reset_for_tests()
        clear_settle_memo()
        shutil.rmtree(tmp, ignore_errors=True)

    out["verdicts_equal"] = not bad_verdict
    line = json.dumps(out)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print("DAEMON_AB " + line, flush=True)
    if bad_verdict:
        print(f"verdicts differ between turns: {bad_verdict}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
