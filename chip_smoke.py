#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (jepsen_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc): the witness sweep
kernel is built from jepsen_tpu_torch/csrc/ into build/jepsen_tpu_torch/
at first use.  Exits non-zero, printing no result, when torch sees no
CUDA device or the package is missing.  Three phases, each raising on
failure:

1. The sweep kernel against its plain PyTorch version at the bench
   shapes (B = 8, SW = 1, K = 2048, W = the bench history's planned
   window) and at B = 32: sweep inputs recorded from a witness run on
   the bench history, plus random tables that die mid-block, start
   past 0, or end in padding.  States, alive and death must match
   exactly.  Times the kernel (CUDA events) and the plain version, and
   sets the kernel's time beside its byte bound and beside the floor
   of its serial chain (the library's chain probe: the per-barrier
   model step, ballot and commit with no loads, times the barriers).
2. The main path: `Linearizable(cas_register(), "wgl-tpu").check` on
   the 100k-op, 5%-info, 16-process cas-register history (seed 45100),
   warmed up first; median of 3 wall times, with the kernel's launch
   count, chain-search rounds and host syncs of those runs.
3. The invalid path: `check_wgl_device` on a 2k-op history with an
   impossible read — the witness must die, the frontier BFS runs on the
   card, and the verdict (False) must equal the exact CPU engine's.

The last lines are the kernels JSON line, the card's name and power
limit from nvidia-smi, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

#: H100 SXM device-memory rate (NVIDIA data sheet), for the bound.
HBM_BYTES_PER_S = 3.35e12

BENCH_OPS, BENCH_PROCS, BENCH_INFO, BENCH_SEED = 100_000, 16, 0.05, 45100


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of `fn` on the card (CUDA events
    around `reps` back-to-back calls, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> float:
    """Mean milliseconds per call, host clock, synchronized."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def sweep_bytes(start_k: int, death: int, K: int, cols: list,
                B: int, SW: int) -> int:
    """Bytes the sweep must move for this input: the bars columns it
    reads (start_k .. death, 5 words each: window column, real, f, a0,
    a1; the ret row is never read), each distinct member word those
    barriers name, the states and alive read once, and the outputs
    written once."""
    last = min(death, K - 1)
    n = max(0, last - start_k + 1)
    distinct = len(set(cols[start_k:last + 1])) if n else 0
    return 4 * (5 * n + distinct + 2 * (SW * B + B) + 1)


def chain_step_ns(torch) -> float:
    """Nanoseconds per step of the sweep's serial chain with no loads
    (the kernel library's chain probe: model step, death ballot and
    commit), from CUDA events around probes of N and 2N steps, so the
    launch cost cancels."""
    from jepsen_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    n = 1 << 20
    t_n = cuda_ms(lambda: kernels.sweep_chain_probe(n, dev), reps=5)
    t_2n = cuda_ms(lambda: kernels.sweep_chain_probe(2 * n, dev), reps=5)
    out = kernels.sweep_chain_probe(n, dev)
    if int(out[32].item()) != n:
        raise AssertionError(f"chain probe stopped at {int(out[32])}")
    return (t_2n - t_n) * 1e6 / n


def phase_kernel(torch, packed, pm, W, seed: int) -> dict:
    """Kernel vs plain on recorded and random inputs; returns the
    kernel's JSON entry (launches filled in by the caller)."""
    import numpy as np

    from jepsen_tpu_torch.ops import kernels, wgl_witness
    from jepsen_tpu_torch.ops.wgl_witness import pack_member_bits, sweep_plain

    dev = torch.device("cuda")
    step_rows = pm.torch_step_rows

    # Record the sweep inputs of one witness run on the bench history.
    recorded = []
    real_sweep = wgl_witness.sweep

    def recording_sweep(pm_, start_k, bars, member, states, alive):
        out = real_sweep(pm_, start_k, bars, member, states, alive)
        recorded.append((start_k, bars, member, states, alive, out[2]))
        return out

    wgl_witness.sweep = recording_sweep
    try:
        res = wgl_witness.check_wgl_witness(packed, pm, device=dev)
    finally:
        wgl_witness.sweep = real_sweep
    if res is None or res.valid is not True:
        raise AssertionError(f"witness on the bench history: {res}")
    log(f"phase1: recorded {len(recorded)} sweep calls from the bench "
        f"witness (W={recorded[0][2].shape[0]}, B={recorded[0][2].shape[1]})")

    def run_kernel(start_k, bars, member, states, alive):
        s, al, d = kernels.witness_sweep(
            pm.kernel_model, start_k, bars, pack_member_bits(member),
            states.T.contiguous(), alive.to(torch.int32))
        return s.T, al != 0, int(d.item())

    cases = []
    # Recorded: the first call, the longest sweep, and calls that start
    # mid-block (after a chain search).
    longest = max(recorded, key=lambda r: min(r[5], r[1].shape[1]) - r[0])
    mid = [r for r in recorded if r[0] > 0][:12]
    for name, r in ([("bench-first", recorded[0]), ("bench-longest", longest)]
                    + [(f"bench-resume{i}", r) for i, r in enumerate(mid)]):
        cases.append((name, r[:5]))

    # Random tables at B = 8 and B = 32 (bit 31 = lane 31).
    rng = np.random.default_rng(seed)
    K = wgl_witness.BARS_PER_BLOCK
    for B in (8, 32):
        member_np = rng.random((W, B)) < 0.3
        member_np[:, 0] = True  # lane 0 passes: the clean table runs to K
        member = torch.from_numpy(member_np).to(dev)
        states = torch.from_numpy(
            rng.integers(0, 5, size=(B, 1)).astype(np.int32)).to(dev)
        alive_np = rng.random(B) < 0.7
        alive_np[0] = True
        alive = torch.from_numpy(alive_np).to(dev)
        bars = np.zeros((6, K), dtype=np.int32)
        bars[0] = rng.integers(0, W, size=K)
        bars[1] = np.arange(K)
        bars[2] = 1
        bars[3] = rng.integers(0, 3, size=K)
        bars[4] = rng.integers(0, 5, size=K)
        bars[5] = rng.integers(0, 5, size=K)
        pad_from = K - 300
        bars[2, pad_from:] = 0  # a padding tail: nothing real to die on
        clean = torch.from_numpy(bars.copy()).to(dev)
        # A planted death at K/2: a read of a value nobody holds, at a
        # window column with no member bits (lane 0 must step it too).
        bars[0, K // 2] = W - 1
        bars[3, K // 2] = 0
        bars[4, K // 2] = 99
        planted = torch.from_numpy(bars).to(dev)
        member_p = member.clone()
        member_p[W - 1] = False
        if B == 32:
            member_p[: W - 1, 31] = True  # the sign bit in every word
        cases += [
            (f"rand{B}-clean", (0, clean, member, states, alive)),
            (f"rand{B}-death", (0, planted, member_p, states, alive)),
            (f"rand{B}-after-death", (K // 2 + 1, planted, member_p,
                                      states, alive)),
            (f"rand{B}-padding", (pad_from + 5, planted, member_p, states,
                                  alive)),
        ]

    max_err = 0
    for name, (start_k, bars, member, states, alive) in cases:
        ks, ka, kd = run_kernel(start_k, bars, member, states, alive)
        ps, pa, pd = sweep_plain(start_k, bars, member, states, alive,
                                 step_rows)
        torch.cuda.synchronize()
        max_err = max(max_err, abs(kd - pd),
                      int((ks.long() - ps.long()).abs().max()),
                      int((ka.long() - pa.long()).abs().max()))
        if not (torch.equal(ks, ps) and torch.equal(ka, pa) and kd == pd):
            raise AssertionError(
                f"witness_sweep != sweep_plain on {name}: death {kd} vs "
                f"{pd}, states equal {torch.equal(ks, ps)}, alive equal "
                f"{torch.equal(ka, pa)}")
        log(f"phase1: {name:>20} start={start_k:5d} death={kd:5d} "
            f"B={member.shape[1]:2d} match")

    step_ns = chain_step_ns(torch)
    log(f"phase1: serial chain floor {step_ns:.4f} ns per barrier "
        f"(register step + ballot + commit, no loads)")

    def timed(name):
        """(barriers swept, kernel ms, plain ms, bytes, bound ms, chain
        floor ms) of one case: the kernel alone (CUDA events over many
        launches), the plain version, the byte bound for this input,
        and its barriers times the serial chain's step."""
        start_k, bars, member, states, alive = dict(cases)[name]
        mbits = pack_member_bits(member)
        st_t = states.T.contiguous()
        al_i = alive.to(torch.int32)
        _, _, death = run_kernel(start_k, bars, member, states, alive)
        K = bars.shape[1]
        swept = min(death, K - 1) - start_k + 1
        ms = cuda_ms(lambda: kernels.witness_sweep(
            pm.kernel_model, start_k, bars, mbits, st_t, al_i), reps=200)
        plain = wall_ms(lambda: sweep_plain(
            start_k, bars, member, states, alive, step_rows), reps=3)
        nbytes = sweep_bytes(start_k, death, K, bars[0].tolist(),
                             member.shape[1], states.shape[1])
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        floor = swept * step_ns / 1e6
        log(f"phase1: timing {name}: {swept} barriers, kernel {ms:.6f} ms "
            f"({ms * 1e3 / swept:.4f} us/barrier), plain {plain:.3f} ms, "
            f"bound {bound:.9f} ms ({nbytes} B at {HBM_BYTES_PER_S:.3g} "
            f"B/s), serial chain floor {floor:.6f} ms")
        return swept, ms, plain, nbytes, bound, floor

    # The JSON line reports the longest real sweep of the main path; the
    # full random block (K barriers) is printed beside it.
    swept, ms, plain_ms, _, bound_ms, floor_ms = timed("bench-longest")
    timed("rand8-clean")
    log("phase1: library_ms null: no single PyTorch call computes an "
        "early-exit serial sweep")
    return {
        "name": "witness_sweep",
        "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/witness_sweep.cu",
        "replaces": "jepsen_tpu/ops/wgl_witness.py:332",
        "launches": 0,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "chain_floor_ms": floor_ms,
        "chain_step_ns": step_ns,
        "barriers_timed": swept,
        "cases_matched": len(cases),
    }


def phase_main(torch, history, n_packed: int) -> dict:
    from jepsen_tpu_torch import device as D
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import kernels
    from jepsen_tpu_torch.utils.histgen import random_register_history

    warm = random_register_history(4096, procs=BENCH_PROCS,
                                   info_rate=BENCH_INFO, seed=7)
    out = Linearizable(cas_register(), "wgl-tpu").check({}, warm, {})
    if out["valid"] is not True:
        raise AssertionError(f"warm-up verdict {out}")
    torch.cuda.synchronize()

    kernels.launches.clear()
    D.counters.clear()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = Linearizable(cas_register(), "wgl-tpu").check({}, history, {})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if out["valid"] is not True or out["algorithm"] != "wgl-tpu":
            raise AssertionError(f"main path verdict {out}")
    launches = kernels.launches["witness_sweep"]
    counts = dict(D.counters)
    if launches <= 0:
        raise AssertionError("main path made no witness_sweep launch")
    med = statistics.median(times)
    r = {
        "wall_s": times,
        "median_s": med,
        "ops_per_s": n_packed / med,
        "sweep_launches": launches,
        "sweep_launches_per_check": launches / 3,
        "heavy_rounds_per_check": counts.get("heavy_rounds", 0) / 3,
        "host_syncs_per_check": counts.get("host_syncs", 0) / 3,
    }
    log("phase2: " + json.dumps(r))
    r["breakdown"] = breakdown(torch, history)
    log("phase2: breakdown " + json.dumps(r["breakdown"]))
    return r


def breakdown(torch, history) -> dict:
    """Where one main-path check spends its time, stage by stage (host
    clock), and the card's busy time in the device search from
    torch.profiler.  Runs after the counted runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jepsen_tpu_torch.checker.refute import check_refute
    from jepsen_tpu_torch.history.packed import pack_history
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops.wgl import check_wgl_device

    pm = cas_register().packed()
    t0 = time.perf_counter()
    packed = pack_history(history, pm.encode)
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    if check_refute(packed, pm) is not None:
        raise AssertionError("refutation screen fired on a valid history")
    t_refute = time.perf_counter() - t0
    t0 = time.perf_counter()
    check_wgl_device(packed, pm, device="cuda")
    torch.cuda.synchronize()
    t_device = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        check_wgl_device(packed, pm, device="cuda")
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    kernels_us = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels_us[e.key] = (kernels_us.get(e.key, 0.0)
                                 + e.self_device_time_total)
    busy_s = sum(kernels_us.values()) / 1e6
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:8]
    return {
        "pack_s": t_pack,
        "refute_s": t_refute,
        "device_search_s": t_device,
        "profiled_device_search_s": t_prof,
        "device_busy_s": busy_s,
        "device_idle_share": (1.0 - busy_s / t_prof) if busy_s else None,
        "top_device_kernels_us": top,
    }


def phase_invalid(torch) -> dict:
    from jepsen_tpu_torch import device as D
    from jepsen_tpu_torch.checker.wgl_cpu import check_wgl_cpu
    from jepsen_tpu_torch.history.packed import pack_history
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import kernels
    from jepsen_tpu_torch.ops.wgl import check_wgl_device
    from jepsen_tpu_torch.ops.wgl_witness import check_wgl_witness
    from jepsen_tpu_torch.utils.histgen import random_register_history

    pm = cas_register().packed()
    h = random_register_history(2000, procs=8, info_rate=0.0,
                                seed=BENCH_SEED, bad=True)
    packed = pack_history(h, pm.encode)
    info: dict = {}
    if check_wgl_witness(packed, pm, out_info=info, device="cuda") is not None:
        raise AssertionError("witness found a linearization of a bad history")
    kernels.launches.clear()
    D.counters.clear()
    t0 = time.perf_counter()
    res = check_wgl_device(packed, pm, time_limit_s=300, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    levels = D.counters.get("bfs_levels", 0)
    cpu = check_wgl_cpu(packed, pm)
    if res.valid is not False or cpu.valid is not False or levels <= 0:
        raise AssertionError(
            f"invalid path: device {res.valid} ({res.reason}), cpu "
            f"{cpu.valid}, bfs levels {levels}")
    r = {
        "ops": packed.n,
        "died_at_rank": info.get("died_at_rank"),
        "device_valid": res.valid,
        "cpu_valid": cpu.valid,
        "wall_s": dt,
        "bfs_levels": levels,
        "sweep_launches": kernels.launches["witness_sweep"],
        "host_syncs": D.counters.get("host_syncs", 0),
    }
    log("phase3: " + json.dumps(r))
    return r


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from jepsen_tpu_torch.history.packed import pack_history
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import kernels
    from jepsen_tpu_torch.ops.wgl_witness import plan_width
    from jepsen_tpu_torch.utils.histgen import random_register_history

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); nvidia-smi: {smi}")

    t0 = time.perf_counter()
    kernels.sweep_lib()
    log(f"build: {time.perf_counter() - t0:.3f} s")
    for line in kernels.build_log.strip().splitlines():
        log(f"build[witness_sweep]: {line}")

    t0 = time.perf_counter()
    history = random_register_history(BENCH_OPS, procs=BENCH_PROCS,
                                      info_rate=BENCH_INFO, seed=BENCH_SEED)
    t_gen = time.perf_counter() - t0
    pm = cas_register().packed()
    t0 = time.perf_counter()
    packed = pack_history(history, pm.encode)
    t_pack = time.perf_counter() - t0
    W = plan_width(packed)
    log(f"bench history: {packed.n} packed ops ({packed.n_ok} ok), "
        f"generate {t_gen:.3f} s, pack {t_pack:.3f} s, window W={W}")

    entry = phase_kernel(torch, packed, pm, W, seed=BENCH_SEED)
    main_r = phase_main(torch, history, packed.n)
    entry["launches"] = main_r["sweep_launches"]
    bad_r = phase_invalid(torch)

    log(f"phase3 done; main path {main_r['ops_per_s']:.1f} ops/s, "
        f"invalid path {bad_r['wall_s']:.3f} s")
    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
