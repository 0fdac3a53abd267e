#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (jepsen_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc): the witness sweep
kernel is built from jepsen_tpu_torch/csrc/ into build/jepsen_tpu_torch/
at first use.  Exits non-zero, printing no result, when torch sees no
CUDA device or the package is missing.  Seven phases, each raising on
failure, run in the order 1, 2, 5, 6, 1b, 3, 4 (every host-clock and
CUDA-event timing before the profiler first runs):

1. The sweep kernel against its plain PyTorch version at the bench
   shapes (B = 8, SW = 1, K = 2048, W = the bench history's planned
   window) and at B = 1 and 32: sweep inputs recorded from a witness
   run on the bench history, plus random tables that die mid-block,
   start past 0, or end in padding, and the kernel's 32-barrier batch
   edges (starts 31 and 33, deaths at batch offsets 0 and 31, B = 1),
   recorded and random.  States, alive and death must match exactly.
   Times back-to-back launches of the kernel's wrapper (CUDA events:
   the JSON's `ms`; and the host clock) and the `sweep()` call the main
   path makes (wrapper, kernel, death read: `call_ms`, host clock; and
   CUDA events); sets the kernel's time beside its byte bound and
   beside its step floor (the library's chain probe: one lane's
   dependent per-barrier step with no loads and no vote, times the
   barriers).
2. The main path: `Linearizable(cas_register(), "wgl-tpu").check` on
   the 100k-op, 5%-info, 16-process cas-register history (seed 45100),
   warmed up first; median of 3 wall times, with the kernel's launch
   count, chain-search rounds and host syncs of those runs.
3. Under torch.profiler: the kernel's device time (`device_ms`) and
   the device operations of one `sweep()` call (must be 2), then the
   back-to-back timing of phase 1 again; then one profiled device
   search of the main path: the card's busy time and idle share, its
   kernel launches and copies, and the sweep kernel's device time.
   Every host-clock and CUDA-event timing of phases 1 and 2 runs
   before the script first starts torch.profiler, so none is taken in
   a process the profiler has touched; the repeat shows what that
   changes.
4. The invalid path: `check_wgl_device` on a 2k-op history with an
   impossible read — the witness must die, the frontier BFS runs on the
   card, and the verdict (False) must equal the exact CPU engine's.
5. The many-key path, bench.py run_mixed's shape: `IndependentChecker(
   Linearizable(cas_register(), time_limit_s=120))` on 200 keys x 100
   ops (4 processes, 5% :info, seed i for key i, keys 0-29 bad); one
   warm-up (its sweep calls recorded), then a median of 3 with the
   settle memo cleared before each.  Must return valid False with 30
   failures, every per-key verdict equal to the exact CPU engine's.
   Reports ops/s (history length / 2 / median, the reference's metric),
   the keys each tier settled, and per check the stream passes and
   restarts, sweep launches, BFS levels and host syncs.  Then the same
   readings for an all-valid 2,000-key (200k-op) check.
6. The other models: a 200-key x 100-op history each of the mutex, a
   5-register multi-register, the FIFO and the unordered queue (every
   7th key bad, one long key past the ladder's 2,000-op bound), once
   recorded, once counted.  Every per-key verdict equals the exact CPU
   engine's and both of the model's sweep instantiations (plain and
   stream) launched.
1b. Every other sweep instantiation (each model plain and stream, the
   multi-register at 3 and 5 registers) against the plain version,
   exactly, on the calls recorded in phases 5 and 6 and on random tables
   at B = 1, 8 and 32 with RESET barriers and batch-edge starts and
   deaths; then the instantiations of phases 5 and 6 timed on their
   longest recorded call.  Their device time is read in phase 3, and
   each one's registers and spills from the build's -Xptxas -v output.
   Also the batched BFS on each model's cohort recorded in phases 5
   and 6: levels, host syncs and wall time; its device time in phase 3.

The last lines are the kernels JSON line (one entry per timed
instantiation), the card's name and power limit from nvidia-smi, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import subprocess
import sys
import time

#: H100 SXM device-memory rate (NVIDIA data sheet), for the bound.
HBM_BYTES_PER_S = 3.35e12

BENCH_OPS, BENCH_PROCS, BENCH_INFO, BENCH_SEED = 100_000, 16, 0.05, 45100


# ---------------------------------------------------------------------------
# Seeded per-key histories of the other models (the tests use them too).
# Each generator returns one key's ops as dicts (type, f, value,
# process); `keyed_history` wraps them into a many-key history of either
# package.  Effects apply at completion, so a history is linearizable
# unless it is bad: a bad key ends with ops that no linearization
# allows, appended after every other op has completed.


def mutex_ops(n_ops: int, seed: int, bad: bool, procs: int = 4,
              info: float = 0.05) -> list:
    """Processes acquire and release one lock.  An acquire of a held
    lock fails; an acquire may end :info (it took the lock or not, by a
    coin); releases are determinate.  Bad: two :ok acquires in a row
    with no release between them."""
    rng = random.Random(seed)
    holder = None
    ops, pending = [], {}
    started = 0
    while started < n_ops or pending:
        p = rng.randrange(procs)
        if p in pending:
            f, as_info = pending.pop(p)
            if f == "acquire":
                if holder is None and (not as_info or rng.random() < 0.5):
                    holder = p
                typ = ("info" if as_info else
                       "ok" if holder == p else "fail")
            else:
                holder = None
                typ = "ok"
            ops.append(dict(type=typ, f=f, value=None, process=p))
        elif started < n_ops:
            f = "release" if holder == p else "acquire"
            pending[p] = (f, f == "acquire" and rng.random() < info)
            ops.append(dict(type="invoke", f=f, value=None, process=p))
            started += 1
    if bad:
        for p in (procs, procs + 1):
            ops += [dict(type="invoke", f="acquire", value=None, process=p),
                    dict(type="ok", f="acquire", value=None, process=p)]
    return ops


def multi_register_ops(n_ops: int, seed: int, bad: bool, n_regs: int = 5,
                       procs: int = 4, info: float = 0.05) -> list:
    """Reads and writes of `n_regs` registers r0.. (all 0 at first),
    values 0-4; a write may end :info (applied by a coin).  Bad: a read
    of a value never written."""
    rng = random.Random(seed)
    vals = [0] * n_regs
    ops, pending = [], {}
    started = 0
    while started < n_ops or pending:
        p = rng.randrange(procs)
        if p in pending:
            f, r, v, as_info = pending.pop(p)
            if f == "write" and (not as_info or rng.random() < 0.5):
                vals[r] = v
            typ = "info" if as_info else "ok"
            value = (f"r{r}", vals[r] if f == "read" else v)
            ops.append(dict(type=typ, f=f, value=value, process=p))
        elif started < n_ops:
            f = rng.choice(["read", "write"])
            r, v = rng.randrange(n_regs), rng.randrange(5)
            pending[p] = (f, r, v, f == "write" and rng.random() < info)
            ops.append(dict(type="invoke", f=f, process=p,
                            value=(f"r{r}", None if f == "read" else v)))
            started += 1
    if bad:
        ops += [dict(type="invoke", f="read", value=("r0", None),
                     process=procs),
                dict(type="ok", f="read", value=("r0", 99), process=procs)]
    return ops


def queue_ops(n_ops: int, seed: int, bad: bool, procs: int = 4,
              info: float = 0.05, cap: int = 20) -> list:
    """Enqueues of distinct values and dequeues of the head (a dequeue
    of an empty queue fails), at most `cap` values queued, so the packed
    queues' 32 slots hold every reachable state; an enqueue may end
    :info (applied by a coin); dequeues are determinate, so the history
    packs.  Valid for the FIFO and the unordered queue alike.  Bad: a
    dequeue of a value never enqueued."""
    rng = random.Random(seed)
    queue: list = []
    ops, pending = [], {}
    started = nxt = 0
    while started < n_ops or pending:
        p = rng.randrange(procs)
        if p in pending:
            f, v, as_info = pending.pop(p)
            if f == "enqueue":
                if not as_info or rng.random() < 0.5:
                    queue.append(v)
                typ = "info" if as_info else "ok"
            elif queue:
                v, typ = queue.pop(0), "ok"
            else:
                typ = "fail"
            ops.append(dict(type=typ, f=f, value=v, process=p))
        elif started < n_ops:
            in_flight = sum(1 for q in pending.values() if q[0] == "enqueue")
            f = ("dequeue" if len(queue) + in_flight >= cap
                 else rng.choice(["enqueue", "dequeue"]))
            v = None
            if f == "enqueue":
                v, nxt = nxt, nxt + 1
            pending[p] = (f, v, f == "enqueue" and rng.random() < info)
            ops.append(dict(type="invoke", f=f, value=v, process=p))
            started += 1
    if bad:
        ops += [dict(type="invoke", f="dequeue", value=None, process=procs),
                dict(type="ok", f="dequeue", value=10**6, process=procs)]
    return ops


def keyed_history(gen, n_keys: int, n_ops: int, bad_keys, *, Op, kv,
                  history, long_key_ops: int = 0, **gen_kw):
    """A many-key history: key "k<i>" carries gen(n_ops, seed=i, bad=i in
    bad_keys, **gen_kw); with `long_key_ops`, one more valid key "long"
    of that many ops with no :info ops (past the ladder's long-key
    bound, and packable: an :info enqueue that never lands counts
    against a packed queue's capacity for good) is appended.  `Op`,
    `kv` and `history` are either package's."""
    ops = []
    keys = [(f"k{i}", n_ops, i, i in bad_keys, gen_kw)
            for i in range(n_keys)]
    if long_key_ops:
        keys.append(("long", long_key_ops, n_keys, False,
                     {**gen_kw, "info": 0.0}))
    for key, n, seed, bad, kw in keys:
        for d in gen(n, seed=seed, bad=bad, **kw):
            ops.append(Op(**{**d, "value": kv(key, d["value"])}))
    return history(ops)


def model_specs() -> list:
    """Phase 6's models: (name, model factory, generator, generator
    kwargs).  The FIFO queue's history has no :info enqueues and three
    processes: with either, the exact CPU engine that every verdict is
    held against runs past its budget on some keys (5M configurations
    on 60-op keys)."""
    from jepsen_tpu_torch import models as M

    return [
        ("mutex", M.mutex, mutex_ops, {}),
        ("multi-register",
         lambda: M.multi_register({f"r{i}": 0 for i in range(5)}),
         multi_register_ops, {}),
        ("fifo-queue", M.fifo_queue, queue_ops, {"procs": 3, "info": 0.0}),
        ("unordered-queue", M.unordered_queue, queue_ops, {}),
    ]


#: Invocations of phase 6's long key per model: past the ladder's 2,000
#: packed ops (a failed acquire packs to nothing, so the mutex needs
#: more), so the models' plain (non-stream) instantiations run too.
LONG_KEY_OPS = {"mutex": 6000}
LONG_KEY_OPS_DEFAULT = 2600


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
    a1; the ret row is never read), each distinct member row those
    barriers name (B bool bytes), the states (int32) and alive (bool)
    read once, and the outputs written once."""
    last = min(death, K - 1)
    n = max(0, last - start_k + 1)
    distinct = len(set(cols[start_k:last + 1])) if n else 0
    return 4 * 5 * n + B * distinct + 2 * (4 * SW * B + B) + 4


def chain_step_ns(torch) -> float:
    """Nanoseconds per barrier of one lane's dependent step chain with
    no loads and no vote (the kernel library's chain probe), from CUDA
    events around probes of N and 2N steps, so the launch cost
    cancels."""
    from jepsen_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    n = 1 << 20
    t_n = cuda_ms(lambda: kernels.sweep_chain_probe(n, dev), reps=5)
    t_2n = cuda_ms(lambda: kernels.sweep_chain_probe(2 * n, dev), reps=5)
    return (t_2n - t_n) * 1e6 / n


def profile_device(torch, fn, reps: int) -> dict:
    """{name: (count, microseconds)} of the kernels and copies that
    torch.profiler saw on the card over `reps` calls of `fn` (after a
    warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            n, us = seen.get(e.key, (0, 0.0))
            seen[e.key] = (n + e.count, us + e.self_device_time_total)
    return seen


def phase_kernel(torch, packed, pm, W, seed: int) -> tuple:
    """Kernel vs plain on recorded and random inputs; returns the
    kernel's JSON entry (launches and the profiler's numbers filled in
    later) and the timed cases, for `phase_profile`."""
    import numpy as np

    from jepsen_tpu_torch.ops import kernels, wgl_witness
    from jepsen_tpu_torch.ops.wgl_witness import sweep, sweep_plain

    dev = torch.device("cuda")
    step_rows = pm.torch_step_rows
    K = wgl_witness.BARS_PER_BLOCK

    # Record the sweep inputs of one witness run on the bench history.
    recorded = []
    real_sweep = wgl_witness.sweep

    def recording_sweep(pm_, start_k, bars, member, states, alive,
                        init=None):
        out = real_sweep(pm_, start_k, bars, member, states, alive, init)
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
        s, al, d = kernels.witness_sweep(pm.kernel_model, start_k, bars,
                                         member, states, alive)
        return s, al, int(d.item())

    def lane0(r):
        """A recorded input cut to its first beam lane (B = 1)."""
        return (r[0], r[1], r[2][:, :1].contiguous(), r[3][:1], r[4][:1])

    def at_offset(r, off):
        """Recorded call `r` restarted at d - 32 - off (d its death), so
        that d falls at offset `off` of the kernel's second 32-barrier
        batch; the states and alive there are the plain sweep's from the
        recorded start (run on the table cut short at the new start)."""
        start_k, bars, member, states, alive, d = r
        s2 = d - 32 - off
        if not start_k <= s2 < d < bars.shape[1]:
            raise AssertionError(f"recorded sweep {start_k}..{d} is too "
                                 f"short for a death at offset {off}")
        st, al, end = sweep_plain(start_k, bars[:, :s2].contiguous(),
                                  member, states, alive, step_rows)
        if end != s2:
            raise AssertionError(f"recorded sweep died at {end} < {s2}")
        return (s2, bars, member, st.contiguous(), al.contiguous())

    cases = []
    # Recorded: the first call, the longest sweep, calls that start
    # mid-block (after a chain search), the longest death's barrier moved
    # to batch offsets 0 and 31, the first call started at 31 and 33,
    # and lane 0 alone.
    first = recorded[0]
    longest = max(recorded, key=lambda r: min(r[5], r[1].shape[1]) - r[0])
    mid = [r for r in recorded if r[0] > 0][:12]
    for name, r in ([("bench-first", first), ("bench-longest", longest)]
                    + [(f"bench-resume{i}", r) for i, r in enumerate(mid)]):
        cases.append((name, r[:5]))
    dying = max((r for r in recorded if r[5] < K), key=lambda r: r[5] - r[0])
    cases += [(f"bench-death@{off}", at_offset(dying, off))
              for off in (0, 31)]
    cases += [("bench-first-start31", (31,) + first[1:5]),
              ("bench-first-start33", (33,) + first[1:5]),
              ("bench-first-B1", lane0(first)),
              ("bench-longest-B1", lane0(longest))]

    # Random tables at B = 1, 8 and 32 (bit 31 = lane 31).
    rng = np.random.default_rng(seed)
    for B in (1, 8, 32):
        member_np = rng.random((W, B)) < 0.3
        member_np[:, 0] = True  # lane 0 passes: the clean table runs to K
        member = torch.from_numpy(member_np).to(dev)
        states = torch.from_numpy(
            rng.integers(0, 5, size=(B, 1)).astype(np.int32)).to(dev)
        alive_np = rng.random(B) < 0.7
        alive_np[0] = True
        alive = torch.from_numpy(alive_np).to(dev)
        bars = np.zeros((6, K), dtype=np.int32)
        # Columns below W - 1: only the planted barriers name the
        # empty row W - 1, so lane 0 dies nowhere else.
        bars[0] = rng.integers(0, W - 1, size=K)
        bars[1] = np.arange(K)
        bars[2] = 1
        bars[3] = rng.integers(0, 3, size=K)
        bars[4] = rng.integers(0, 5, size=K)
        bars[5] = rng.integers(0, 5, size=K)
        pad_from = K - 300
        bars[2, pad_from:] = 0  # a padding tail: nothing real to die on
        clean_np = bars.copy()
        clean = torch.from_numpy(clean_np).to(dev)
        member_p = member.clone()
        member_p[W - 1] = False
        if B == 32:
            member_p[: W - 1, 31] = True  # the sign bit in every word

        def planted_at(k):
            """The clean table with a read of a value nobody holds at
            barrier k, at a window column with no member bits (lane 0
            must step it too)."""
            b = clean_np.copy()
            b[0, k], b[3, k], b[4, k] = W - 1, 0, 99
            return torch.from_numpy(b).to(dev)

        planted = planted_at(K // 2)
        cases += [
            (f"rand{B}-clean", (0, clean, member, states, alive)),
            (f"rand{B}-death", (0, planted, member_p, states, alive)),
            (f"rand{B}-after-death", (K // 2 + 1, planted, member_p,
                                      states, alive)),
            (f"rand{B}-padding", (pad_from + 5, planted, member_p, states,
                                  alive)),
        ]
        # Batch edges: starts 31 and 33, deaths at batch offsets 0 and 31.
        for start in (31, 33):
            for off in (0, 31):
                cases.append((f"rand{B}-start{start}-death@{off}",
                              (start, planted_at(start + 5 * 32 + off),
                               member_p, states, alive)))

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
        want_off = name.rpartition("@")[2] if "@" in name else None
        if want_off is not None and (kd >= K or (kd - start_k) % 32
                                     != int(want_off)):
            raise AssertionError(f"{name}: death {kd} from start {start_k} "
                                 f"is not at batch offset {want_off}")
        log(f"phase1: {name:>24} start={start_k:5d} death={kd:5d} "
            f"B={member.shape[1]:2d} match")

    step_ns = chain_step_ns(torch)
    log(f"phase1: per-lane step floor {step_ns:.4f} ns per barrier "
        f"(dependent register step chain, no loads, no vote)")

    def timed(name):
        """One case's numbers: back-to-back launches of the kernel's
        wrapper (CUDA events and host clock), the sweep() call as the
        main path makes it (wrapper, kernel, death read; host clock and
        CUDA events), the plain version, the byte bound for this input,
        and its barriers times the step floor."""
        start_k, bars, member, states, alive = dict(cases)[name]
        _, _, death = run_kernel(start_k, bars, member, states, alive)
        swept = min(death, K - 1) - start_k + 1

        def kernel():
            kernels.witness_sweep(pm.kernel_model, start_k, bars, member,
                                  states, alive)

        def call():
            sweep(pm, start_k, bars, member, states, alive)

        ms = cuda_ms(kernel, reps=200)
        ms_host = wall_ms(kernel, reps=200)
        call_ms = wall_ms(call, reps=200)
        call_ms_events = cuda_ms(call, reps=200)
        plain = wall_ms(lambda: sweep_plain(
            start_k, bars, member, states, alive, step_rows), reps=3)
        nbytes = sweep_bytes(start_k, death, K, bars[0].tolist(),
                             member.shape[1], states.shape[1])
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        floor = swept * step_ns / 1e6
        log(f"phase1: timing {name}: {swept} barriers, kernel {ms:.6f} ms "
            f"back to back (CUDA events; {ms * 1e6 / swept:.4f} ns/barrier; "
            f"host clock {ms_host:.6f} ms), sweep() call {call_ms:.6f} ms "
            f"host clock / {call_ms_events:.6f} ms events, plain "
            f"{plain:.3f} ms, bound {bound:.9f} ms ({nbytes} B at "
            f"{HBM_BYTES_PER_S:.3g} B/s), step floor {floor:.6f} ms")
        return dict(name=name, swept=swept, ms=ms, ms_host=ms_host,
                    call_ms=call_ms, call_ms_events=call_ms_events,
                    plain=plain, bound=bound, floor=floor, kernel=kernel,
                    call=call)

    # The JSON line reports the longest real sweep of the main path; the
    # full random block (K barriers) is printed beside it.
    timings = [timed("bench-longest"), timed("rand8-clean")]
    t = timings[0]
    log("phase1: library_ms null: no single PyTorch call computes an "
        "early-exit serial sweep")
    entry = {
        "name": "witness_sweep",
        "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/witness_sweep.cu",
        "replaces": "jepsen_tpu/ops/wgl_witness.py:332",
        "launches": 0,
        "max_abs_err": max_err,
        "ms": t["ms"],
        "call_ms": t["call_ms"],
        "plain_ms": t["plain"],
        "bound_ms": t["bound"],
        "bound_by": "bytes",
        "library_ms": None,
        "ms_host": t["ms_host"],
        "call_ms_events": t["call_ms_events"],
        "chain_floor_ms": t["floor"],
        "chain_step_ns": step_ns,
        "barriers_timed": t["swept"],
        "cases_matched": len(cases),
    }
    return entry, timings


def phase_profile(torch, entry: dict, timings: list) -> None:
    """The kernel's device time on each timed case and the device
    operations of one sweep() call, from torch.profiler, added to
    `entry`; then phase 1's first back-to-back timing again, so the log
    shows what a process that has run the profiler pays per launch."""
    for t in timings:
        seen = profile_device(torch, t["kernel"], reps=200)
        n, us = next(v for k, v in seen.items() if "witness_sweep" in k)
        t["device_ms"] = us / n / 1e3
        log(f"profile: {t['name']}: kernel device time "
            f"{t['device_ms']:.6f} ms ({t['device_ms'] * 1e6 / t['swept']:.4f}"
            f" ns/barrier; {t['device_ms'] / t['floor']:.3f}x the step "
            f"floor)")
    t = timings[0]
    seen = profile_device(torch, t["call"], reps=20)
    ops_per_call = sum(n for n, _ in seen.values()) / 20
    log(f"profile: sweep() call: {ops_per_call:g} device operations per "
        f"call ({sorted(seen)})")
    if ops_per_call != 2:
        raise AssertionError(
            f"sweep() made {ops_per_call} device operations per call, "
            f"not 2 (the kernel and the death copy): {sorted(seen)}")
    again = cuda_ms(t["kernel"], reps=200)
    log(f"profile: {t['name']}: kernel back to back {again:.6f} ms (CUDA "
        f"events) after torch.profiler ran; {t['ms']:.6f} ms before")
    entry.update(device_ms=t["device_ms"], device_ops_per_call=ops_per_call,
                 ms_after_profiler=again)


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
    return r


def breakdown(torch, history) -> dict:
    """Where one main-path check spends its time, stage by stage (host
    clock), and the card's busy time in the device search from
    torch.profiler.  Runs after the counted runs."""
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
    walls = []

    def search():
        t0 = time.perf_counter()
        check_wgl_device(packed, pm, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    # One search before the profiler starts, one under it.
    seen = profile_device(torch, search, reps=1)
    t_device, t_prof = walls
    kernels_us = {k: us for k, (_, us) in seen.items()}
    n_copies = sum(n for k, (n, _) in seen.items()
                   if k.startswith(("Memcpy", "Memset")))
    n_kernels = sum(n for n, _ in seen.values()) - n_copies
    busy_s = sum(kernels_us.values()) / 1e6
    sweep_us = sum(us for k, us in kernels_us.items()
                   if "witness_sweep" in k)
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:8]
    return {
        "pack_s": t_pack,
        "refute_s": t_refute,
        "device_search_s": t_device,
        "profiled_device_search_s": t_prof,
        "device_busy_s": busy_s,
        "device_idle_share": (1.0 - busy_s / t_prof) if busy_s else None,
        "device_kernel_launches_per_check": n_kernels,
        "device_copies_per_check": n_copies,
        "sweep_kernel_us": sweep_us,
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
    log("phase4: " + json.dumps(r))
    return r


# ---------------------------------------------------------------------------
# The many-key path (phases 5 and 6) and the sweep kernel's other
# instantiations (phase 1b).

MIXED_KEYS, MIXED_OPS, MIXED_BAD = 200, 100, 30  # bench.py run_mixed
BIG_KEYS = 2000  # the all-valid check: 200k ops
MODEL_KEYS, MODEL_OPS = 200, 100


def instantiation(pm) -> str:
    """The sweep kernel instantiation `pm` runs, as `kernels.launches`
    counts it: witness_sweep[<model>] or witness_sweep[<model>+stream]."""
    from jepsen_tpu_torch.ops import kernels

    return (f"witness_sweep[{kernels.SWEEP_MODELS[pm.kernel_model][0]}"
            f"{'+stream' if pm.stream else ''}]")


class SweepRecorder:
    """While entered, records the sweep() calls of the checks it wraps,
    per kernel instantiation: the first `first` calls and the longest
    (in barriers swept), inputs cloned, with the death each returned;
    and each model's first batched-BFS call (its packs and arguments)."""

    def __init__(self, first: int = 3):
        self.first = first
        self.calls: dict = {}
        self.longest: dict = {}
        self.batched: dict = {}

    def __enter__(self):
        from jepsen_tpu_torch.ops import wgl_batched, wgl_witness

        self._real = real = wgl_witness.sweep
        self._real_batched = real_batched = wgl_batched.check_wgl_batched

        def recording_batched(packs, pm, **kw):
            self.batched.setdefault(pm.name, (list(packs), pm, kw))
            return real_batched(packs, pm, **kw)

        wgl_batched.check_wgl_batched = recording_batched

        def recording(pm, start_k, bars, member, states, alive, init=None):
            out = real(pm, start_k, bars, member, states, alive, init)
            name = instantiation(pm)
            span = min(out[2], bars.shape[1] - 1) - start_k
            calls = self.calls.setdefault(name, [])
            best = self.longest.get(name)
            longer = best is None or span > best["span"]
            if len(calls) < self.first or longer:
                call = dict(pm=pm, start_k=start_k, span=span, death=out[2],
                            args=tuple(t.clone() for t in
                                       (bars, member, states, alive)),
                            init=None if init is None else init.clone())
                if len(calls) < self.first:
                    calls.append(call)
                if longer:
                    self.longest[name] = call
            return out

        wgl_witness.sweep = recording
        return self

    def __exit__(self, *exc):
        from jepsen_tpu_torch.ops import wgl_batched, wgl_witness

        wgl_witness.sweep = self._real
        wgl_batched.check_wgl_batched = self._real_batched
        return False


def mixed_history(n_keys: int, n_bad: int):
    """bench.py run_mixed's history: `n_keys` cas-register keys "k<i>"
    of MIXED_OPS ops (4 processes, 5% :info, seed i), keys 0 ..
    n_bad - 1 with a planted violation."""
    from jepsen_tpu_torch.history.core import history
    from jepsen_tpu_torch.parallel import kv
    from jepsen_tpu_torch.utils.histgen import random_register_history

    ops = []
    for i in range(n_keys):
        h = random_register_history(MIXED_OPS, procs=4, info_rate=0.05,
                                    seed=i, bad=i < n_bad)
        ops += [o.replace(value=kv(f"k{i}", o.value)) for o in h]
    return history(ops)


def check_exact(what: str, make_model, history, res: dict) -> None:
    """Holds every per-key verdict of `res` against the exact CPU
    engine's on that key's subhistory; raises on a difference or on a
    key the exact engine could not decide."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.parallel import subhistories

    diff = {}
    for k, h in subhistories(history).items():
        want = Linearizable(make_model(), "cpu", time_limit_s=120,
                            device="cpu").check({}, h, {})["valid"]
        got = res["results"][k]["valid"]
        if want not in (True, False) or got != want:
            diff[k] = (got, want)
    if diff:
        raise AssertionError(f"{what}: per-key verdicts differ from the "
                             f"exact CPU engine's (got, exact): "
                             f"{dict(list(diff.items())[:8])}")


def many_key_run(torch, checker, history, reps: int) -> tuple:
    """`reps` checks of `history` by `checker`, the settle memo cleared
    before each; the counts are set to 0 before the first and read after
    the last -> (last result, readings per check)."""
    from jepsen_tpu_torch import device as D
    from jepsen_tpu_torch.ops import kernels
    from jepsen_tpu_torch.parallel import clear_settle_memo

    kernels.launches.clear()
    D.counters.clear()
    times = []
    for _ in range(reps):
        clear_settle_memo()
        t0 = time.perf_counter()
        res = checker.check({}, history, {})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: v for k, v in kernels.launches.items()
                if k.startswith("witness_sweep[")}
    counts = dict(D.counters)
    med = statistics.median(times)
    per = {name: counts.get(name, 0) / reps for name in (
        "stream_passes", "stream_restarts", "stream_keys_proven",
        "heavy_rounds", "bfs_levels", "host_syncs")}
    r = {
        "ops": len(history) // 2,
        "keys": res["key-count"],
        "valid": res["valid"],
        "failure_count": res["failure-count"],
        "wall_s": times,
        "median_s": med,
        "ops_per_s": len(history) / 2 / med,
        "tiers": res["tiers"],
        "per_check": {**per, "sweep_launches":
                      kernels.launches["witness_sweep"] / reps},
        "launches": launches,
    }
    return res, r


def phase_mixed(torch, recorder: SweepRecorder) -> dict:
    """Phase 5: bench.py run_mixed's shape on the card, then the
    all-valid 2,000-key check."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.parallel import IndependentChecker, \
        clear_settle_memo

    chk = IndependentChecker(Linearizable(cas_register(), time_limit_s=120))
    h = mixed_history(MIXED_KEYS, MIXED_BAD)
    clear_settle_memo()
    with recorder:
        warm = chk.check({}, h, {})  # warm-up: not counted, recorded
    res, r = many_key_run(torch, chk, h, reps=3)
    for out in (warm, res):
        if out["valid"] is not False or out["failure-count"] != MIXED_BAD:
            raise AssertionError(
                f"phase5: valid {out['valid']}, {out['failure-count']} "
                f"failures; want False with {MIXED_BAD}")
    if r["launches"].get("witness_sweep[register+stream]", 0) <= 0:
        raise AssertionError("phase5: the stream instantiation never ran")
    check_exact("phase5", cas_register, h, res)
    log("phase5: mixed " + json.dumps(r))
    big = mixed_history(BIG_KEYS, 0)
    res_b, rb = many_key_run(torch, chk, big, reps=3)
    if res_b["valid"] is not True or res_b["failure-count"]:
        raise AssertionError(f"phase5: all-valid check gave "
                             f"{res_b['valid']} ({res_b['failure-count']} "
                             f"failures)")
    log("phase5: all-valid " + json.dumps(rb))
    return {"mixed": r, "all_valid": rb}


def phase_models(torch, recorder: SweepRecorder) -> dict:
    """Phase 6: a 200-key history of each other model (every 7th key
    bad, plus one long key), once recorded, then once counted; every
    per-key verdict equals the exact CPU engine's, and both of the
    model's instantiations ran."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.history.core import Op, history
    from jepsen_tpu_torch.parallel import IndependentChecker, \
        clear_settle_memo, kv

    out = {}
    for name, make, gen, kw in model_specs():
        bad = set(range(0, MODEL_KEYS, 7))
        h = keyed_history(gen, MODEL_KEYS, MODEL_OPS, bad, Op=Op, kv=kv,
                          history=history, long_key_ops=LONG_KEY_OPS.get(
                              name, LONG_KEY_OPS_DEFAULT), **kw)
        chk = IndependentChecker(Linearizable(make(), time_limit_s=120))
        clear_settle_memo()
        with recorder:
            chk.check({}, h, {})
        res, r = many_key_run(torch, chk, h, reps=1)
        for inst in (f"witness_sweep[{name}]",
                     f"witness_sweep[{name}+stream]"):
            if r["launches"].get(inst, 0) <= 0:
                raise AssertionError(f"phase6 {name}: {inst} never launched")
        if res["failure-count"] != len(bad):
            raise AssertionError(f"phase6 {name}: {res['failure-count']} "
                                 f"failures, want {len(bad)}")
        check_exact(f"phase6 {name}", make, h, res)
        log(f"phase6: {name} " + json.dumps(r))
        out[name] = r
    return out


def instance_models() -> list:
    """(label, packed model) of every sweep instantiation phase 1b holds
    against the plain version: each model plain and stream, the
    multi-register at 3 and 5 registers (state buckets 4 and 8).  The
    register's plain instantiation is phase 1's."""
    from jepsen_tpu_torch import models as M
    from jepsen_tpu_torch.ops.wgl_stream import stream_model

    out = []
    for label, make in (
            ("register", M.cas_register), ("mutex", M.mutex),
            ("multi-register/3",
             lambda: M.multi_register({f"r{i}": 0 for i in range(3)})),
            ("multi-register/5",
             lambda: M.multi_register({f"r{i}": 0 for i in range(5)})),
            ("fifo-queue", M.fifo_queue),
            ("unordered-queue", M.unordered_queue)):
        pm = make().packed()
        if label != "register":
            out.append((label, pm))
        out.append((label + "+stream", stream_model(pm)))
    return out


def random_model_tables(pm, rng, B: int, W: int, K: int, kind: str,
                        planted=None) -> tuple:
    """Random sweep inputs for `pm` as numpy (bars (6, K), member (W, B),
    states (B, SW), alive (B,)): its ops, with codes it never packs mixed
    in (an f past release for the mutex, register indices outside the
    real width, 0 for the queues), and for a stream model a RESET every
    7th barrier.  Lane 0 passes every barrier at columns below W - 1
    ("clean": every barrier).  `planted`: the barrier of an op no lane
    survives, at the empty column W - 1 (for the mutex two acquires in a
    row ending there)."""
    import numpy as np

    from jepsen_tpu_torch.ops.wgl_stream import F_RESET

    name = pm.name.partition("+")[0]
    sw = pm.state_width
    member = rng.random((W, B)) < 0.3
    member[:, 0] = True
    member[W - 1] = kind == "clean"
    if B == 32:
        member[: W - 1, 31] = True  # the sign bit of every word
    alive = rng.random(B) < 0.7
    alive[0] = True
    bars = np.zeros((6, K), dtype=np.int32)
    bars[0] = rng.integers(0, W - 1, size=K)
    bars[1] = np.arange(K)
    bars[2] = 1
    if name == "cas-register":
        states = rng.integers(0, 4, (B, sw))
        ops = (rng.integers(0, 3, K), rng.integers(0, 4, K),
               rng.integers(0, 4, K))
        killer = (0, 77, 0)
    elif name == "mutex":
        states = rng.integers(0, 2, (B, sw))
        ops = rng.choice([0, 1, 1, 0, 2], K), np.zeros(K), np.zeros(K)
        killer = (0, 0, 0)
    elif name == "multi-register":
        states = rng.integers(0, 4, (B, sw))
        ops = (rng.integers(0, 2, K),
               rng.choice(list(range(sw)) * 3 + [-1, sw, 31], K),
               rng.integers(0, 4, K))
        killer = (0, 0, 77)
    else:
        states = np.zeros((B, sw), dtype=np.int64)
        for b in range(B):
            # Lanes 0 and 1: an empty and a full queue.
            n = (0, sw)[b] if b < 2 else int(rng.integers(0, sw + 1))
            if name == "fifo-queue":
                states[b, :n] = rng.integers(1, 7, n)
            else:
                states[b, rng.permutation(sw)[:n]] = rng.integers(1, 7, n)
        ops = rng.choice([0, 0, 1], K), rng.integers(0, 7, K), np.zeros(K)
        killer = (1, 99, 0)
    bars[3], bars[4], bars[5] = ops
    if pm.stream:
        bars[3, 3::7] = F_RESET
    if planted is not None:
        for k in ((planted - 1, planted) if name == "mutex" else (planted,)):
            bars[0, k] = W - 1
            bars[3:, k] = killer
    if kind == "padding":
        bars[2, K - 300:] = 0
    return bars, member, states.astype(np.int32), alive


def phase_instantiations(torch, recorder: SweepRecorder, seed: int) -> list:
    """Phase 1b: every other sweep instantiation against the plain
    version (run on host copies of the inputs), exactly (states, alive,
    death): the calls recorded in
    phases 5 and 6 (and the first of each restarted at 31 and 33 and cut
    to lane 0), and random tables at B = 1, 8 and 32 with RESET barriers
    for the stream models, deaths mid-block and at batch offsets 0 and
    31 from starts 31 and 33, starts after a death and in a padding
    tail.  Then times each instantiation on its longest recorded call ->
    the kernels-line entries of the instantiations phases 5 and 6
    ran."""
    import numpy as np

    from jepsen_tpu_torch.ops import kernels
    from jepsen_tpu_torch.ops.wgl_witness import BARS_PER_BLOCK, sweep_plain

    dev = torch.device("cuda")
    K, W = BARS_PER_BLOCK, 64
    rng = np.random.default_rng(seed)

    def to_dev(arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays)

    def init_of(pm):
        return (torch.tensor(pm.init_state, dtype=torch.int32, device=dev)
                if pm.stream else None)

    cases = []  # (label, pm, start_k, (bars, member, states, alive), init)
    for name, calls in recorder.calls.items():
        rec = calls + [recorder.longest[name]]
        for i, c in enumerate(rec):
            cases.append((f"{name}:recorded{i}", c["pm"], c["start_k"],
                          c["args"], c["init"]))
        c = calls[0]
        bars, member, states, alive = c["args"]
        for start in (31, 33):
            if start < bars.shape[1]:
                cases.append((f"{name}:recorded-start{start}", c["pm"],
                              start, c["args"], c["init"]))
        cases.append((f"{name}:recorded-B1", c["pm"], c["start_k"],
                      (bars, member[:, :1].contiguous(), states[:1],
                       alive[:1]), c["init"]))
    for label, pm in instance_models():
        for B in (1, 8, 32):
            def tables(kind, planted=None):
                return to_dev(random_model_tables(pm, rng, B, W, K, kind,
                                                  planted))

            death = tables("death", K // 2)
            runs = [("clean", 0, tables("clean")), ("death", 0, death),
                    ("after-death", K // 2 + 1, death),
                    ("padding", K - 295, tables("padding", K // 2))]
            for start in (31, 33):
                for off in (0, 31):
                    runs.append((f"start{start}-death@{off}", start,
                                 tables("death", start + 5 * 32 + off)))
            for kind, start, args in runs:
                cases.append((f"{label}:rand{B}-{kind}", pm, start, args,
                              init_of(pm)))

    max_err = {}
    for label, pm, start_k, args, init in cases:
        ks, ka, kd = kernels.witness_sweep(pm.kernel_model, start_k, *args,
                                           init)
        ks, ka, kd = ks.cpu(), ka.cpu(), int(kd.item())
        # The plain version on host copies of the same inputs: its
        # per-barrier loop on the card would cost minutes here.
        ps, pa, pd = sweep_plain(start_k, *(t.cpu() for t in args),
                                 pm.torch_step_rows)
        inst = instantiation(pm)
        max_err[inst] = max(max_err.get(inst, 0), abs(kd - pd),
                            int((ks.long() - ps.long()).abs().max()),
                            int((ka.long() - pa.long()).abs().max()))
        if not (torch.equal(ks, ps) and torch.equal(ka, pa) and kd == pd):
            raise AssertionError(
                f"phase1b: witness_sweep != sweep_plain on {label}: death "
                f"{kd} vs {pd}, states equal {torch.equal(ks, ps)}, alive "
                f"equal {torch.equal(ka, pa)}")
        if ("@" in label and not label.startswith("mutex")
                and (kd - start_k) % 32 != int(label.rpartition("@")[2])):
            raise AssertionError(f"phase1b: {label}: death {kd} from "
                                 f"{start_k} is not at its batch offset")
    log(f"phase1b: {len(cases)} cases of {len(max_err)} instantiations "
        f"match sweep_plain exactly ({sorted(max_err)})")

    entries = []
    for name, c in sorted(recorder.longest.items()):
        pm, start_k, init = c["pm"], c["start_k"], c["init"]
        bars, member, states, alive = c["args"]
        B, sw = member.shape[1], states.shape[1]

        def kernel(pm=pm, start_k=start_k, args=c["args"], init=init):
            kernels.witness_sweep(pm.kernel_model, start_k, *args, init)

        ms = cuda_ms(kernel, reps=200)
        plain = wall_ms(lambda: sweep_plain(start_k, *c["args"],
                                            pm.torch_step_rows), reps=3)
        swept = c["span"] + 1
        nbytes = (sweep_bytes(start_k, c["death"], bars.shape[1],
                              bars[0].tolist(), B, sw)
                  + (4 * sw if init is not None else 0))
        entry = {
            "name": name,
            "route": "cuda",
            "source": "jepsen_tpu_torch/csrc/witness_sweep.cu",
            "replaces": "jepsen_tpu/ops/wgl_witness.py:332",
            "launches": 0,
            "max_abs_err": max_err.get(name, 0),
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": None,
            "barriers_timed": swept,
            "B": B,
            "sw": sw,
            "_kernel": kernel,
        }
        log(f"phase1b: timing {name}: {swept} barriers B={B} sw={sw}, "
            f"kernel {ms:.6f} ms back to back (CUDA events; "
            f"{ms * 1e6 / swept:.4f} ns/barrier), plain {plain:.3f} ms, "
            f"bound {entry['bound_ms']:.9f} ms ({nbytes} B)")
        entries.append(entry)
    return entries


def phase_batched(torch, recorder: SweepRecorder) -> dict:
    """The batched BFS (plain PyTorch; the JAX package's `_make_key_fn`
    under `vmap`) on each model's cohort recorded in phases 5 and 6:
    keys, levels, host syncs and wall time of one call (host clock),
    and a callable for its device time in phase 3."""
    from jepsen_tpu_torch import device as D
    from jepsen_tpu_torch.ops.wgl_batched import check_wgl_batched

    out = {}
    for name, (packs, pm, kw) in sorted(recorder.batched.items()):
        def call(packs=packs, pm=pm, kw=kw):
            return check_wgl_batched(packs, pm, **kw)

        call()  # warm-up
        torch.cuda.synchronize()
        D.counters.clear()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        out[name] = {
            "keys": len(packs),
            "max_ops": max(p.n for p in packs),
            "valid": {str(v): res.valid.count(v) for v in set(res.valid)},
            "levels": D.counters.get("bfs_levels", 0),
            "host_syncs": D.counters.get("host_syncs", 0),
            "wall_s": time.perf_counter() - t0,
            "_call": call,
        }
        log(f"phase1b: batched BFS {name}: " + json.dumps(
            {k: v for k, v in out[name].items() if k != "_call"}))
    return out


def ptxas_report(build_log: str) -> dict:
    """{"MODEL,SW,NW,stream": {"registers", "spill_stores",
    "spill_loads"}} of each witness_sweep_kernel instantiation, from the
    build's -Xptxas -v output."""
    import re

    out, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"witness_sweep_kernelILi(\d+)ELi(\d+)ELi(\d+)"
                          r"ELb([01])E", m.group(1))
            cur = ",".join(t.groups()) if t else None
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def sass_instructions(lib_path: str) -> dict:
    """{"MODEL,SW,NW,stream": SASS instructions} of each
    witness_sweep_kernel instantiation in the built library, from
    `cuobjdump -sass` ({} where the toolkit has none)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            t = re.search(r"witness_sweep_kernelILi(\d+)ELi(\d+)ELi(\d+)"
                          r"ELb([01])E", m.group(1))
            cur = ",".join(t.groups()) if t else None
            if cur:
                out[cur] = 0
        elif cur and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            out[cur] += 1
    return out


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
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} (torch {torch.__version__}, CUDA "
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

    entry, timings = phase_kernel(torch, packed, pm, W, seed=BENCH_SEED)
    main_r = phase_main(torch, history, packed.n)
    entry["launches"] = main_r["sweep_launches"]

    # The many-key path, then phase 1b on the sweep calls it recorded;
    # all before the profiler first runs (phase 3).
    recorder = SweepRecorder()
    mixed_r = phase_mixed(torch, recorder)
    models_r = phase_models(torch, recorder)
    launches = dict(mixed_r["mixed"]["launches"])
    for r in models_r.values():
        launches.update(r["launches"])
    more = phase_instantiations(torch, recorder, seed=BENCH_SEED)
    batched = phase_batched(torch, recorder)
    ptxas = ptxas_report(kernels.build_log)
    for key, n in sass_instructions(kernels.sweep_lib()._name).items():
        ptxas.setdefault(key, {})["sass_instructions"] = n
    for e in more:
        e["launches"] = launches.get(e["name"], 0)
        if e["launches"] <= 0:
            raise AssertionError(f"{e['name']}: no launch on its path")
        model_id = next(m for m, (n, _) in kernels.SWEEP_MODELS.items()
                        if e["name"].startswith(f"witness_sweep[{n}"))
        bucket = 1 << max(0, e["sw"] - 1).bit_length()
        if model_id == 3:  # the multi-register's state buckets
            bucket = max(2, bucket)
        stream = int(e["name"].endswith("+stream]"))
        e["ptxas"] = {f"NW{nw}": ptxas.get(f"{model_id},{bucket},{nw},"
                                           f"{stream}")
                      for nw in (3, 9)}
    for key, rep in sorted(ptxas.items()):
        log(f"ptxas: witness_sweep_kernel<MODEL,SW,NW,STREAM>=<{key}>: "
            f"{json.dumps(rep)}")

    phase_profile(torch, entry, timings)
    for e in more:
        seen = profile_device(torch, e.pop("_kernel"), reps=200)
        n, us = next(v for k, v in seen.items() if "witness_sweep" in k)
        e["device_ms"] = us / n / 1e3
        log(f"profile: {e['name']}: kernel device time "
            f"{e['device_ms']:.6f} ms ({e['device_ms'] * 1e6 / e['barriers_timed']:.4f}"
            f" ns/barrier)")
    for model_name, b in batched.items():
        seen = profile_device(torch, b.pop("_call"), reps=1)
        b["device_ms"] = sum(us for _, us in seen.values()) / 1e3
        b["device_ops"] = sum(n for n, _ in seen.values())
        log(f"profile: batched BFS {model_name}: {b['levels']} levels, device "
            f"time {b['device_ms']:.3f} ms in {b['device_ops']} device "
            f"operations, wall {b['wall_s']:.3f} s")
    main_r["breakdown"] = breakdown(torch, history)
    log("profile: main path breakdown " + json.dumps(main_r["breakdown"]))
    bad_r = phase_invalid(torch)

    log(f"phase4 done; main path {main_r['ops_per_s']:.1f} ops/s, "
        f"invalid path {bad_r['wall_s']:.3f} s; many-key mixed "
        f"{mixed_r['mixed']['ops_per_s']:.1f} ops/s, all-valid "
        f"{mixed_r['all_valid']['ops_per_s']:.1f} ops/s")
    print(json.dumps({"kernels": [entry] + more}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
