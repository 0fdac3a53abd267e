#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (jepsen_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc): the witness sweep
kernel is built from jepsen_tpu_torch/csrc/ into build/jepsen_tpu_torch/
at first use.  Exits non-zero, printing no result, when torch sees no
CUDA device or the package is missing.  Nine phases, each raising on
failure, run in the order 1, 2, 5, 6, 7, 8, 1b, 3, 4 (every host-clock
and CUDA-event timing before the profiler first runs):

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
7. Online checking (streaming/, monitor/), each sub-phase counted on its
   own: (7a) the bench history replayed in 24 stable-prefix slices
   through FrontierCarry equals one check_wgl_witness at the same block
   knobs (valid, sweep launches, chain rounds); (7b) bench.py
   run_scale_online: a 2M-op random_register_packed stream in 24
   slices, warmed on 50k ops, valid, with its verdict lag and
   lag_fraction; (7c) a producer thread feeds the bench history through
   a StreamingSession and Linearizable takes the "wgl-online" verdict;
   (7d) phase 5's history through a keyed session, then
   IndependentChecker: 30 failures, every verdict the exact CPU
   engine's, 170 keys online; (7e) RollingChecker over a 200k-op stream
   with and without discards: equal verdicts, resident rows bounded.
8. Elle (checker/elle, ops/scc.py): seeded concurrent list-append and
   rw-register runs (`elle_ops`: 10 processes, 5% :info, the reference
   workloads' defaults) through AppendChecker / WrChecker on the card,
   under serializable and strict-serializable, median of 3 each.
   (8a) 1,000 committed list-append transactions: valid, screened at
   V = 1,024, result equal to device="off"; (8b) the same run with a
   G0, a G1c and a G-single injected: invalid, the anomaly types of
   device="off", every cycle extracted on the card (K = 4 layers at
   V = 1,024) a real closed cycle carrying its layer's edge type;
   (8b-chain) as 8b with one G-single whose cycle runs through a ww
   chain of 100 transactions, so the extraction's BFS walks 99 levels;
   (8c) rw-register, valid and with a G-single, as 8a and 8b; (8d) 512
   random graphs of 16-128 vertices through one screen call, flags
   equal host sccs(); (8e) 2,000 transactions, past the screen's 1,024
   vertices: host route, no device call, the verdict of device="off".
   Per check: wall time, host analysis time before the cycle search,
   closure and extraction ms (CUDA events), BFS levels, host syncs.
   Phase 3 profiles the closure, the extraction, one screen call and
   one 8b check.

The last lines are the device-program JSON line (the closure screen and
the extraction, plain PyTorch: time, launches per check, bound), the
kernels JSON line (one entry per timed instantiation), the card's name
and power limit from nvidia-smi, and {"ok": true, "device": {...}}.
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


# ---------------------------------------------------------------------------
# Online checking (phase 7): the frontier carry, the streaming session and
# the rolling discard.

ONLINE_SLICES = 24  # bench.py run_scale_online's default
SCALE_OPS, SCALE_WARM_OPS = 2_000_000, 50_000
ROLLING_OPS = 200_000
#: The live producers feed this many ops, then pause FEED_PAUSE_S.
FEED_BURST, FEED_PAUSE_S = 2048, 0.02


def counted(torch, dev, fn) -> tuple:
    """fn() with the kernel launch counts and `device.counters` set to 0
    just before and read just after -> (result, launches, counters)."""
    from jepsen_tpu_torch import device as D
    from jepsen_tpu_torch.ops import kernels

    kernels.launches.clear()
    D.counters.clear()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, dict(kernels.launches), dict(D.counters)


def need_launches(what: str, dev, launches: dict, name="witness_sweep"):
    """On the card, raise unless `name` launched in the run just read."""
    if dev.type == "cuda" and launches.get(name, 0) <= 0:
        raise AssertionError(f"{what}: no {name} launch on this path")


def prefix(packed, k: int):
    """The witness-only view of the first k rows of `packed`: with the
    stable bound s = inv[k] it is a PackedBuilder snapshot (every row has
    inv < s, every later completion has ret > s), as bench.py
    run_scale_online replays it."""
    import numpy as np

    from jepsen_tpu_torch.history.packed import PackedOps

    z = np.zeros(k, dtype=packed.preds.dtype)
    return PackedOps(inv=packed.inv[:k], ret=packed.ret[:k],
                     process=packed.process[:k], status=packed.status[:k],
                     f=packed.f[:k], a0=packed.a0[:k], a1=packed.a1[:k],
                     src_index=packed.src_index[:k], preds=z, horizon=z)


def replay(fr, packed, slices: int = ONLINE_SLICES):
    """Advances `fr` over `slices` stable prefixes of `packed`, then
    finalizes -> (verdict, seconds to the last advance, seconds in
    all)."""
    n = packed.n
    t0 = time.perf_counter()
    step = max(1, n // slices)
    for k in range(step, n, step):
        fr.advance(prefix(packed, k), int(packed.inv[k]))
    t_last = time.perf_counter()
    valid = fr.finalize(packed)
    return valid, t_last - t0, time.perf_counter() - t0


def feed_live(sess, history) -> float:
    """A producer thread feeds `history` through `sess.feed` in bursts
    of FEED_BURST ops with a pause after each, then the caller's thread
    calls finish() -> seconds the producer took."""
    import threading

    def produce():
        for i, op in enumerate(history):
            sess.feed(op)
            if i % FEED_BURST == FEED_BURST - 1:
                time.sleep(FEED_PAUSE_S)

    t0 = time.perf_counter()
    t = threading.Thread(target=produce, name="producer")
    t.start()
    t.join()
    return time.perf_counter() - t0


def online_carry(torch, dev, pm, packed) -> dict:
    """7a: the bench history in ONLINE_SLICES stable-prefix slices
    through FrontierCarry, then one check_wgl_witness at the same block
    knobs on the same pack: both valid, with equal sweep launches and
    chain rounds."""
    from jepsen_tpu_torch.ops.wgl_witness import check_wgl_witness
    from jepsen_tpu_torch.streaming import FrontierCarry

    fr = FrontierCarry(pm, device=dev)
    (valid, t_adv, t_all), l_on, c_on = counted(
        torch, dev, lambda: replay(fr, packed))
    res, l_one, c_one = counted(torch, dev, lambda: check_wgl_witness(
        packed, pm, bars_per_block=1024, blocks_per_call=8, device=dev))
    r = {
        "ops": packed.n, "valid": valid, "one_shot_valid": res and res.valid,
        "sweep_launches": l_on.get("witness_sweep", 0),
        "one_shot_sweep_launches": l_one.get("witness_sweep", 0),
        "heavy_rounds": c_on.get("heavy_rounds", 0),
        "one_shot_heavy_rounds": c_one.get("heavy_rounds", 0),
        "host_syncs": c_on.get("host_syncs", 0),
        "one_shot_host_syncs": c_one.get("host_syncs", 0),
        "advances": c_on.get("online_advances", 0),
        "chunks": fr.chunks, "blocks": fr.blocks_done, "window": fr._W,
        "advance_s": t_adv, "total_s": t_all,
    }
    log("phase7a: " + json.dumps(r))
    need_launches("phase7a", dev, l_on)
    if not (valid is True and r["one_shot_valid"] is True
            and r["sweep_launches"] == r["one_shot_sweep_launches"]
            and r["heavy_rounds"] == r["one_shot_heavy_rounds"]):
        raise AssertionError("phase7a: the online carry and the one-shot "
                             "witness differ")
    return r


def online_scale(torch, dev, pm, n_ops: int = SCALE_OPS) -> dict:
    """7b: bench.py run_scale_online on the port — a random_register_packed
    stream in ONLINE_SLICES slices, warmed on a 50k-op stream; the
    verdict lag is the time from the last advance (the last op landed)
    to the verdict."""
    from jepsen_tpu_torch.streaming import FrontierCarry
    from jepsen_tpu_torch.utils.histgen import random_register_packed

    warm = random_register_packed(min(SCALE_WARM_OPS, n_ops),
                                  procs=BENCH_PROCS, info_rate=BENCH_INFO,
                                  seed=7, model=pm)
    FrontierCarry(pm, device=dev).finalize(warm)
    t0 = time.perf_counter()
    big = random_register_packed(n_ops, procs=BENCH_PROCS,
                                 info_rate=BENCH_INFO, seed=BENCH_SEED,
                                 model=pm)
    t_gen = time.perf_counter() - t0
    fr = FrontierCarry(pm, device=dev)
    (valid, t_adv, t_all), launches, counts = counted(
        torch, dev, lambda: replay(fr, big))
    lag = t_all - t_adv
    r = {
        "ops": big.n, "valid": valid, "verdict_lag_s": lag,
        "elapsed_s": t_all, "lag_fraction": lag / t_all,
        "ops_per_s": big.n / t_all, "generate_s": t_gen,
        "blocks": fr.blocks_done, "chunks": fr.chunks,
        "frontier_device_s": fr.device_s, "plan_s": fr.plan_s,
        "advances": counts.get("online_advances", 0),
        "sweep_launches": launches.get("witness_sweep", 0),
        "heavy_rounds": counts.get("heavy_rounds", 0),
        "host_syncs": counts.get("host_syncs", 0),
    }
    log("phase7b: " + json.dumps(r))
    need_launches("phase7b", dev, launches)
    if valid is not True:
        raise AssertionError(f"phase7b: frontier gave {valid} "
                             f"({fr.dead_reason})")
    return r


def online_live(torch, dev, history) -> dict:
    """7c: a producer thread feeds the bench history through a
    StreamingSession; Linearizable then takes the online verdict."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.streaming import StreamingSession

    def run():
        sess = StreamingSession(cas_register().packed(), device=dev)
        feed_s = feed_live(sess, history)
        stats = sess.finish()
        res = Linearizable(cas_register(), device=dev).check(
            {"streaming-session": sess}, history, {})
        return sess, feed_s, stats, res

    (sess, feed_s, stats, res), launches, counts = counted(torch, dev, run)
    fr = stats.get("frontier", {})
    r = {
        "events": len(history), "feed_s": feed_s,
        "verdict_lag_s": stats["verdict-lag-s"],
        "lag_fraction": stats["verdict-lag-s"] / (
            feed_s + stats["verdict-lag-s"]),
        "swaps": stats["swaps"], "valid": res["valid"],
        "algorithm": res["algorithm"], "broken": stats.get("broken"),
        "frontier_blocks": fr.get("blocks"), "frontier_chunks": fr.get("chunks"),
        "frontier_device_s": fr.get("device-s"), "plan_s": fr.get("plan-s"),
        "advances": counts.get("online_advances", 0),
        "consumed": counts.get("online_consumed", 0),
        "sweep_launches": launches.get("witness_sweep", 0),
        "heavy_rounds": counts.get("heavy_rounds", 0),
        "host_syncs": counts.get("host_syncs", 0),
    }
    log("phase7c: " + json.dumps(r))
    need_launches("phase7c", dev, launches)
    if sess.broken or res["valid"] is not True or \
            res["algorithm"] != "wgl-online":
        raise AssertionError(f"phase7c: session broken {sess.broken}, "
                             f"verdict {res}")
    return r


def online_keyed(torch, dev) -> dict:
    """7d: phase 5's run_mixed history fed to a keyed session by a
    producer thread, then IndependentChecker: 30 failures, every per-key
    verdict the exact CPU engine's, the 170 valid keys taken online.

    The session ingests the history as one batch (its swap threshold is
    past the history's length and its swap interval an hour).  With batches cut by timing, a batch
    holding more bad keys than half its keys would reach the stream's
    restart cap, and its valid keys left undecided are not retried at
    finish (their pack is unchanged: the reference's rule), so the count
    of keys taken online would vary from run to run."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.parallel import IndependentChecker, \
        clear_settle_memo
    from jepsen_tpu_torch.streaming import StreamingSession

    h = mixed_history(MIXED_KEYS, MIXED_BAD)
    clear_settle_memo()

    def session():
        sess = StreamingSession(cas_register().packed(),
                                swap_ops=len(h) + 1, swap_interval_s=3600.0,
                                device=dev)
        feed_s = feed_live(sess, h)
        return sess, feed_s, sess.finish()

    (sess, feed_s, stats), l_sess, c_sess = counted(torch, dev, session)
    chk = IndependentChecker(Linearizable(cas_register(), time_limit_s=120,
                                          device=dev), device=dev)
    res, l_chk, c_chk = counted(torch, dev, lambda: chk.check(
        {"streaming-session": sess}, h, {}))
    online = sum(1 for v in res["results"].values()
                 if v.get("algorithm") == "wgl-online")
    r = {
        "events": len(h), "feed_s": feed_s,
        "verdict_lag_s": stats["verdict-lag-s"], "swaps": stats["swaps"],
        "proven_online": stats["proven-online"],
        "rechecks": stats["rechecks"], "valid": res["valid"],
        "failure_count": res["failure-count"], "keys_online": online,
        "tiers": res["tiers"],
        "session_launches": {k: v for k, v in l_sess.items()
                             if k.startswith("witness_sweep")},
        "session_counts": c_sess,
        "check_launches": {k: v for k, v in l_chk.items()
                           if k.startswith("witness_sweep")},
        "check_host_syncs": c_chk.get("host_syncs", 0),
    }
    log("phase7d: " + json.dumps(r))
    need_launches("phase7d", dev, l_sess, "witness_sweep[register+stream]")
    if (sess.broken or res["valid"] is not False
            or res["failure-count"] != MIXED_BAD
            or online != MIXED_KEYS - MIXED_BAD):
        raise AssertionError(
            f"phase7d: broken {sess.broken}, valid {res['valid']}, "
            f"{res['failure-count']} failures, {online} keys online; want "
            f"False, {MIXED_BAD}, {MIXED_KEYS - MIXED_BAD}")
    check_exact("phase7d", cas_register, h, res)
    return r


def online_rolling(torch, dev, n_ops: int = ROLLING_OPS) -> dict:
    """7e: RollingChecker over one key's n_ops-op stream (no :info ops,
    so stable prefixes can go), with and without discards: equal
    verdicts; with discards at least half the rows go and the resident
    rows never reach a quarter of the stream's (they rise and fall with
    the discard points, not with the stream's length)."""
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.monitor import RollingChecker
    from jepsen_tpu_torch.utils.histgen import random_register_history

    stream = random_register_history(n_ops, procs=8, info_rate=0.0,
                                     seed=BENCH_SEED)
    pm = cas_register().packed()
    out = {}
    for discard in (True, False):
        def run():
            rc = RollingChecker(pm, discard=discard, device=dev)
            peak = 0
            t0 = time.perf_counter()
            for i, op in enumerate(stream):
                rc.feed(0, op)
                if i % 1024 == 0:
                    peak = max(peak, rc.resident_rows())
            status = rc.status()
            return rc.finish(), status, peak, time.perf_counter() - t0

        (verdicts, status, peak, wall), launches, counts = counted(
            torch, dev, run)
        need_launches(f"phase7e discard={discard}", dev, launches)
        out["discard" if discard else "keep"] = {
            "verdicts": verdicts, "max_resident_rows": peak,
            "rows": status["discarded-rows"] + status["resident-rows"],
            "discarded_rows": status["discarded-rows"],
            "blocks": status["blocks-done"],
            "epoch_restarts": status["epoch-restarts"], "wall_s": wall,
            "sweep_launches": launches.get("witness_sweep", 0),
            "host_syncs": counts.get("host_syncs", 0),
        }
    log("phase7e: " + json.dumps(out))
    d, k = out["discard"], out["keep"]
    if d["verdicts"] != k["verdicts"] or d["verdicts"] != {0: True}:
        raise AssertionError(f"phase7e: verdicts {d['verdicts']} with "
                             f"discards, {k['verdicts']} without")
    if d["max_resident_rows"] * 4 > d["rows"] or d["discarded_rows"] * 2 < d["rows"]:
        raise AssertionError(f"phase7e: resident rows not bounded: "
                             f"{d['max_resident_rows']} of {d['rows']}")
    return out


def phase_online(torch, pm, packed, history, dev=None,
                 scale_ops: int = SCALE_OPS,
                 rolling_ops: int = ROLLING_OPS) -> dict:
    """Phase 7, online checking on `dev` (the card by default)."""
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    return {
        "carry": online_carry(torch, dev, pm, packed),
        "scale": online_scale(torch, dev, pm, scale_ops),
        "live": online_live(torch, dev, history),
        "keyed": online_keyed(torch, dev),
        "rolling": online_rolling(torch, dev, rolling_ops),
    }


# ---------------------------------------------------------------------------
# Elle (phase 8): list-append and rw-register checking, with the closure
# screen and the witness-cycle extraction on the card.  The history
# generators are shared with the tests.

#: Committed transactions of phase 8's histories: about the most the
#: device path takes (1,000 vertices pad to V = 1,024, the screen's
#: max_device_vertices), and past it for 8e.
ELLE_TXNS, ELLE_BIG_TXNS, ELLE_SEED = 1000, 2000, 45100
ELLE_MODELS = ("serializable", "strict-serializable")
#: 8d: random graphs of 16-128 vertices through one screen call.
SCREEN_GRAPHS = 512
#: Dense bfloat16 peak of one H100 SXM (NVIDIA data sheet), for the bound.
BF16_FLOP_PER_S = 989e12

#: The transactions of each anomaly phase 8 injects, as committed (the
#: micro-ops with what the reads returned), on keys no other
#: transaction touches.  They run concurrently, so realtime orders none
#: of them against another.
ELLE_ANOMALIES = {
    "append": {
        # ww both ways: x is 0 (first) then 1 (second); y the reverse.
        "G0": [[["append", "g0-x", 0], ["append", "g0-y", 1]],
               [["append", "g0-y", 0], ["append", "g0-x", 1]],
               [["r", "g0-x", [0, 1]], ["r", "g0-y", [0, 1]]]],
        # wr both ways: each reads the other's append.
        "G1c": [[["append", "g1c-x", 0], ["r", "g1c-y", [0]]],
                [["append", "g1c-y", 0], ["r", "g1c-x", [0]]]],
        # read skew: the first misses the second's x (rw) but reads its
        # y (wr); the third fixes x's order.
        "G-single": [[["r", "gs-x", []], ["r", "gs-y", [0]]],
                     [["append", "gs-x", 0], ["append", "gs-y", 0]],
                     [["r", "gs-x", [0]]]],
    },
    "wr": {
        "G1c": [[["w", "g1c-x", 1], ["r", "g1c-y", 1]],
                [["w", "g1c-y", 1], ["r", "g1c-x", 1]]],
        # the initial x (rw to its writer) beside that writer's y (wr).
        "G-single": [[["r", "gs-x", None], ["r", "gs-y", 1]],
                     [["w", "gs-x", 1], ["w", "gs-y", 1]]],
    },
}
#: Transactions of the long G-single ("G-single-chain"): ELLE_CHAIN
#: appends to one key, put in order by a final read (a chain of ww
#: edges), the last of which missed the first's append to another key
#: (one rw edge back to the first).  Its cycle runs through all of
#: them, so the extraction's BFS walks ELLE_CHAIN - 1 levels.
ELLE_CHAIN = 100
ELLE_ANOMALIES["append"]["G-single-chain"] = (
    [[["append", "lc-x", 0], ["append", "lc-y", 0]]]
    + [[["append", "lc-x", i]] for i in range(1, ELLE_CHAIN - 1)]
    + [[["append", "lc-x", ELLE_CHAIN - 1], ["r", "lc-y", []]]]
    + [[["r", "lc-x", list(range(ELLE_CHAIN))], ["r", "lc-y", [0]]]])


def elle_ops(kind: str, n_txns: int, seed: int, *, inject=()) -> list:
    """One seeded concurrent run of the port's AppendGen ("append") or
    WrGen ("wr") at the reference workloads' defaults (10 keys, 1-4
    micro-ops, 32 appends per key), as op dicts (type, f, value,
    process) in history order, with `n_txns` committed transactions.

    10 workers; a seeded random.Random picks which one moves next:
    an idle worker invokes its generator's next transaction, a busy one
    completes.  A completion applies the transaction atomically to an
    in-memory store, as the reference's InMemoryAppendClient and
    InMemoryWrClient do, and is :ok; with probability 0.05 it is
    :info instead, the transaction applied or not (a seeded coin), and
    the worker goes on under a fresh process.  So the history is strict
    serializable.  Each name in `inject` (a key of ELLE_ANOMALIES[kind])
    adds that anomaly's transactions, spaced evenly through the run:
    all invoked, then all completed :ok, on processes of their own."""
    from collections import defaultdict

    from jepsen_tpu_torch.checker.elle import AppendGen, WrGen

    procs, info = 10, 0.05
    gen = (AppendGen if kind == "append" else WrGen)(rng=random.Random(seed))
    rng = random.Random(seed + 1)
    state: dict = defaultdict(list) if kind == "append" else {}

    def apply(txn):
        out = []
        for f, k, v in txn:
            if f == "append":
                state[k].append(v)
            elif f == "w":
                state[k] = v
            else:
                v = list(state[k]) if kind == "append" else state.get(k)
            out.append([f, k, v])
        return out

    marks = [(i + 1) * n_txns // (len(inject) + 1)
             for i in range(len(inject))]
    todo = list(zip(marks, inject))
    ops: list = []
    pids = list(range(procs))
    next_pid, inject_pid = procs, 1 << 20
    pending: dict = {}
    committed = 0
    while committed < n_txns or pending:
        w = rng.randrange(procs)
        if w in pending:
            txn = pending.pop(w)
            if rng.random() < info:
                if rng.random() < 0.5:
                    apply(txn)
                ops.append({"type": "info", "f": "txn", "value": txn,
                            "process": pids[w]})
                pids[w], next_pid = next_pid, next_pid + 1
                continue
            ops.append({"type": "ok", "f": "txn", "value": apply(txn),
                        "process": pids[w]})
            committed += 1
            while todo and committed >= todo[0][0]:
                txns = ELLE_ANOMALIES[kind][todo.pop(0)[1]]
                for p, txn in enumerate(txns):
                    ops.append({"type": "invoke", "f": "txn",
                                "value": [[f, k, None if f == "r" else v]
                                          for f, k, v in txn],
                                "process": inject_pid + p})
                for p, txn in enumerate(txns):
                    ops.append({"type": "ok", "f": "txn", "value": txn,
                                "process": inject_pid + p})
                inject_pid += len(txns)
        elif committed + len(pending) < n_txns:
            pending[w] = gen()["value"]
            ops.append({"type": "invoke", "f": "txn", "value": pending[w],
                        "process": pids[w]})
    return ops


def random_dep_graphs(n: int, seed: int, DepGraph) -> list:
    """`n` random dependency graphs (either package's DepGraph) of 16-128
    vertices: a random DAG of about 3 edges per vertex with random
    types; in about half of them one edge doubled by a back edge,
    closing a cycle."""
    rng = random.Random(seed)
    graphs = []
    for _ in range(n):
        V = rng.randint(16, 128)
        order = list(range(V))
        rng.shuffle(order)
        g = DepGraph()
        for x in range(V):
            g.add_vertex(x)
        for _ in range(3 * V):
            a, b = sorted(rng.sample(range(V), 2))
            g.add_edge(order[a], order[b], rng.choice(("ww", "wr", "rw")))
        if rng.random() < 0.5:
            a, b = sorted(rng.sample(range(V), 2))
            g.add_edge(order[a], order[b], "ww")
            g.add_edge(order[b], order[a], "rw")
        graphs.append(g)
    return graphs


#: The edge type each layer's cycle must carry (graph.check_cycles).
LAYER_TYPES = {"G0": {"ww"}, "G1c": {"wr"}, "G-single": {"rw"},
               "G2-item": {"rw"}}


def check_device_cycles(g, res: dict) -> int:
    """Raises unless every cycle record in `res` is a closed cycle of
    real edges of `g` that carries its layer's edge type, with its SCC
    size -> the number of records."""
    n = 0
    for recs in res["anomalies"].values():
        for r in recs:
            if not (isinstance(r, dict) and "cycle" in r):
                continue
            c = r["cycle"]
            carried = set()
            for a, b in zip(c, c[1:]):
                if not g.edge_types(a, b):
                    raise AssertionError(f"cycle {c} uses no edge {a}->{b}")
                carried |= g.edge_types(a, b)
            need = LAYER_TYPES.get(r["type"], set())
            if (len(c) < 3 or c[0] != c[-1] or (need and not carried & need)
                    or not isinstance(r["scc-size"], int)
                    or r["scc-size"] < len(c) - 1):
                raise AssertionError(f"bad device cycle record {r}")
            n += 1
    return n


def elle_check(torch, dev, kind: str, model: str, history,
               reps: int) -> tuple:
    """`reps` counted checks of `history` through the port's
    AppendChecker or WrChecker on `dev`, and one with device="off" ->
    (reading, device result, host result, the dependency graph)."""
    from jepsen_tpu_torch.checker.elle import (AppendChecker, WrChecker,
                                               analyze_append, analyze_wr)
    from jepsen_tpu_torch.ops import scc

    make = AppendChecker if kind == "append" else WrChecker
    analyze = analyze_append if kind == "append" else analyze_wr
    host = make(model, device="off").check({}, history, {})
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res, _, counts = counted(
            torch, dev, lambda: make(model, device=dev).check({}, history, {}))
        times.append(time.perf_counter() - t0)
    seen = {}

    def spy(g):
        seen["t"], seen["g"] = time.perf_counter(), g
        return scc.check_cycles_device([g], device=dev)[0]

    t0 = time.perf_counter()
    analyze(history.client_ops(), consistency_model=model, cycle_fn=spy)
    g = seen["g"]
    n_ok = sum(1 for o in history if o.is_ok)
    r = {
        "kind": kind, "model": model, "committed": n_ok,
        "vertices": len(g.vertices),
        "edges": res["edges"], "valid": res["valid"],
        "anomaly_types": res["anomaly-types"],
        "wall_s": times, "median_s": statistics.median(times),
        "txns_per_s": n_ok / statistics.median(times),
        "graph_build_s": seen["t"] - t0,
        "screens": counts.get("scc_screens", 0),
        "extractions": counts.get("scc_extractions", 0),
        "bfs_levels": counts.get("scc_bfs_levels", 0),
        "bfs_graph_levels": counts.get("scc_bfs_graph_levels", 0),
        "host_syncs": counts.get("host_syncs", 0),
    }
    if dev.type == "cuda" and r["screens"]:
        adj = torch.from_numpy(scc.pack_adjacency([g])[0]).to(dev)
        r["screen_shape"] = list(adj.shape)
        r["closure_ms"] = cuda_ms(
            lambda: scc.has_cycle(adj, torch.bfloat16), reps=20)
    if dev.type == "cuda" and r["extractions"]:
        layers = scc.layer_entries(g)
        a_all, a_req, _ = scc.pack_required([x[0] for x in layers],
                                            [x[1] for x in layers])
        A, R = (torch.from_numpy(x).to(dev) for x in (a_all, a_req))
        r["extract_shape"] = list(A.shape)
        r["extract_ms"] = cuda_ms(
            lambda: scc.extract_batch(A, R, torch.bfloat16), reps=5)
    return r, res, host, g


def closure_ops(K: int, V: int) -> float:
    """Floating-point operations of one closure: ceil(log2 V) batched
    V x V products, 2 V^3 each per graph."""
    from jepsen_tpu_torch.ops import scc

    return scc._steps(V) * 2.0 * K * V ** 3


def bound(ops: float, n_bytes: float) -> tuple:
    """(bound ms, "operations" or "bytes"): the larger of the operations
    at the bfloat16 peak and the bytes at the memory rate."""
    t_ops, t_bytes = ops / BF16_FLOP_PER_S * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_elle(torch, dev=None) -> dict:
    """Phase 8 on `dev` (the card by default): 8a-8e of the module doc.
    Raises on any failed check."""
    from jepsen_tpu_torch.checker.elle import AppendChecker, DepGraph
    from jepsen_tpu_torch.history.core import Op, history
    from jepsen_tpu_torch.ops import scc

    dev = torch.device("cuda") if dev is None else torch.device(dev)
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    out: dict = {"checks": [], "graphs": {}}
    chain = ELLE_ANOMALIES["append"]["G-single-chain"]
    # (sub-phase, generator, injected anomalies, transactions generated,
    # anomaly types the device result must hold)
    cases = [("8a", "append", (), ELLE_TXNS, set()),
             ("8b", "append", ("G0", "G1c", "G-single"), ELLE_TXNS,
              {"G0", "G1c", "G-single"}),
             ("8b-chain", "append", ("G-single-chain",),
              ELLE_TXNS - len(chain), {"G-single"}),
             ("8c", "wr", (), ELLE_TXNS, set()),
             ("8c", "wr", ("G-single",), ELLE_TXNS, {"G-single"})]
    for sub, kind, inject, n_txns, want in cases:
        h = history([Op(**d) for d in elle_ops(kind, n_txns, ELLE_SEED,
                                                inject=inject)])
        bad = bool(inject)
        for model in ELLE_MODELS:
            r, res, host, g = elle_check(torch, dev, kind, model, h, reps=3)
            r["sub_phase"], r["injected"] = sub, bad
            if r["screens"] != 1 or scc._bucket(len(g.vertices), 8) != 1024:
                raise AssertionError(f"{sub}: not screened at V = 1,024: {r}")
            if not bad:
                if res["valid"] is not True or res != host:
                    raise AssertionError(f"{sub} {model}: {res} != {host}")
                if r["extractions"]:
                    raise AssertionError(f"{sub}: extraction on a valid run")
            else:
                if (res["valid"] is not False
                        or res["anomaly-types"] != host["anomaly-types"]
                        or not want <= set(res["anomaly-types"])):
                    raise AssertionError(
                        f"{sub} {model}: {res['valid']} "
                        f"{res['anomaly-types']} (host "
                        f"{host['anomaly-types']})")
                if r["extractions"] != 1 or len(scc.layer_entries(g)) != 4:
                    raise AssertionError(f"{sub}: not extracted as K = 4 "
                                         f"on the device: {r}")
                r["device_cycles"] = check_device_cycles(g, res)
            if sub == "8b-chain":
                # The G-single closes through every chain transaction,
                # and the BFS walks the chain level by level.
                lens = [len(x["cycle"]) - 1 for x in res["anomalies"]
                        ["G-single"] if "cycle" in x]
                if (lens != [ELLE_CHAIN]
                        or r["bfs_levels"] < ELLE_CHAIN - 1):
                    raise AssertionError(f"8b-chain: cycles of {lens} "
                                         f"transactions, {r}")
            log(f"phase{sub}: " + json.dumps(r))
            out["checks"].append(r)
            out["graphs"].setdefault(sub, g)
            if sub == "8b":
                out["profile_check"] = (h, model)

    if cuda:
        # The library call of the closure: its ceil(log2 V) bmm products
        # alone, at 8a's shape.
        a16 = torch.from_numpy(
            scc.pack_adjacency([out["graphs"]["8a"]])[0]).to(dev).to(
                torch.bfloat16)

        def bmm_steps():
            for _ in range(scc._steps(a16.shape[-1])):
                torch.bmm(a16, a16)

        out["bmm_ms"] = cuda_ms(bmm_steps, reps=20)
        log(f"phase8a: the closure's {scc._steps(a16.shape[-1])} bare "
            f"torch.bmm calls at {list(a16.shape)}: {out['bmm_ms']:.6f} ms "
            f"(CUDA events)")

    # 8d: many graphs through one screen call (K > 1).
    graphs = random_dep_graphs(SCREEN_GRAPHS, ELLE_SEED, DepGraph)
    t0 = time.perf_counter()
    flags, _, counts = counted(
        torch, dev, lambda: scc.screen_cycles(graphs, device=dev))
    wall = time.perf_counter() - t0
    want = [bool(g.sccs()) for g in graphs]
    if flags.tolist() != want or counts.get("scc_screens") != 1:
        raise AssertionError("8d: screen flags differ from host sccs()")
    adj = torch.from_numpy(scc.pack_adjacency(graphs)[0]).to(dev)
    d = {"graphs": len(graphs), "cyclic": sum(want),
         "shape": list(adj.shape), "wall_s": wall}
    if not 0.3 < d["cyclic"] / len(graphs) < 0.7:
        raise AssertionError(f"8d: {d['cyclic']} cyclic graphs of "
                             f"{len(graphs)}")
    if cuda:
        d["closure_ms"] = cuda_ms(
            lambda: scc.has_cycle(adj, torch.bfloat16), reps=20)
    log("phase8d: " + json.dumps(d))
    out["screen_batch"] = d

    # 8e: past max_device_vertices, the host route with no device call.
    h = history([Op(**x) for x in elle_ops("append", ELLE_BIG_TXNS,
                                           ELLE_SEED)])
    t0 = time.perf_counter()
    res, _, counts = counted(
        torch, dev, lambda: AppendChecker(device=dev).check({}, h, {}))
    e = {"txns": ELLE_BIG_TXNS, "wall_s": time.perf_counter() - t0,
         "valid": res["valid"], "screens": counts.get("scc_screens", 0),
         "extractions": counts.get("scc_extractions", 0)}
    if (e["screens"] or e["extractions"]
            or res != AppendChecker(device="off").check({}, h, {})
            or res["valid"] is not True):
        raise AssertionError(f"8e: {e}")
    log("phase8e: " + json.dumps(e))
    out["big"] = e
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase8: {out['wall_s']:.3f} s")
    return out


def elle_programs(torch, elle: dict) -> list:
    """The device-program entries (B7 and B8) of phase 8 for the JSON
    line before the kernels line: CUDA-event times from phase 8, device
    time and operations per call from torch.profiler (phase 3), and the
    bound from this run's shapes and BFS levels."""
    import inspect

    from jepsen_tpu_torch.checker.elle import AppendChecker
    from jepsen_tpu_torch.ops import scc

    dev = torch.device("cuda")
    a8 = next(r for r in elle["checks"] if r["sub_phase"] == "8a")
    b8 = next(r for r in elle["checks"] if r["sub_phase"] == "8b")
    g_a, g_b = elle["graphs"]["8a"], elle["graphs"]["8b"]

    adj = torch.from_numpy(scc.pack_adjacency([g_a])[0]).to(dev)
    K, V = adj.shape[0], adj.shape[1]
    seen = profile_device(torch, lambda: scc.has_cycle(adj, torch.bfloat16),
                          reps=20)
    b7_bound = bound(closure_ops(K, V), K * V * V + K)
    b7 = {"name": "scc_closure_screen", "route": "torch",
          "source": "jepsen_tpu_torch/ops/scc.py:"
                    f"{inspect.getsourcelines(scc.has_cycle)[1]}",
          "replaces": "jepsen_tpu/ops/scc.py:81",
          "shape": list(adj.shape), "launches": a8["screens"],
          "ms": a8["closure_ms"],
          "device_ms": sum(us for _, us in seen.values()) / 20 / 1e3,
          "device_ops_per_call": sum(n for n, _ in seen.values()) / 20,
          "bound_ms": b7_bound[0], "bound_by": b7_bound[1],
          "library_ms": elle["bmm_ms"],
          "batch_shape": elle["screen_batch"]["shape"],
          "batch_ms": elle["screen_batch"]["closure_ms"]}
    seen = profile_device(torch, lambda: scc.screen_cycles([g_a], device=dev),
                          reps=5)
    b7["screen_call_device_ops"] = sum(n for n, _ in seen.values()) / 5

    layers = scc.layer_entries(g_b)
    a_all, a_req, _ = scc.pack_required([x[0] for x in layers],
                                        [x[1] for x in layers])
    A, R = (torch.from_numpy(x).to(dev) for x in (a_all, a_req))
    K8, V8 = A.shape[0], A.shape[1]
    seen = profile_device(
        torch, lambda: scc.extract_batch(A, R, torch.bfloat16), reps=1)
    b8_bound = bound(closure_ops(K8, V8)
                     + b8["bfs_graph_levels"] * 2.0 * V8 * V8,
                     2 * K8 * V8 * V8 + 4 * K8 * (V8 + 4))
    b8e = {"name": "scc_extract", "route": "torch",
           "source": "jepsen_tpu_torch/ops/scc.py:"
                     f"{inspect.getsourcelines(scc.extract_batch)[1]}",
           "replaces": "jepsen_tpu/ops/scc.py:162",
           "shape": list(A.shape), "launches": b8["extractions"],
           "bfs_levels": b8["bfs_levels"], "ms": b8["extract_ms"],
           "device_ms": sum(us for _, us in seen.values()) / 1e3,
           "device_ops_per_call": sum(n for n, _ in seen.values()),
           "bound_ms": b8_bound[0], "bound_by": b8_bound[1],
           "library_ms": None}
    h, model = elle["profile_check"]
    seen = profile_device(
        torch, lambda: AppendChecker(model, device=dev).check({}, h, {}),
        reps=1)
    b8e["check_device_ms"] = sum(us for _, us in seen.values()) / 1e3
    b8e["check_device_ops"] = sum(n for n, _ in seen.values())

    # The many-level extraction (8b-chain) beside the one-level one
    # (8b), both serializable and at the same shape: the difference per
    # extra level is one level's cost (a host read, an index upload and
    # the level's device work).
    one = next(r for r in elle["checks"] if r["sub_phase"] == "8b"
               and r["model"] == b8["model"])
    many = next(r for r in elle["checks"] if r["sub_phase"] == "8b-chain"
                and r["model"] == b8["model"])
    layers = scc.layer_entries(elle["graphs"]["8b-chain"])
    a_all, a_req, _ = scc.pack_required([x[0] for x in layers],
                                        [x[1] for x in layers])
    A, R = (torch.from_numpy(x).to(dev) for x in (a_all, a_req))
    seen = profile_device(
        torch, lambda: scc.extract_batch(A, R, torch.bfloat16), reps=1)
    long_bound = bound(closure_ops(K8, V8)
                       + many["bfs_graph_levels"] * 2.0 * V8 * V8,
                       2 * K8 * V8 * V8 + 4 * K8 * (V8 + 4))
    b8e["long_chain"] = {
        "shape": list(A.shape), "bfs_levels": many["bfs_levels"],
        "bfs_graph_levels": many["bfs_graph_levels"],
        "ms": many["extract_ms"],
        "device_ms": sum(us for _, us in seen.values()) / 1e3,
        "device_ops_per_call": sum(n for n, _ in seen.values()),
        "bound_ms": long_bound[0], "bound_by": long_bound[1],
        "one_level_ms": one["extract_ms"],
        "ms_per_extra_level": (many["extract_ms"] - one["extract_ms"])
        / (many["bfs_levels"] - one["bfs_levels"])}
    for e in (b7, b8e):
        log(f"profile: {e['name']}: " + json.dumps(e))
    return [b7, b8e]


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
    online_r = phase_online(torch, pm, packed, history)
    elle_r = phase_elle(torch)
    entry["launches_online"] = {
        "carry": online_r["carry"]["sweep_launches"],
        "scale": online_r["scale"]["sweep_launches"],
        "live": online_r["live"]["sweep_launches"],
        "keyed": online_r["keyed"]["session_launches"],
        "rolling": online_r["rolling"]["discard"]["sweep_launches"],
    }
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
    programs = elle_programs(torch, elle_r)
    main_r["breakdown"] = breakdown(torch, history)
    log("profile: main path breakdown " + json.dumps(main_r["breakdown"]))
    bad_r = phase_invalid(torch)

    log(f"phase4 done; main path {main_r['ops_per_s']:.1f} ops/s, "
        f"invalid path {bad_r['wall_s']:.3f} s; many-key mixed "
        f"{mixed_r['mixed']['ops_per_s']:.1f} ops/s, all-valid "
        f"{mixed_r['all_valid']['ops_per_s']:.1f} ops/s; online "
        f"{online_r['scale']['ops']} ops, verdict lag "
        f"{online_r['scale']['verdict_lag_s']:.3f} s, lag_fraction "
        f"{online_r['scale']['lag_fraction']:.4f}; Elle phase 8 "
        f"{elle_r['wall_s']:.3f} s")
    print(json.dumps({"device_programs": programs}))
    print(json.dumps({"kernels": [entry] + more}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
