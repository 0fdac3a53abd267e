#!/usr/bin/env python
"""Differential soak of the port: the device checker against the exact
CPU engine, and the stream witness and the witness's transfer modes
against each other.

Two parts, carried over from tools/fuzz_soak.py and tools/soak_round5.py:

* The fuzz soak.  tests/test_fuzz_parity.py's five model families
  (cas-register, multi-register, mutex, FIFO and unordered queue;
  linearizable-by-construction interleavings, half of the trials at
  each size with an early injected corruption), copied here onto the
  port's histories, at the CI sizes plus fuzz_soak's extra sizes
  (cas-register 1,500 and 2,600, past the witness window roll and the
  >2,000-op route; 700 / 700 / 600 / 600 for the rest).  Each history
  is decided by `check_wgl_device` on `--device` and by the exact
  engine `check_wgl_cpu` (20 s budget, 60 s at the extra sizes, as in
  fuzz_soak).  An "unknown" on either side is
  skipped; any other disagreement is a mismatch, printed with its seed.
* The round-5 part.  Keyed batches of 3, 8 or 20 cas-register or
  register histories: every True of `check_wgl_witness_stream` must
  agree with the exact engine, and on three sampled keys
  `check_wgl_witness` must give equal verdicts and an equal death rank
  in its "full", "indices" and "device" transfer modes.  A planted
  violation the exact engine does not convict is a mismatch too.

    python3 tools/port_soak.py [--minutes 5] [--seed-base 0] [--device cpu]

alternates one fuzz round and one round-5 batch until the budget is
spent (checked between histories), prints progress lines and, last,
one JSON summary line; exits 1 on any mismatch, 2 when nothing was
compared.  `fuzz_schedule` (a fixed list of trials, as chip_smoke.py's
phase 20b runs it), `run_trials` and `round5_batch` are importable.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
import zlib
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from jepsen_tpu_torch.history.core import Op, history  # noqa: E402
from jepsen_tpu_torch.models import (  # noqa: E402
    cas_register,
    fifo_queue,
    multi_register,
    mutex,
    unordered_queue,
)
from jepsen_tpu_torch.utils.histgen import random_register_history  # noqa: E402

#: The exact engine's budget a history (fuzz) at the CI sizes and at
#: the extra ones, and the device check's.  The extra sizes get the
#: bigger budget, as in fuzz_soak: at 20 s they mostly time out to
#: unknown and the boundary coverage would be vacuous.
CPU_BUDGET_S = 20.0
EXTRA_CPU_BUDGET_S = 60.0
DEVICE_BUDGET_S = 60.0


# -- tests/test_fuzz_parity.py's generators, on the port's histories -----


def _interleave(rng, n_ops, procs, plan_op, apply_op,
                corrupt_rate=0.0, corrupt_fn=None):
    """Generic linearizable-by-construction interleaver: each process
    invokes, then later completes; the op's effect applies atomically
    at completion.  plan_op(rng, state) -> (f, value) or None (no op
    currently legal for this process); apply_op(state, f, value) ->
    (ok, completion_value).  corrupt_fn(rng, f, value) perturbs an
    observed completion value.  (No indeterminate ops here: the queue
    encoders have no packed form for info dequeues; the register
    family covers info-op coverage via random_register_history.)"""
    state: dict = {"_": None}
    ops: list[Op] = []
    pending: dict[int, tuple] = {}
    started = 0
    while started < n_ops or pending:
        p = rng.randrange(procs)
        if p in pending:
            f, value = pending.pop(p)
            ok, out = apply_op(state, f, value)
            if ok and corrupt_fn and rng.random() < corrupt_rate:
                out = corrupt_fn(rng, f, out)
            ops.append(Op(
                type="ok" if ok else "fail", f=f,
                value=out, process=p,
            ))
        elif started < n_ops:
            planned = plan_op(rng, state, p)
            if planned is None:
                continue
            f, value = planned
            ops.append(Op(type="invoke", f=f, value=value, process=p))
            pending[p] = (f, value)
            started += 1
    return history(ops)


def mutex_history(rng, n_ops, procs, corrupt=False):
    """Processes contend for one lock; a process invokes acquire when
    it doesn't hold it and release when it does.  Corruption flips
    exactly ONE early failed acquire to ok — a double-hold, early so
    the exact oracle contradicts on a short prefix."""
    holding: set = set()
    armed = [corrupt]
    completions = [0]

    ops: list[Op] = []
    pending: dict[int, str] = {}
    started = 0
    while started < n_ops or pending:
        p = rng.randrange(procs)
        if p in pending:
            f = pending.pop(p)
            completions[0] += 1
            if f == "acquire":
                if not holding:
                    holding.add(p)
                    ops.append(Op(type="ok", f=f, value=None, process=p))
                elif armed[0] and completions[0] > max(4, n_ops // 20):
                    # corrupt: claim the held lock anyway (once)
                    armed[0] = False
                    ops.append(Op(type="ok", f=f, value=None, process=p))
                else:
                    ops.append(Op(type="fail", f=f, value=None,
                                  process=p))
            else:
                holding.discard(p)
                ops.append(Op(type="ok", f=f, value=None, process=p))
        elif started < n_ops:
            f = "release" if p in holding else "acquire"
            ops.append(Op(type="invoke", f=f, value=None, process=p))
            pending[p] = f
            started += 1
    return history(ops)


def queue_history(rng, n_ops, procs, corrupt=False, fifo=True):
    """Unique-value enqueues; dequeues observe the simulated queue's
    head (fifo) — also a legal unordered-queue history.  Corruption
    rewrites ONE early dequeue's observed value to a fresh
    never-enqueued one: early, so the exact oracle contradicts on a
    short prefix instead of blowing its budget proving a deep
    violation."""
    q: list[int] = []
    counter = [0]
    seen = [0]
    armed = [corrupt]

    def plan(rng, state, p):
        # Bias toward dequeue as the queue deepens: the packed model
        # has 32 slots, and a history whose true queue ever exceeds
        # them is undecidable in packed form.
        enq_p = 0.8 if len(q) < 4 else (0.5 if len(q) < 12 else 0.1)
        if rng.random() < enq_p or not q:
            counter[0] += 1
            return ("enqueue", counter[0])
        return ("dequeue", None)

    def apply(state, f, value):
        if f == "enqueue":
            q.append(value)
            return True, value
        if not q:
            return False, None
        return True, q.pop(0 if fifo else rng.randrange(len(q)))

    def corrupt_fn(rng, f, out):
        seen[0] += 1
        if (f == "dequeue" and out is not None and armed[0]
                and seen[0] > max(4, n_ops // 20)):
            armed[0] = False
            return out + 100000  # never enqueued
        return out

    return _interleave(rng, n_ops, procs, plan, apply,
                       corrupt_rate=1.0, corrupt_fn=corrupt_fn)


def multi_register_history(rng, n_ops, procs, keys=("a", "b", "c"),
                           corrupt=False):
    """Per-(k, v) reads/writes over a fixed register set; corruption
    rewrites one early read's observed value."""
    values = {k: 0 for k in keys}
    counter = [0]
    seen = [0]
    armed = [corrupt]

    def plan(rng, state, p):
        k = rng.choice(keys)
        if rng.random() < 0.5:
            return ("read", (k, None))
        counter[0] += 1
        return ("write", (k, counter[0]))

    def apply(state, f, value):
        k, v = value
        if f == "write":
            values[k] = v
            return True, (k, v)
        return True, (k, values[k])

    def corrupt_fn(rng, f, out):
        seen[0] += 1
        if (f == "read" and armed[0]
                and seen[0] > max(4, n_ops // 20)):
            armed[0] = False
            return (out[0], out[1] + 100000)  # never written
        return out

    return _interleave(rng, n_ops, procs, plan, apply,
                       corrupt_rate=1.0, corrupt_fn=corrupt_fn)


#: (name, packed-model, history_fn(rng, size, corrupt) -> History, CI
#: sizes): tests/test_fuzz_parity.py's CONFIGS.  Corruption is injected
#: early in every corrupt trial, so the exact oracle contradicts on a
#: short prefix and settles inside its budget.
CONFIGS = [
    (
        "cas-register",
        lambda: cas_register().packed(),
        lambda rng, n, corrupt: random_register_history(
            n, procs=8, info_rate=0.08, seed=rng.randrange(1 << 30),
            bad_at=rng.uniform(0.05, 0.3) if corrupt else None,
        ),
        (60, 300, 900),
    ),
    (
        "multi-register",
        lambda: multi_register({"a": 0, "b": 0, "c": 0}).packed(),
        lambda rng, n, corrupt: multi_register_history(
            rng, n, procs=6, corrupt=corrupt,
        ),
        (60, 300),
    ),
    (
        "mutex",
        lambda: mutex().packed(),
        lambda rng, n, corrupt: mutex_history(
            rng, n, procs=6, corrupt=corrupt,
        ),
        (60, 300),
    ),
    (
        "fifo-queue",
        lambda: fifo_queue().packed(),
        lambda rng, n, corrupt: queue_history(
            rng, n, procs=6, corrupt=corrupt,
        ),
        (60, 240),
    ),
    (
        "unordered-queue",
        lambda: unordered_queue().packed(),
        lambda rng, n, corrupt: queue_history(
            rng, n, procs=6, fifo=False, corrupt=corrupt,
        ),
        (60, 240),
    ),
]

#: fuzz_soak's sizes past the CI's: the cas-register family crosses the
#: witness window roll and the >2,000-op route, every other family goes
#: past its CI maximum.
EXTRA_SIZES = {
    "cas-register": (1500, 2600),
    "multi-register": (700,),
    "mutex": (700,),
    "fifo-queue": (600,),
    "unordered-queue": (600,),
}


def family_seed(seed_base: int, round_i: int, name: str) -> int:
    """A family's rng seed in a round.  crc32, not hash(): string hashing
    is salted per process and would make a reported mismatch
    unreproducible."""
    return seed_base + round_i * 1009 + (zlib.crc32(name.encode()) & 0xFFFF)


def sizes_of(name: str) -> tuple:
    """A family's CI sizes, then its extra ones."""
    ci = next(c[3] for c in CONFIGS if c[0] == name)
    return tuple(ci) + EXTRA_SIZES.get(name, ())


def fuzz_schedule(seed_base: int = 0, round_i: int = 1) -> list:
    """One round's trials as [(family, size, corrupt, family seed)],
    size rank by size rank: every family at its smallest size, then
    every family at its next one, and so on; one valid and one corrupt
    history each.  Each family draws its histories from one rng seeded
    by `family_seed`, in the order the schedule lists them, which is
    fuzz_soak's order within a family: the same histories."""
    ranks = max(len(sizes_of(c[0])) for c in CONFIGS)
    out = []
    for r in range(ranks):
        for name, *_ in CONFIGS:
            sizes = sizes_of(name)
            if r < len(sizes):
                for corrupt in (False, True):
                    out.append((name, sizes[r], corrupt,
                                family_seed(seed_base, round_i, name)))
    return out


class Tally:
    """What a soak compared: trials, decided and unknown counts per
    family and size, verdicts decided, the mismatches."""

    def __init__(self):
        self.trials = 0
        self.decided: Counter = Counter()
        self.unknown: Counter = Counter()
        self.verdicts: Counter = Counter()
        self.families: Counter = Counter()
        #: Each family's longest history that both engines decided, in
        #: packed ops.
        self.packed_max: dict = {}
        self.mismatches: list = []

    def summary(self) -> dict:
        return {
            "trials": self.trials,
            "decided_per_config": dict(self.decided),
            "unknown_per_config": dict(self.unknown),
            "decided_true": self.verdicts[True],
            "decided_false": self.verdicts[False],
            "decided_per_family": dict(self.families),
            "packed_max": self.packed_max,
            "mismatches": len(self.mismatches),
        }


def run_trials(schedule: list, device: str = "cuda",
               deadline: float = None, tally: Tally = None,
               cpu_budgets_s: tuple = (CPU_BUDGET_S, EXTRA_CPU_BUDGET_S),
               device_budget_s: float = DEVICE_BUDGET_S) -> Tally:
    """Runs `schedule`'s trials in order (stopping between histories at
    `deadline`, a `time.monotonic()` reading), each history decided by
    the device checker on `device` and by the exact CPU engine, each
    under its budget: the exact engine's is `cpu_budgets_s[0]` at a CI
    size and `cpu_budgets_s[1]` at an extra one."""
    from jepsen_tpu_torch.checker.wgl_cpu import check_wgl_cpu
    from jepsen_tpu_torch.history.packed import pack_history
    from jepsen_tpu_torch.ops.wgl import check_wgl_device

    tally = tally or Tally()
    cfg = {c[0]: c for c in CONFIGS}
    rngs: dict = {}
    pms: dict = {}
    for name, size, corrupt, seed in schedule:
        if deadline is not None and time.monotonic() >= deadline:
            break
        _, pm_fn, hist_fn, _ = cfg[name]
        rng = rngs.setdefault((name, seed), random.Random(seed))
        pm = pms.setdefault(name, pm_fn())
        packed = pack_history(hist_fn(rng, size, corrupt), pm.encode)
        dev = check_wgl_device(packed, pm, time_limit_s=device_budget_s,
                               device=device)
        # An unknown on either side is skipped, so the exact engine runs
        # only where the device decided.
        budget = cpu_budgets_s[size in EXTRA_SIZES.get(name, ())]
        cpu = (check_wgl_cpu(packed, pm, time_limit_s=budget)
               if dev.valid != "unknown" else None)
        tally.trials += 1
        key = f"{name}/{size}"
        if cpu is None or cpu.valid == "unknown":
            tally.unknown[key] += 1
            continue
        tally.decided[key] += 1
        tally.packed_max[name] = max(tally.packed_max.get(name, 0),
                                     packed.n)
        tally.families[name] += 1
        tally.verdicts[cpu.valid] += 1
        if cpu.valid is not dev.valid:
            tally.mismatches.append({
                "kind": "fuzz", "family": name, "size": size,
                "corrupt": corrupt, "family_seed": seed,
                "cpu": cpu.valid, "dev": dev.valid})
            print(f"MISMATCH: {tally.mismatches[-1]}", flush=True)
    return tally


# -- the round-5 part ------------------------------------------------------


def round5_batch(rng: random.Random, seed0: int, batch: int,
                 device: str = "cuda", deadline: float = None) -> dict:
    """One keyed batch (tools/soak_round5.py's): the stream witness's
    True verdicts against the exact engine, and the witness's three
    transfer modes on three sampled keys.  Returns its counts and
    mismatches; `bad_convicted` counts the planted violations the exact
    engine convicted."""
    from jepsen_tpu_torch.checker.wgl_cpu import check_wgl_cpu
    from jepsen_tpu_torch.history.packed import pack_history
    from jepsen_tpu_torch.models import register
    from jepsen_tpu_torch.ops.wgl_stream import check_wgl_witness_stream
    from jepsen_tpu_torch.ops.wgl_witness import check_wgl_witness

    use_cas = rng.random() < 0.7
    pm = (cas_register() if use_cas else register()).packed()
    n_keys = rng.choice([3, 8, 20])
    out = {"keys": 0, "stream_true": 0, "stream_none": 0,
           "bad_planted": 0, "bad_convicted": 0, "modes_checked": 0,
           "mismatches": []}
    packs, cpu_verdicts = [], []
    for i in range(n_keys):
        if deadline is not None and time.monotonic() > deadline:
            break
        n = rng.choice([60, 120])
        info = rng.choice([0.0, 0.05, 0.2])
        procs = rng.choice([4, 8])
        bad = rng.random() < 0.15
        out["bad_planted"] += bad
        seed = seed0 * 1_000_003 + batch * 1009 + i
        h = random_register_history(n, procs=procs, info_rate=info,
                                    seed=seed, cas=use_cas, bad=bad)
        p = pack_history(h, pm.encode)
        packs.append(p)
        cpu = check_wgl_cpu(p, pm, max_configs=5_000_000)
        cpu_verdicts.append(cpu.valid)
        out["bad_convicted"] += bad and cpu.valid is False
        if bad and cpu.valid is True:
            # The exact engine stopped convicting planted violations:
            # the whole differential would go vacuous.
            out["mismatches"].append({"kind": "reference-miss",
                                      "batch": batch, "key": i,
                                      "seed": seed})
    if not packs:
        return out

    sv = check_wgl_witness_stream(packs, pm, device=device)
    for i, (s, c) in enumerate(zip(sv, cpu_verdicts)):
        out["keys"] += 1
        if s is True:
            out["stream_true"] += 1
            if c is False:
                out["mismatches"].append({"kind": "stream-unsound",
                                          "batch": batch, "key": i})
        else:
            out["stream_none"] += 1

    for i in rng.sample(range(len(packs)), min(3, len(packs))):
        seen = {}
        for mode in ("full", "indices", "device"):
            info: dict = {}
            r = check_wgl_witness(packs[i], pm, transfer=mode,
                                  out_info=info, device=device)
            seen[mode] = (None if r is None else r.valid,
                          info.get("died_at_rank"))
        out["modes_checked"] += 1
        if len(set(seen.values())) != 1:
            out["mismatches"].append({"kind": "transfer-divergence",
                                      "batch": batch, "key": i,
                                      "seen": seen})
        if seen["full"][0] is True and cpu_verdicts[i] is False:
            out["mismatches"].append({"kind": "witness-unsound",
                                      "batch": batch, "key": i})
    for m in out["mismatches"]:
        print(f"MISMATCH: {m}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--minutes", type=float, default=5.0)
    ap.add_argument("--seed-base", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from jepsen_tpu_torch import device as _device

    dev = str(_device.resolve(args.device))
    deadline = time.monotonic() + args.minutes * 60.0
    tally = Tally()
    r5 = Counter()
    r5_mismatches: list = []
    rng5 = random.Random(args.seed_base)
    round_i = 0
    while (time.monotonic() < deadline and not tally.mismatches
           and not r5_mismatches):
        round_i += 1
        run_trials(fuzz_schedule(args.seed_base, round_i), dev, deadline,
                   tally)
        if time.monotonic() >= deadline or tally.mismatches:
            break
        b = round5_batch(rng5, args.seed_base, round_i, dev, deadline)
        r5_mismatches += b.pop("mismatches")
        r5.update(b)
        print(json.dumps({"round": round_i, "trials": tally.trials,
                          "decided": sum(tally.decided.values()),
                          "unknown": sum(tally.unknown.values()),
                          "round5": dict(r5)}), flush=True)
    doc = {"soak": "done", "device": dev, "rounds": round_i,
           **tally.summary(), "round5": dict(r5),
           "round5_mismatches": len(r5_mismatches),
           "minutes": args.minutes}
    print(json.dumps(doc))
    if tally.mismatches or r5_mismatches:
        return 1
    return 0 if tally.trials + r5["keys"] else 2


if __name__ == "__main__":
    raise SystemExit(main())
