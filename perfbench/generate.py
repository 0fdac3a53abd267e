"""The traffic generator: histories of cas-register keys from a seed.

A history is a list of records `(key, process, type, f, value)`:
`type` one of "invoke", "ok", "fail", "info"; `f` one of "read",
"write", "cas"; `value` None for a read's invocation, the value read
on its completion, the value written, or the cas pair `(old, new)`.
`key` is None in a one-key history.  The records are the harness's
own: the entries turn them into the port's `History`, and the
reference decides them as they are.

`register_records` is a frozen copy of the port's
`utils/histgen.random_register_history` (itself the JAX package's,
line for line): the same calls on Python's `random` in the same order,
so one seed gives the same ops (a test holds the two together).  Each
op's effect lands at its completion, so a key's history is
linearizable unless a violation is planted: a read, after every other
op of the key, of a value no op writes (`bench.py run_mixed`'s
planted key).

`pool` makes a cell's histories.  Their shapes come from the mix's
fixed `base_seed`: `traffic["pool"]` distinct histories, each of
`traffic["keys"]` keys run one after another (the shape of
`chip_smoke.mixed_history`), the first `traffic["bad_keys"]` keys of
each with a planted violation, every key with a generator seed of its
own drawn from the base seed.  The run's `--seed` then draws, for every
key, a permutation of its values and one of its processes, and the
order in which the pool's histories are checked.  A relabelled history
is isomorphic to its base: the same verdicts and the same work (the
port's chain rounds, stream passes and restarts are equal, as a test
holds), so two seeds check different ops at the same cost.  Histories
drawn afresh for each seed took 10-15% more or less time to check than
each other on one H100's host, against 1-3% between two runs of one
seed, and no bound could have seen a change of less.
"""

from __future__ import annotations

import random
from typing import Any, Optional

import numpy as np

#: The planted read returns this much past the largest value written.
PLANTED_OFFSET = 94


def register_records(n_ops: int, *, procs: int, info_rate: float,
                     n_values: int, seed: int, bad: bool = False,
                     key: Any = None, f_mix: Optional[list] = None) -> list:
    """One cas-register key's history of `n_ops` invocations over
    `procs` processes: reads, writes and cas chosen uniformly, or with
    the shares `f_mix` = [read, write, cas] (drawn as the port's
    `workloads/linearizable_register.py` draws them), values
    0 .. n_values - 1, writes and cas completing :info at `info_rate`
    (each then applied with probability 1/2); with `bad`, a read of
    n_values + 94 on process 0 after every other op."""
    rng = random.Random(seed)
    value: Optional[int] = None
    out: list = []
    pending: dict = {}
    started = 0

    def complete(p: int) -> None:
        nonlocal value
        f, payload, as_info = pending.pop(p)
        if as_info:
            if f == "write" and rng.random() < 0.5:
                value = payload
            elif f == "cas" and rng.random() < 0.5 and value == payload[0]:
                value = payload[1]
            out.append((key, p, "info", f, payload))
            return
        if f == "read":
            out.append((key, p, "ok", "read", value))
        elif f == "write":
            value = payload
            out.append((key, p, "ok", "write", payload))
        elif value == payload[0]:
            value = payload[1]
            out.append((key, p, "ok", "cas", payload))
        else:
            out.append((key, p, "fail", "cas", payload))

    while started < n_ops or pending:
        p = rng.randrange(procs)
        if p in pending:
            complete(p)
        elif started < n_ops:
            if f_mix is None:
                f = rng.choice(["read", "write", "cas"])
            else:
                r = rng.random()
                f = ("read" if r < f_mix[0] else
                     "write" if r < f_mix[0] + f_mix[1] else "cas")
            if f == "read":
                payload = None
            elif f == "write":
                payload = rng.randrange(n_values)
            else:
                payload = (rng.randrange(n_values), rng.randrange(n_values))
            as_info = f != "read" and rng.random() < info_rate
            pending[p] = (f, payload, as_info)
            out.append((key, p, "invoke", f, payload))
            started += 1
    if bad:
        out.append((key, 0, "invoke", "read", None))
        out.append((key, 0, "ok", "read", n_values + PLANTED_OFFSET))
    return out


def key_seeds(seed: int, index: int, n_keys: int) -> list:
    """Generator seeds of the keys of pool history `index`, drawn from
    `seed` (any non-negative integer)."""
    ss = np.random.SeedSequence([int(seed), int(index)])
    return [int(s) for s in ss.generate_state(n_keys, dtype=np.uint64)]


def history_records(config: dict, traffic: dict, seed: int,
                    index: int) -> list:
    """Pool history `index` of a cell: its keys one after another.  In a
    keyed history key k of history `index` is named index * keys + k,
    so no two histories of a pool share a key name and a verdict of one
    history can never pass for another's."""
    shape = config["history"]
    n_keys = int(traffic["keys"])
    bad = int(traffic["bad_keys"])
    keyed = bool(config["keyed"])
    out: list = []
    for k, s in enumerate(key_seeds(seed, index, n_keys)):
        out += register_records(
            int(shape["ops_per_key"]), procs=int(shape["procs_per_key"]),
            info_rate=float(shape["info_rate"]),
            n_values=int(shape["values"]), seed=s, bad=k < bad,
            key=index * n_keys + k if keyed else None,
            f_mix=shape.get("f_mix"))
    return out


def relabel(records: list, rng: random.Random, values: int,
            procs: int) -> list:
    """`records` with each key's values 0 .. values - 1 and processes
    0 .. procs - 1 permuted, by permutations drawn from `rng` key by
    key; the planted read's value is left as it is."""
    perms: dict = {}
    out = []
    for k, p, t, f, v in records:
        if k not in perms:
            perms[k] = (rng.sample(range(values), values),
                        rng.sample(range(procs), procs))
        pv, pp = perms[k]
        if isinstance(v, tuple):
            v = tuple(pv[x] for x in v)
        elif v is not None and v < values:
            v = pv[v]
        out.append((k, pp[p], t, f, v))
    return out


def pool(config: dict, traffic: dict, seed: int) -> list:
    """The cell's `traffic["pool"]` histories for the run's `seed`, in
    the order the window checks them."""
    shape = config["history"]
    rng = random.Random(seed)
    n = int(traffic["pool"])
    first = rng.randrange(n)
    return [relabel(history_records(config, traffic,
                                    int(traffic["base_seed"]), i),
                    rng, int(shape["values"]), int(shape["procs_per_key"]))
            for i in list(range(first, n)) + list(range(first))]


def client_ops(records: list) -> int:
    """The invocations of a history: the operations its clients ran."""
    return sum(1 for r in records if r[2] == "invoke")
