"""The reference decider against histories with known verdicts, the
generator's planted keys, and the port's exact CPU engine."""

import random

import pytest

from perfbench import generate, reference
from perfbench.controls import as_failed


def h(*rows):
    """Records from (process, type, f, value) rows of one key."""
    return [(None, p, t, f, v) for p, t, f, v in rows]


CASES = {
    "empty": (h(), True),
    "sequential": (h((0, "invoke", "write", 1), (0, "ok", "write", 1),
                     (0, "invoke", "read", None), (0, "ok", "read", 1)),
                   True),
    "stale read": (h((0, "invoke", "write", 1), (0, "ok", "write", 1),
                     (0, "invoke", "write", 2), (0, "ok", "write", 2),
                     (1, "invoke", "read", None), (1, "ok", "read", 1)),
                   False),
    "never written": (h((0, "invoke", "write", 1), (0, "ok", "write", 1),
                        (1, "invoke", "read", None), (1, "ok", "read", 99)),
                      False),
    "concurrent read sees the write": (
        h((0, "invoke", "write", 3), (1, "invoke", "read", None),
          (1, "ok", "read", 3), (0, "ok", "write", 3)), True),
    "read of nil is unconstrained": (
        h((0, "invoke", "write", 1), (0, "ok", "write", 1),
          (1, "invoke", "read", None), (1, "ok", "read", None)), True),
    "info write may have happened": (
        h((0, "invoke", "write", 4), (0, "info", "write", 4),
          (1, "invoke", "read", None), (1, "ok", "read", 4)), True),
    "info write never took effect": (
        h((0, "invoke", "write", 1), (0, "ok", "write", 1),
          (1, "invoke", "write", 4), (1, "info", "write", 4),
          (0, "invoke", "read", None), (0, "ok", "read", 1)), True),
    "info write cannot act before it is invoked": (
        h((0, "invoke", "read", None), (0, "ok", "read", 4),
          (1, "invoke", "write", 4), (1, "info", "write", 4)), False),
    "one info write serves one read": (
        h((0, "invoke", "write", 4), (0, "info", "write", 4),
          (1, "invoke", "read", None), (1, "ok", "read", 4),
          (1, "invoke", "write", 2), (1, "ok", "write", 2),
          (1, "invoke", "read", None), (1, "ok", "read", 4)), False),
    "info cas chain": (
        h((0, "invoke", "write", 1), (0, "ok", "write", 1),
          (1, "invoke", "cas", (1, 2)), (1, "info", "cas", (1, 2)),
          (2, "invoke", "cas", (2, 3)), (2, "info", "cas", (2, 3)),
          (0, "invoke", "read", None), (0, "ok", "read", 3)), True),
    "failed cas never happened": (
        h((0, "invoke", "write", 1), (0, "ok", "write", 1),
          (1, "invoke", "cas", (1, 2)), (1, "fail", "cas", (1, 2)),
          (0, "invoke", "read", None), (0, "ok", "read", 2)), False),
    "cas from nil fails": (
        h((0, "invoke", "cas", (0, 1)), (0, "ok", "cas", (0, 1))), False),
    "unfinished op is indeterminate": (
        h((0, "invoke", "write", 2), (1, "invoke", "read", None),
          (1, "ok", "read", 2)), True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_known_verdicts(name):
    records, want = CASES[name]
    assert reference.decide(records) is want


def test_planted_keys_are_the_only_invalid_ones():
    config = {"keyed": True, "history": {"ops_per_key": 100,
              "procs_per_key": 4, "info_rate": 0.05, "values": 5}}
    traffic = {"keys": 40, "bad_keys": 7}
    records = generate.history_records(config, traffic, 123, 2)
    got = reference.decide_keys(records)
    assert list(got) == [2 * 40 + k for k in range(40)]
    assert [k for k, v in got.items() if not v] == list(range(80, 87))


def test_deadline_raises_undecided():
    records = generate.register_records(20_000, procs=8, info_rate=0.05,
                                        n_values=5, seed=3)
    with pytest.raises(reference.Undecided):
        reference.decide(records, deadline=0.0)


def test_control_fails_where_info_ops_matter():
    """A 20k-op history needs some :info op's effect: the control, which
    takes them as :fail, refutes it."""
    records = generate.register_records(20_000, procs=16, info_rate=0.05,
                                        n_values=5, seed=45100)
    assert reference.decide(records) is True
    assert reference.decide(as_failed(records)) is False


def _random_history(rng):
    """A small history of arbitrary ops, completions and read values."""
    procs, nv, n = rng.randrange(1, 5), rng.choice([2, 3]), rng.randrange(2, 16)
    pend, recs, started = {}, [], 0
    while started < n or pend:
        p = rng.randrange(procs)
        if p in pend:
            f, v = pend.pop(p)
            t = rng.choices(["ok", "info", "fail"], [6, 1, 1])[0]
            if f == "read":
                v = (rng.choice([None] + list(range(nv))) if t == "ok"
                     else None)
            recs.append((None, p, t, f, v))
        elif started < n:
            f = rng.choice(["read", "write", "cas"])
            v = (None if f == "read" else rng.randrange(nv) if f == "write"
                 else (rng.randrange(nv), rng.randrange(nv)))
            pend[p] = (f, v)
            recs.append((None, p, "invoke", f, v))
            started += 1
    return recs


def test_agrees_with_the_ports_exact_engine():
    """The port's exact CPU engine (knossos's WGL search) is an
    independent witness; on 400 small histories, valid and not, the
    two agree."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.history.core import History, Op
    from jepsen_tpu_torch.models import cas_register

    rng = random.Random(11)
    seen = set()
    for _ in range(400):
        recs = _random_history(rng)
        want = Linearizable(cas_register(), "cpu", device="cpu").check(
            {}, History([Op(type=t, f=f, value=v, process=p)
                         for _, p, t, f, v in recs]), {})["valid"]
        assert reference.decide(recs) is want, recs
        seen.add(want)
    assert seen == {True, False}
