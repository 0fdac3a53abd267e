"""`correct` on small cells with the port on the CPU: true for sound
runs, false for the control and for each fault of the timed path that
the cells can have.  Each fault is planted in the port underneath the
harness, which runs as the benchmark does but for its look for a
card."""

import copy
import io

from perfbench import run
from perfbench.controls import Control


def go(cell, entry=None):
    return run.run(cell, entry or run.host_entry(cell), 2**31 + 77, 0.5,
                   log=io.StringIO())


def test_sound_runs_are_correct(register_cell, keyed_cell):
    for cell in (register_cell, keyed_cell):
        out = go(cell)
        assert out["correct"] is True, out["compared"]
        assert out["attempted"] >= 2 and out["failed"] == 0
        assert all(c["value"] == 0 for c in out["compared"].values())


def test_the_control_is_not_correct(small, keyed_cell):
    """The reference with :info ops taken as :fail: the single key at
    20,000 ops (where some :info op's effect is observed) and the keyed
    cell both read mismatches."""
    single = small("register-100k", 20_000, pool=1)
    out = go(single, Control(single.config))
    assert out["correct"] is False
    assert out["compared"]["verdict_mismatches"]["value"] >= 1
    out = go(keyed_cell, Control(keyed_cell.config))
    assert out["correct"] is False
    assert out["compared"]["key_mismatches"]["value"] >= 1


def _wrap(monkeypatch, cls, after):
    real = cls.check

    def check(self, test, history, opts):
        return after(real(self, test, history, opts))

    monkeypatch.setattr(cls, "check", check)


def test_an_answer_altered_where_it_is_produced(monkeypatch, register_cell,
                                                keyed_cell):
    from jepsen_tpu_torch.checker.linearizable import Linearizable
    from jepsen_tpu_torch.parallel.independent import IndependentChecker

    def flip(res):
        return {**res, "valid": not res["valid"]}

    with monkeypatch.context() as m:
        _wrap(m, Linearizable, flip)
        out = go(register_cell)
    assert out["correct"] is False
    assert out["compared"]["verdict_mismatches"]["value"] >= 2

    def flip_one_key(res):
        res = copy.deepcopy(res)
        k = next(k for k, r in res["results"].items() if r["valid"])
        res["results"][k]["valid"] = False
        return res

    _wrap(monkeypatch, IndependentChecker, flip_one_key)
    out = go(keyed_cell)
    assert out["correct"] is False
    assert out["compared"]["key_mismatches"]["value"] >= 2
    assert out["compared"]["verdict_mismatches"]["value"] == 0


def test_half_of_the_keys_left_out(monkeypatch, keyed_cell):
    from jepsen_tpu_torch.parallel import independent

    real = independent.subhistories

    def half(h):
        subs = real(h)
        return {k: v for i, (k, v) in enumerate(subs.items()) if i % 2}

    monkeypatch.setattr(independent, "subhistories", half)
    out = go(keyed_cell)
    assert out["correct"] is False
    assert out["compared"]["key_mismatches"]["value"] >= 20
    assert out["compared"]["failure_count_gap"]["value"] >= 2


def test_a_check_served_from_an_earlier_checks_state(monkeypatch,
                                                     keyed_cell):
    """Every check answered with the first check's result: its keys are
    another history's."""
    from jepsen_tpu_torch.parallel.independent import IndependentChecker

    kept = []

    def stale(res):
        kept.append(res)
        return kept[0]

    _wrap(monkeypatch, IndependentChecker, stale)
    out = go(keyed_cell)
    assert out["correct"] is False
    assert out["compared"]["key_mismatches"]["value"] >= 20


def test_a_check_that_raises_has_no_verdict(monkeypatch, register_cell):
    from jepsen_tpu_torch.checker.linearizable import Linearizable

    def boom(self, test, history, opts):
        raise RuntimeError("planted")

    monkeypatch.setattr(Linearizable, "check", boom)
    out = go(register_cell)
    assert out["correct"] is False
    assert out["failed"] == out["attempted"]
    assert out["compared"]["no_verdict"]["value"] == out["attempted"]
