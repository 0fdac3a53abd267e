"""tools/port_soak.py, the port's differential soak, on the CPU.

Its copies of tests/test_fuzz_parity.py's generators give, seed for
seed, the reference's histories; a few histories of each family at
the CI's smallest size go through the port's device checker and its
exact engine with no mismatch; one round-5 batch holds the stream
witness and the three transfer modes to each other and to the exact
engine; and a planted disagreement is caught, reported and fails the
run.  The jax-blocked import guard in test_torch_linearizable.py
loads the soak too."""

import json
import os
import random
import sys

import pytest
import torch

import test_fuzz_parity as R

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)

import port_soak as S  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """The soak runs the CPU device search under a budget: one torch
    thread, as the other such files do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_configs_are_the_references():
    assert [(c[0], c[3]) for c in S.CONFIGS] == \
        [(c[0], c[3]) for c in R.CONFIGS]
    assert set(S.EXTRA_SIZES) == {c[0] for c in S.CONFIGS}


@pytest.mark.parametrize("size", [60, 300])
@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("name", [c[0] for c in R.CONFIGS])
def test_generators_equal_the_references(name, corrupt, size):
    """Three draws in a row from one seeded rng per side: the same ops,
    history for history, and the rngs left in the same state."""
    ref_fn = next(c[2] for c in R.CONFIGS if c[0] == name)
    port_fn = next(c[2] for c in S.CONFIGS if c[0] == name)
    seed = S.family_seed(7, 1, name)
    r_rng, p_rng = random.Random(seed), random.Random(seed)
    for _ in range(3):
        want = [o.to_dict() for o in ref_fn(r_rng, size, corrupt)]
        got = [o.to_dict() for o in port_fn(p_rng, size, corrupt)]
        assert got == want
    assert r_rng.random() == p_rng.random()


def test_schedule_goes_size_rank_by_size_rank():
    sched = S.fuzz_schedule(0, 1)
    assert len(sched) == 2 * sum(len(S.sizes_of(c[0])) for c in S.CONFIGS)
    assert sched[:10] == [
        (c[0], 60, corrupt, S.family_seed(0, 1, c[0]))
        for c in S.CONFIGS for corrupt in (False, True)]
    assert [t[:2] for t in sched[-4:]] == [
        ("cas-register", 1500), ("cas-register", 1500),
        ("cas-register", 2600), ("cas-register", 2600)]


def test_smallest_size_soak_has_no_mismatch():
    """Two rounds at the CI's smallest size: four histories a family,
    half corrupt, each decided by both engines."""
    tally = S.Tally()
    for round_i in (1, 2):
        S.run_trials(S.fuzz_schedule(0, round_i)[:10], "cpu",
                     tally=tally)
    s = tally.summary()
    assert s["trials"] == 20 and s["mismatches"] == 0, s
    assert s["decided_true"] >= 3 and s["decided_false"] >= 3, s
    assert all(s["decided_per_family"].get(c[0], 0) >= 2
               for c in S.CONFIGS), s
    assert set(s["packed_max"]) == {c[0] for c in S.CONFIGS}
    assert all(0 < n <= 60 for n in s["packed_max"].values()), s


def test_round5_batch_agrees():
    out = S.round5_batch(random.Random(3), 3, 1, "cpu")
    assert out["mismatches"] == [], out["mismatches"]
    assert out["keys"] >= 3 and out["modes_checked"] == 3, out
    assert out["stream_true"] + out["stream_none"] == out["keys"]


def test_a_disagreement_is_a_mismatch(monkeypatch, capsys):
    """A device checker that flips its decided verdicts is caught, and
    the run exits 1."""
    import jepsen_tpu_torch.ops.wgl as wgl

    real = wgl.check_wgl_device

    def flipped(*a, **k):
        res = real(*a, **k)
        if res.valid in (True, False):
            res.valid = not res.valid
        return res

    monkeypatch.setattr(wgl, "check_wgl_device", flipped)
    tally = S.run_trials(S.fuzz_schedule(0, 1)[:2], "cpu")
    assert tally.mismatches and tally.mismatches[0]["kind"] == "fuzz"
    assert "MISMATCH" in capsys.readouterr().out
    assert S.main(["--minutes", "0.005", "--device", "cpu"]) == 1


def test_main_ends_with_one_json_line(capsys):
    assert S.main(["--minutes", "0.005", "--device", "cpu"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["soak"] == "done" and doc["device"] == "cpu"
    assert doc["trials"] >= 1 and doc["mismatches"] == 0


def test_extra_sizes_get_the_references_budget(monkeypatch):
    """fuzz_soak's rule: the exact engine gets 60 s a history at a
    family's extra sizes, 20 s at its CI sizes; the device 60 s."""
    import jepsen_tpu_torch.checker.wgl_cpu as wgl_cpu
    import jepsen_tpu_torch.ops.wgl as wgl

    seen = []

    class Decided:
        valid = True

    def record(side):
        def check(packed, pm, time_limit_s=None, **k):
            seen.append((side, packed.n, time_limit_s))
            return Decided()
        return check

    monkeypatch.setattr(wgl, "check_wgl_device", record("dev"))
    monkeypatch.setattr(wgl_cpu, "check_wgl_cpu", record("cpu"))
    sched = [t for t in S.fuzz_schedule(0, 1) if t[0] == "mutex"]
    tally = S.run_trials(sched, "cpu")
    assert tally.trials == len(sched) == 2 * len(S.sizes_of("mutex"))
    want = [S.EXTRA_CPU_BUDGET_S if size in S.EXTRA_SIZES["mutex"]
            else S.CPU_BUDGET_S for _, size, _, _ in sched]
    assert [b for side, _, b in seen if side == "cpu"] == want
    assert {b for side, _, b in seen if side == "dev"} == {
        S.DEVICE_BUDGET_S}
    assert tally.packed_max["mutex"] == max(n for _, n, _ in seen)


#: A batch seed whose 8 cas-register keys plant one violation (key 4),
#: among the three keys the transfer modes check.
PLANTED_SEED = 20_002


def test_round5_batch_convicts_its_planted_violation():
    out = S.round5_batch(random.Random(PLANTED_SEED), PLANTED_SEED, 1,
                         "cpu")
    assert out["mismatches"] == [], out["mismatches"]
    assert out["bad_planted"] == out["bad_convicted"] == 1, out
    assert out["stream_none"] >= 1 and out["modes_checked"] == 3, out


def test_a_stream_that_proves_everything_is_unsound(monkeypatch):
    """A stream witness that answers True to every key fails on the
    planted violation."""
    import jepsen_tpu_torch.ops.wgl_stream as wgl_stream

    monkeypatch.setattr(wgl_stream, "check_wgl_witness_stream",
                        lambda packs, pm, **k: [True] * len(packs))
    out = S.round5_batch(random.Random(PLANTED_SEED), PLANTED_SEED, 1,
                         "cpu")
    assert [m["kind"] for m in out["mismatches"]] == ["stream-unsound"]
    assert out["mismatches"][0]["key"] == 4
