"""Verdict parity on the plan route, the port's default.

With `JEPSEN_PLAN` on (unset: the default) the port's `Linearizable`
and `IndependentChecker` compile and execute plans.  On the CPU
corpora their per-key `valid`, `algorithm` and `failure-count` equal
the JAX package's plan route (with `JEPSEN_WGL_PACKED=0` and at the
default, packed lanes), and their whole results and "tiers" equal the
port's own `JEPSEN_PLAN=0` runs, which execute the same plan without
the cost model and the persistent memo (the port keeps no hand-wired
ladder).  Also: the persistent memo on both packages (the reference's
resubmission test, and a journal replay standing for a restarted
process), the online session's knobs against the reference's for the
same feed, and that a device fault raised in any plan pass, and a
failure of the plan layer itself, propagate.  One model pair per kind
for the file: the JAX side compiles per model."""

import pytest
import torch

import jepsen_tpu.history.core as ref_hc
import jepsen_tpu.models as ref_models
import jepsen_tpu.parallel.independent as ref_ind
import jepsen_tpu.plan.cache as ref_cache
import jepsen_tpu.plan.costmodel as ref_costmodel
import jepsen_tpu.telemetry as ref_telemetry
from jepsen_tpu.checker.linearizable import Linearizable as RefLinearizable
from jepsen_tpu.history.core import Op as RefOp
from jepsen_tpu.utils.histgen import random_register_history as ref_gen
from jepsen_tpu_torch import models, telemetry
from jepsen_tpu_torch.checker import Linearizable
from jepsen_tpu_torch.history.core import History, Op, history
from jepsen_tpu_torch.models.registers import CASRegister, Register
from jepsen_tpu_torch.ops import kernels, wgl_batched, wgl_witness
from jepsen_tpu_torch.parallel import (KV, IndependentChecker,
                                       clear_settle_memo, kv)
from jepsen_tpu_torch.plan import cache as plan_cache
from jepsen_tpu_torch.plan import compiler, costmodel
from jepsen_tpu_torch.utils.histgen import random_register_history

from chip_smoke import keyed_history, mutex_ops, queue_ops


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU work in these tests runs on one torch thread: the
    suite runs several test processes at once, and the checkers' worker
    threads, each with torch's parallel regions, would oversubscribe
    the cores and stall the other processes' budgeted tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, params=["0", None], ids=["wide", "packed"])
def _plan_route(request, monkeypatch):
    """Both packages on the plan route, with wide member bitsets
    (JEPSEN_WGL_PACKED=0) and then at the default, packed lanes; no
    cache directory, empty memos, telemetry counting."""
    monkeypatch.delenv("JEPSEN_PLAN", raising=False)
    monkeypatch.delenv("JEPSEN_PLAN_CACHE", raising=False)
    if request.param is None:
        monkeypatch.delenv("JEPSEN_WGL_PACKED", raising=False)
    else:
        monkeypatch.setenv("JEPSEN_WGL_PACKED", request.param)
    prior = telemetry.enabled(), ref_telemetry.enabled()
    for t in (telemetry, ref_telemetry):
        t.enable(True)
        t.reset()
    for c in (plan_cache, ref_cache):
        c.reset_for_tests()
    for m in (costmodel, ref_costmodel):
        m.set_model_path(None)
    clear_settle_memo()
    ref_ind.clear_settle_memo()
    yield
    for c in (plan_cache, ref_cache):
        c.reset_for_tests()
    for m in (costmodel, ref_costmodel):
        m.set_model_path(None)
    telemetry.enable(prior[0])
    ref_telemetry.enable(prior[1])


def _ran_the_plan():
    assert telemetry.counter_value("wgl.plan.execute") >= 1


def _same(a: dict, b: dict) -> bool:
    """Results equal but for their wall times."""
    def strip(r):
        return {k: v for k, v in r.items() if k != "elapsed-s"}
    return strip(a) == strip(b)


# ---------------------------------------------------------------------
# Linearizable: the corpora of tests/test_torch_linearizable.py

BFS_INVALID = [
    dict(type="invoke", f="write", value=1, process=0),
    dict(type="invoke", f="write", value=2, process=1),
    dict(type="ok", f="write", value=1, process=0),
    dict(type="ok", f="write", value=2, process=1),
    dict(type="invoke", f="read", value=None, process=2),
    dict(type="ok", f="read", value=1, process=2),
    dict(type="invoke", f="read", value=None, process=2),
    dict(type="ok", f="read", value=2, process=2),
]


def _gen(n, info, procs, seed, bad=False):
    kw = dict(procs=procs, info_rate=info, seed=seed, bad=bad)
    return ref_gen(n, **kw), random_register_history(n, **kw)


HISTORIES = {
    "valid": lambda: _gen(200, 0.1, 6, 31),
    "valid-cas": lambda: _gen(200, 0.0, 4, 32),
    "invalid-end": lambda: _gen(96, 0.05, 4, 13, bad=True),
    "bfs-invalid": lambda: (
        ref_hc.history([RefOp(**o) for o in BFS_INVALID]),
        history([Op(**o) for o in BFS_INVALID])),
}

_MODELS: dict = {}


def _models(name, mk, ref_mk):
    if name not in _MODELS:
        _MODELS[name] = (mk(), ref_mk())
    return _MODELS[name]


@pytest.mark.parametrize("name", sorted(HISTORIES))
@pytest.mark.parametrize("algorithm", ["wgl-tpu", "competition"])
def test_linearizable_plan_route(name, algorithm, monkeypatch):
    ref_h, h = HISTORIES[name]()
    m, ref_m = _models("cas", models.cas_register, ref_models.cas_register)
    want = RefLinearizable(ref_m, algorithm).check({}, ref_h, {})
    got = Linearizable(m, algorithm, device="cpu").check({}, h, {})
    assert (got["valid"], got["algorithm"]) == (want["valid"],
                                                want["algorithm"])
    _ran_the_plan()
    monkeypatch.setenv("JEPSEN_PLAN", "0")
    executed = telemetry.counter_value("wgl.plan.execute")
    plain = Linearizable(m, algorithm, device="cpu").check({}, h, {})
    assert telemetry.counter_value("wgl.plan.execute") == executed + 1
    assert _same(got, plain)


# ---------------------------------------------------------------------
# IndependentChecker

def _cas_ops(n_keys, n_ops, bad_keys, gen, kvf):
    """bench.py run_mixed's history shape (chip_smoke.mixed_history) at
    `n_ops` ops per key, for either package."""
    ops = []
    for i in range(n_keys):
        for o in gen(n_ops, procs=4, info_rate=0.05, seed=i,
                     bad=i in bad_keys):
            ops.append(o.replace(value=kvf(f"k{i}", o.value)))
    return ops


def _cohort_parity(m, ref_m, h, ref_h, monkeypatch, **kw):
    """The port against the reference's plan route, and against its own
    `JEPSEN_PLAN=0` run; returns the port's default-route result."""
    want = ref_ind.IndependentChecker(RefLinearizable(ref_m, **kw)).check(
        {}, ref_h, {})
    got = IndependentChecker(Linearizable(m, device="cpu", **kw),
                             device="cpu").check({}, h, {})
    assert got["valid"] == want["valid"]
    assert got["failure-count"] == want["failure-count"]
    assert sorted(got["failures"]) == sorted(want["failures"])
    for k, w in want["results"].items():
        g = got["results"][k]
        assert (g["valid"], g["algorithm"]) == (w["valid"], w["algorithm"]), k
    _ran_the_plan()
    monkeypatch.setenv("JEPSEN_PLAN", "0")
    clear_settle_memo()
    plain = IndependentChecker(Linearizable(m, device="cpu", **kw),
                               device="cpu").check({}, h, {})
    monkeypatch.delenv("JEPSEN_PLAN")
    assert got["tiers"] == plain["tiers"]
    assert got.keys() == plain.keys()
    for k, r in plain["results"].items():
        assert _same(got["results"][k], r), k
    return got


def test_mixed_cas_history_plan_route(monkeypatch):
    bad = {3, 11, 17, 24, 30, 38}
    h = history(_cas_ops(40, 60, bad, random_register_history, kv))
    ref_h = ref_hc.history(_cas_ops(40, 60, bad, ref_gen, ref_ind.kv))
    m, ref_m = _models("cas", models.cas_register, ref_models.cas_register)
    got = _cohort_parity(m, ref_m, h, ref_h, monkeypatch,
                         time_limit_s=600.0)
    assert got["failure-count"] == 6
    assert got["tiers"]["stream-proven"] == 34


@pytest.mark.parametrize("name", ["mutex", "unordered-queue"])
def test_other_models_plan_route(name, monkeypatch):
    mk, ref_mk, gen, long_ops = {
        "mutex": (models.mutex, ref_models.mutex, mutex_ops, 6000),
        "unordered-queue": (models.unordered_queue,
                            ref_models.unordered_queue, queue_ops, 0),
    }[name]
    bad = set(range(0, 14, 5))
    h = keyed_history(gen, 14, 30, bad, Op=Op, kv=kv, history=history,
                      long_key_ops=long_ops)
    ref_h = keyed_history(gen, 14, 30, bad, Op=ref_hc.Op, kv=ref_ind.kv,
                          history=ref_hc.history, long_key_ops=long_ops)
    m, ref_m = _models(name, mk, ref_mk)
    got = _cohort_parity(m, ref_m, h, ref_h, monkeypatch,
                         time_limit_s=120.0)
    assert got["failure-count"] == len(bad)
    if long_ops:
        assert got["tiers"]["long"] == 1


# ---------------------------------------------------------------------
# The persistent memo


def _resubmission_history(read_back=2):
    ops = []

    def add(f, key, value):
        i = len(ops)
        ops.append({"index": i, "type": "invoke", "process": 0, "f": f,
                    "value": KV(key, None if f == "read" else value),
                    "time": i})
        ops.append({"index": i + 1, "type": "ok", "process": 0, "f": f,
                    "value": KV(key, value), "time": i + 1})

    add("write", "k", 2)
    add("read", "k", read_back)
    return History([Op(**o) for o in ops])


def test_checker_hits_memo_only_on_identical_resubmission(
        tmp_path, monkeypatch):
    """tests/test_plan.py's case, against the port."""
    monkeypatch.setenv("JEPSEN_PLAN_CACHE", str(tmp_path))

    def run(lin):
        clear_settle_memo()
        return IndependentChecker(lin, device="cpu").check(
            {"name": "t"}, _resubmission_history(), {"history-key": None})

    r1 = run(Linearizable(Register(), device="cpu"))
    assert r1["valid"] is True
    memo = plan_cache.active_memo()
    assert memo.stats()["puts"] >= 1

    hits0 = memo.stats()["hits"]
    r2 = run(Linearizable(Register(), device="cpu"))  # identical: HIT
    assert r2["valid"] is True
    assert memo.stats()["hits"] > hits0

    hits1 = memo.stats()["hits"]
    r3 = run(Linearizable(Register(), time_limit_s=7.5, device="cpu"))
    assert r3["valid"] is True  # budget change: MISS
    assert memo.stats()["hits"] == hits1

    r4 = run(Linearizable(CASRegister(), device="cpu"))  # model: MISS
    assert r4["valid"] is True
    assert memo.stats()["hits"] == hits1


def test_single_history_replays_from_the_journal(tmp_path, monkeypatch):
    """chip_smoke.py phase 9c on the CPU: the second check is a memo
    hit with no sweep, a fresh process state replays the journal, a new
    budget misses."""
    monkeypatch.setenv("JEPSEN_PLAN_CACHE", str(tmp_path))
    h = random_register_history(300, procs=4, info_rate=0.05, seed=9)
    sweeps = []
    real = wgl_witness.sweep_plain

    def counting(*a, **k):
        sweeps.append(1)
        return real(*a, **k)

    monkeypatch.setattr(wgl_witness, "sweep_plain", counting)

    def check(**kw):
        sweeps.clear()
        out = Linearizable(models.cas_register(), device="cpu",
                           **kw).check({}, h, {})
        return out, len(sweeps)

    first, n1 = check()
    assert first["valid"] is True and not first.get("memo-hit") and n1 > 0
    second, n2 = check()
    assert second.get("memo-hit") is True and n2 == 0
    assert second["algorithm"] == first["algorithm"]
    plan_cache.reset_for_tests()  # a restarted process
    third, n3 = check()
    assert third.get("memo-hit") is True and n3 == 0
    assert plan_cache.active_memo().loaded == 1
    fourth, n4 = check(time_limit_s=300.0)
    assert not fourth.get("memo-hit") and n4 > 0
    _ran_the_plan()


# ---------------------------------------------------------------------
# The online session's knobs


def _record_stream_calls(monkeypatch, module, calls):
    real = module.check_wgl_witness_stream

    def recording(packs, pm, **kw):
        calls.append((len(packs), kw.get("segment_keys"),
                      kw.get("max_restarts")))
        return real(packs, pm, **kw)

    monkeypatch.setattr(module, "check_wgl_witness_stream", recording)


def _session_feed(n_keys):
    """A keyed feed whose last few ops leave keys in flight at finish,
    so the finalize runs a second stream batch."""
    def ops(gen, kvf, OpT):
        out = []
        for i in range(n_keys):
            for o in gen(24, procs=2, info_rate=0.0, cas=False,
                         seed=50 + i, bad=i == 3):
                out.append(o.replace(value=kvf(f"k{i}", o.value),
                                     process=i * 4 + o.process))
        return out
    return ops


@pytest.mark.parametrize("trained", [False, True])
def test_online_session_knobs_equal_the_reference(trained, tmp_path,
                                                  monkeypatch):
    import jepsen_tpu.ops.wgl_stream as ref_stream
    from jepsen_tpu.streaming.pipeline import StreamingSession as RefSession
    from jepsen_tpu_torch.ops import wgl_stream
    from jepsen_tpu_torch.streaming import StreamingSession

    if trained:
        # A stream model whose support covers the feed's shapes, loaded
        # in both packages.
        rows = [{"pass": "stream",
                 "features": {"keys": k, "ops": 24 * k},
                 "plan": {"segment": s, "max_restarts": 8},
                 "timing": {"execute_s": 0.01 * s + 0.001 * k}}
                for k in (1, 4, 12) for s in (2, 4, 8)]
        path = str(tmp_path / "model.json")
        costmodel.fit(rows).save(path)
        costmodel.set_model_path(path)
        ref_costmodel.set_model_path(path)
    calls, ref_calls = [], []
    _record_stream_calls(monkeypatch, wgl_stream, calls)
    _record_stream_calls(monkeypatch, ref_stream, ref_calls)
    feed = _session_feed(12)
    ops = feed(random_register_history, kv, Op)
    ref_ops = feed(ref_gen, ref_ind.kv, RefOp)
    pm = models.register().packed()
    ref_pm = ref_models.register().packed()
    sess = StreamingSession(pm, swap_ops=1 << 30, swap_interval_s=3600.0,
                            device="cpu")
    ref = RefSession(ref_pm, swap_ops=1 << 30, swap_interval_s=3600.0)
    for op in ops[:-6]:
        sess.feed(op)
    for op in ref_ops[:-6]:
        ref.feed(op)
    # Hold the last ops back until the thread took the first batch: the
    # finalize then runs the held keys in a batch of its own.
    sess._wake.set()
    ref._wake.set()
    import time as _time

    deadline = _time.monotonic() + 30
    while (not calls or not ref_calls) and _time.monotonic() < deadline:
        _time.sleep(0.02)
    for op in ops[-6:]:
        sess.feed(op)
    for op in ref_ops[-6:]:
        ref.feed(op)
    stats, ref_stats = sess.finish(), ref.finish()
    assert calls and calls == ref_calls
    assert stats["proven-online"] == ref_stats["proven-online"]
    if not trained:
        for n, seg, mr in calls:
            assert (seg, mr) == (max(8, -(-n // 8)), max(8, n // 2))


# ---------------------------------------------------------------------
# Faults


def _small_keyed(n_keys=6, n_ops=40, bad=(2,), long_key=False):
    ops = _cas_ops(n_keys, n_ops, set(bad), random_register_history, kv)
    if long_key:
        ops += [o.replace(value=kv("long", o.value)) for o in
                random_register_history(2100, procs=3, info_rate=0.0,
                                        seed=77)]
    return history(ops)


def _launch_error(*a, **k):
    raise kernels.KernelLaunchError("launch failed: injected")


@pytest.mark.parametrize("target", [
    "stream-witness", "batched-bfs", "refute-screen", "single-device",
    "settle-exact"])
def test_device_fault_propagates_through_every_plan_pass(target,
                                                         monkeypatch):
    import importlib

    import jepsen_tpu_torch.checker.refute as refute_mod

    lin_mod = importlib.import_module("jepsen_tpu_torch.checker.linearizable")

    h = _small_keyed(long_key=target == "single-device")
    if target in ("stream-witness", "single-device"):
        monkeypatch.setattr(wgl_witness, "sweep", _launch_error)
    elif target == "batched-bfs":
        # A key no screen refutes reaches the batched BFS: the stream
        # is patched to prove nothing.
        import jepsen_tpu_torch.ops.wgl_stream as ws

        monkeypatch.setattr(ws, "check_wgl_witness_stream",
                            lambda packs, pm, **kw: [None] * len(packs))
        monkeypatch.setattr(wgl_batched, "_search", _launch_error)
    elif target == "refute-screen":
        monkeypatch.setattr(refute_mod, "check_refute", _launch_error)
    else:
        monkeypatch.setattr(lin_mod, "check_refute", _launch_error)
    with pytest.raises(kernels.KernelLaunchError):
        IndependentChecker(Linearizable(models.cas_register(), device="cpu"),
                           device="cpu").check({}, h, {})


@pytest.mark.parametrize("checker", ["linearizable", "independent"])
def test_plan_layer_failure_raises(checker, monkeypatch):
    """The plan is the port's only route: a bug in the plan layer fails
    the check (the reference falls back to its hand-wired ladder)."""
    def broken(*a, **k):
        raise ValueError("plan executor bug")

    monkeypatch.setattr(compiler, "execute", broken)
    lin = Linearizable(models.cas_register(), device="cpu")
    if checker == "linearizable":
        chk, h = lin, HISTORIES["valid"]()[1]
    else:
        chk, h = IndependentChecker(lin, device="cpu"), _small_keyed()
    with pytest.raises(ValueError, match="plan executor bug"):
        chk.check({}, h, {})


def test_stream_search_error_falls_through_to_the_batched_bfs(monkeypatch):
    """The reference's behaviour for a failure of the stream that is
    neither a device fault nor a resource error: every key goes on to
    the screens and the batched BFS, and the verdicts stand."""
    import jepsen_tpu_torch.ops.wgl_stream as ws

    def buggy(*a, **k):
        raise IndexError("stream bug")

    monkeypatch.setattr(ws, "check_wgl_witness_stream", buggy)
    got = IndependentChecker(Linearizable(models.cas_register(),
                                          device="cpu"),
                             device="cpu").check({}, _small_keyed(), {})
    assert got["valid"] is False and got["failures"] == ["k2"]
    assert got["tiers"]["stream-proven"] == 0
    assert got["tiers"]["batched-proven"] == 5
    _ran_the_plan()


def test_device_ladder_fault_propagates_from_the_single_plan(monkeypatch):
    _, h = HISTORIES["valid"]()
    monkeypatch.setattr(wgl_witness, "sweep", _launch_error)
    with pytest.raises(kernels.KernelLaunchError):
        Linearizable(models.cas_register(), device="cpu").check({}, h, {})
    assert telemetry.counter_value("wgl.plan.execute") == 1
