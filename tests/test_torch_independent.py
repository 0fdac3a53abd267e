"""Port parity for many-key checking (parallel/independent.py): the
port's `IndependentChecker(Linearizable(model))` on the CPU, on its
default route (the compiled plan), against the JAX package's
hand-wired ladder (its plan route turned off, no packed lanes) on the
same keyed histories: the overall verdict, `failure-count`, and per key
the verdict, `algorithm`, configurations explored, memo hit and device
verdict.  Also: splitting, the settle memo, unpackable keys, the
"settle" engine, and that no failure of the card or a kernel is turned
into a verdict."""

import pytest
import torch

import jepsen_tpu.history.core as ref_hc
import jepsen_tpu.models as ref_models
import jepsen_tpu.parallel.independent as ref_ind
from jepsen_tpu.checker.linearizable import Linearizable as RefLinearizable
from jepsen_tpu.utils.histgen import random_register_history as ref_gen
from jepsen_tpu_torch import models
from jepsen_tpu_torch.checker import Linearizable
from jepsen_tpu_torch.checker.core import check_safe, merge_valid
from jepsen_tpu_torch.device import DeviceUnavailable
from jepsen_tpu_torch.history.core import Op, history
from jepsen_tpu_torch.ops import (kernels, wgl_batched, wgl_stream,
                                  wgl_witness)
from jepsen_tpu_torch.parallel import (IndependentChecker, clear_settle_memo,
                                       history_keys, kv, subhistories)
from jepsen_tpu_torch.utils import bounded_pmap
from jepsen_tpu_torch.utils.histgen import random_register_history

from chip_smoke import (keyed_history, multi_register_ops, mutex_ops,
                        queue_ops)

#: Per-key result fields compared with the reference.
FIELDS = ("valid", "algorithm", "configs-explored", "memo-hit",
          "device-verdict")


@pytest.fixture(autouse=True, params=["0", None], ids=["wide", "packed"])
def _routes(request, monkeypatch):
    """The reference on its hand-wired ladder, the port on the route its
    users get (`JEPSEN_PLAN` unset), both with wide member bitsets
    (JEPSEN_WGL_PACKED=0) and then at the default, packed lanes, and
    both settle memos empty.  The reference reads `jepsen_tpu.plan.enabled`
    at each check, so patching it steers the reference alone."""
    import jepsen_tpu.plan as ref_plan

    monkeypatch.delenv("JEPSEN_PLAN", raising=False)
    monkeypatch.setattr(ref_plan, "enabled", lambda: False)
    if request.param is None:
        monkeypatch.delenv("JEPSEN_WGL_PACKED", raising=False)
    else:
        monkeypatch.setenv("JEPSEN_WGL_PACKED", request.param)
    clear_settle_memo()
    ref_ind.clear_settle_memo()


def _cas_ops(n_keys, n_ops, bad_keys, *, Op_kv):
    """bench.py run_mixed's history generator, for either package."""
    gen, kvf = Op_kv
    ops = []
    for i in range(n_keys):
        h = gen(n_ops, procs=4, info_rate=0.05, seed=i, bad=i in bad_keys)
        ops += [o.replace(value=kvf(f"k{i}", o.value)) for o in h]
    return ops


#: One model pair per kind for the file: the JAX package compiles its
#: device programs per step function, so fresh models would compile
#: again in every test.  Both packages check the same histories in the
#: same order, so their interners stay equal.
_PAIRS = {}


def _pair(name, mk, ref_mk):
    if name not in _PAIRS:
        _PAIRS[name] = (mk(), ref_mk())
    return _PAIRS[name]


def _check_both(model, ref_model, h, ref_h, **kw):
    got = IndependentChecker(Linearizable(model, device="cpu", **kw),
                             device="cpu").check({}, h, {})
    want = ref_ind.IndependentChecker(RefLinearizable(ref_model, **kw)).check(
        {}, ref_h, {})
    return got, want


def _assert_parity(got, want):
    assert got["valid"] == want["valid"]
    assert got["failure-count"] == want["failure-count"]
    assert sorted(got["failures"]) == sorted(want["failures"])
    assert got["key-count"] == want["key-count"]
    for k, w in want["results"].items():
        g = got["results"][k]
        assert {f: g.get(f) for f in FIELDS} == {f: w.get(f) for f in FIELDS}, k


@pytest.mark.parametrize("n_keys,n_ops,bad_keys", [
    (40, 60, {3, 11, 17, 24, 30, 38}),     # tests/test_independent_mixed.py
    (200, 100, set(range(30))),            # bench.py run_mixed
])
def test_cas_mixed_shapes_match_reference(n_keys, n_ops, bad_keys):
    h = history(_cas_ops(n_keys, n_ops, bad_keys,
                         Op_kv=(random_register_history, kv)))
    ref_h = ref_hc.history(_cas_ops(n_keys, n_ops, bad_keys,
                                    Op_kv=(ref_gen, ref_ind.kv)))
    got, want = _check_both(*_pair("cas", models.cas_register,
                                   ref_models.cas_register),
                            h, ref_h, time_limit_s=600.0)
    _assert_parity(got, want)
    assert got["valid"] is False and got["failure-count"] == len(bad_keys)
    assert got["tiers"]["stream-proven"] == n_keys - len(bad_keys)


#: name -> (port model, reference model, generator, generator kwargs,
#: long key ops).
MODEL_CASES = {
    "mutex": (models.mutex, ref_models.mutex, mutex_ops, {}, 0),
    "multi-register": (
        lambda: models.multi_register({f"r{i}": 0 for i in range(5)}),
        lambda: ref_models.multi_register({f"r{i}": 0 for i in range(5)}),
        multi_register_ops, {}, 2100),
    "fifo-queue": (models.fifo_queue, ref_models.fifo_queue, queue_ops,
                   {"procs": 3, "info": 0.0}, 0),
    "unordered-queue": (models.unordered_queue, ref_models.unordered_queue,
                        queue_ops, {}, 0),
}


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_other_models_match_reference(name):
    """Keyed histories of each model (every 5th key bad; a long key
    past the ladder's 2,000-op bound for the multi-register)."""
    mk, ref_mk, gen, kw, long_ops = MODEL_CASES[name]
    bad = set(range(0, 14, 5))
    h = keyed_history(gen, 14, 30, bad, Op=Op, kv=kv, history=history,
                      long_key_ops=long_ops, **kw)
    ref_h = keyed_history(gen, 14, 30, bad, Op=ref_hc.Op, kv=ref_ind.kv,
                          history=ref_hc.history, long_key_ops=long_ops,
                          **kw)
    got, want = _check_both(*_pair(name, mk, ref_mk), h, ref_h,
                            time_limit_s=120.0)
    _assert_parity(got, want)
    assert got["failure-count"] == len(bad)
    if long_ops:
        assert got["tiers"]["long"] == 1
        assert got["results"]["long"]["algorithm"] == "wgl-tpu"


def test_subhistories_match_reference():
    """Keys in first-seen order; an :info completion that lost its
    payload takes its process's pending key; ops keep their indices."""
    rows = [("invoke", "write", ("a", 1), 0), ("invoke", "read", ("b", None), 1),
            ("ok", "write", ("a", 1), 0), ("info", "read", None, 1),
            ("invoke", "write", ("b", 2), 2), ("ok", "write", ("b", 2), 2),
            ("invoke", "read", None, 3), ("ok", "read", None, 3)]

    def build(OpT, kvf, hist):
        return hist([OpT(type=t, f=f, process=p,
                         value=kvf(*v) if isinstance(v, tuple) else v)
                     for t, f, v, p in rows])

    h = build(Op, kv, history)
    ref_h = build(ref_hc.Op, ref_ind.kv, ref_hc.history)
    assert history_keys(h) == ref_ind.history_keys(ref_h) == ["a", "b"]
    got, want = subhistories(h), ref_ind.subhistories(ref_h)
    assert list(got) == list(want)
    for k in want:
        assert [(o.type, o.f, o.value, o.process, o.index) for o in got[k]] \
            == [(o.type, o.f, o.value, o.process, o.index) for o in want[k]]


def _memo_history(OpT_kv_hist, gen):
    kvf, hist = OpT_kv_hist
    bad = gen(60, procs=4, info_rate=0.05, seed=7, bad=True)
    good = gen(60, procs=4, info_rate=0.05, seed=8)
    ops = []
    for name in ("a", "a2", "a3"):  # one bad subhistory, three times
        ops += [o.replace(value=kvf(name, o.value)) for o in bad]
    ops += [o.replace(value=kvf("g", o.value)) for o in good]
    return hist(ops)


def test_settle_memo_matches_reference():
    """Identical bad subhistories settle once: the others share the
    verdict (memo-hit) without the representative's certificate; a
    second check is answered from the memo."""
    h = _memo_history((kv, history), random_register_history)
    ref_h = _memo_history((ref_ind.kv, ref_hc.history), ref_gen)
    m, ref_m = _pair("cas", models.cas_register, ref_models.cas_register)
    for _ in range(2):
        got, want = _check_both(m, ref_m, h, ref_h, time_limit_s=600.0)
        _assert_parity(got, want)
        shared = [r for r in got["results"].values() if r.get("memo-hit")]
        assert len(shared) >= 2
        for r in shared:
            assert r["valid"] is False
            assert "final-configs" not in r and "crashed-op" not in r
    assert got["tiers"]["memo-hit"] == 3  # every bad key, from the memo


def test_unpackable_queue_keys_take_the_host_model():
    """A key with an indeterminate dequeue, and one that may hold more
    than the packed queue's 32 elements, take the host-model search."""
    def rows(OpT, kvf, hist):
        ops = []
        for key, vals in (("small", range(3)), ("big", range(40))):
            for v in vals:
                ops += [OpT(type="invoke", f="enqueue", value=kvf(key, v),
                            process=0),
                        OpT(type="ok", f="enqueue", value=kvf(key, v),
                            process=0)]
        ops += [OpT(type="invoke", f="dequeue", value=kvf("lost", None),
                    process=1),
                OpT(type="info", f="dequeue", value=None, process=1)]
        return hist(ops)

    got, want = _check_both(*_pair("unordered-queue",
                                   models.unordered_queue,
                                   ref_models.unordered_queue),
                            rows(Op, kv, history),
                            rows(ref_hc.Op, ref_ind.kv, ref_hc.history))
    _assert_parity(got, want)
    assert got["results"]["big"]["algorithm"] == "wgl-host-unpackable"
    assert got["results"]["lost"]["algorithm"] == "wgl-host-unpackable"
    assert got["tiers"]["unpackable"] == 2


@pytest.mark.parametrize("bad", [False, True])
def test_settle_engine_matches_reference(bad):
    g = random_register_history(100, procs=4, info_rate=0.05, seed=3,
                                bad=bad)
    r = ref_gen(100, procs=4, info_rate=0.05, seed=3, bad=bad)
    got = Linearizable(models.cas_register(), "settle", time_limit_s=60.0,
                       device="cpu").check({}, g, {})
    want = RefLinearizable(ref_models.cas_register(), "settle",
                           time_limit_s=60.0).check({}, r, {})
    assert got["valid"] is want["valid"] is (not bad)
    assert got["algorithm"] == want["algorithm"]


# ---------------------------------------------------------------------------
# No failure of the card or a kernel becomes a verdict.

def _small_history(bad=()):
    return history(_cas_ops(6, 40, set(bad),
                            Op_kv=(random_register_history, kv)))


def _checker(**kw):
    return IndependentChecker(Linearizable(models.cas_register(),
                                           device="cpu", **kw),
                              device="cpu")


def test_sweep_kernel_failure_propagates(monkeypatch):
    def failing(*a, **k):
        raise kernels.KernelLaunchError("witness_sweep launch failed: boom")

    monkeypatch.setattr(wgl_witness, "sweep", failing)
    with pytest.raises(kernels.KernelLaunchError):
        _checker().check({}, _small_history(), {})


def test_batched_kernel_build_failure_propagates(monkeypatch):
    """A bad mutex key passes the refutation screens and reaches the
    batched BFS, whose failure raises out of the check."""
    def failing(*a, **k):
        raise kernels.KernelBuildError("CUDA kernel build failed")

    monkeypatch.setattr(wgl_batched, "_search", failing)
    h = keyed_history(mutex_ops, 4, 30, {2}, Op=Op, kv=kv, history=history)
    with pytest.raises(kernels.KernelBuildError):
        IndependentChecker(Linearizable(models.mutex(), device="cpu"),
                           device="cpu").check({}, h, {})


def test_device_fault_in_a_per_key_check_propagates():
    class Failing(Linearizable):
        def check(self, test, history, opts):
            raise kernels.KernelLaunchError("launch failed")

    h = _small_history()
    with pytest.raises(kernels.KernelLaunchError):
        IndependentChecker(Failing(models.cas_register(), "cpu"),
                           device="cpu").check({}, h, {})


def test_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA is not missing here")
    with pytest.raises(DeviceUnavailable):
        IndependentChecker(Linearizable(models.cas_register())).check(
            {}, _small_history(), {})


def test_stream_resource_error_falls_through_on_the_same_device(monkeypatch):
    """An out-of-memory error out of the stream's witness pass leaves
    its keys to the per-key tiers (recorded as a degradation) and the
    verdicts stand.  (One raised inside a sweep is the witness tier's
    own: it retries at half the block shape, tests/test_torch_telemetry.py.)"""
    real = wgl_stream.check_wgl_witness
    calls = {"n": 0}

    def oom_once(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(*a, **k)

    monkeypatch.setattr(wgl_stream, "check_wgl_witness", oom_once)
    res = _checker(time_limit_s=120.0).check({}, _small_history(bad=(4,)),
                                             {})
    assert res["valid"] is False and res["failures"] == ["k4"]
    assert res["tiers"].get("stream-proven", 0) == 0
    assert [s["tier"] for s in res["degradations"]] == ["stream"]


def test_check_safe_turns_only_search_errors_into_unknown():
    class Boom:
        def __init__(self, e):
            self.e = e

        def check(self, test, history, opts):
            raise self.e

    assert check_safe(Boom(ValueError("x")), {}, None)["valid"] == "unknown"
    for e in (kernels.KernelLaunchError("x"), kernels.KernelBuildError("x"),
              DeviceUnavailable("x")):
        with pytest.raises(type(e)):
            check_safe(Boom(e), {}, None)
    assert merge_valid([True, "unknown", True]) == "unknown"
    assert merge_valid([True, "unknown", False]) is False


def test_bounded_pmap_keeps_order_and_raises():
    assert bounded_pmap(lambda x: x * x, range(10), bound=3) == \
        [x * x for x in range(10)]

    def f(x):
        if x == 4:
            raise KeyError(x)
        return x

    with pytest.raises(KeyError):
        bounded_pmap(f, range(8), bound=2)


def test_counters_keep_every_update_across_threads():
    """The many-key checker counts from worker threads: no update of
    `device.counters` is lost with more threads than cores and a short
    switch interval."""
    import sys
    import threading

    from jepsen_tpu_torch import device as D

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        D.counters.clear()

        def work():
            for _ in range(2000):
                D.count("stress")

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert D.counters["stress"] == 16 * 2000
    finally:
        sys.setswitchinterval(old)
