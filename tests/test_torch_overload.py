"""The port's checkerd overload control plane against the reference's.

The cases of tests/test_overload.py, each driving the same event
sequence through `jepsen_tpu_torch.checkerd.overload` and
`jepsen_tpu.checkerd.overload` — FairQueue (deficit round-robin),
TenantStats, LatencyEstimator, OverloadShed, BrownoutController,
CircuitBreaker — and holding the port's outputs equal to the JAX
package's, and both to the reference tests' expectations.
"""

from dataclasses import dataclass, field

import pytest

from jepsen_tpu.checkerd import overload as ref_overload
from jepsen_tpu_torch.checkerd import overload


@dataclass
class _Req:
    tenant: str
    n_keys: int = 1
    compat: str = "c"
    abandoned: bool = False
    name: str = field(default="")


def _drain(fq):
    out = []
    while True:
        r = fq.next_head()
        if r is None:
            return out
        out.append(r)


def _both(fn):
    """fn(module) for the port and the reference -> (port, reference)."""
    return fn(overload), fn(ref_overload)


def _whale_and_light(mod):
    fq = mod.FairQueue(quantum=8.0)
    for i in range(50):
        fq.push(_Req("whale", n_keys=8, name=f"w{i}"))
    fq.push(_Req("light", n_keys=1, name="l0"))
    return [r.name for r in _drain(fq)]


def test_fair_queue_starvation_bound():
    port, ref = _both(_whale_and_light)
    assert port == ref and len(port) == 51
    assert port.index("l0") <= 2


def test_fair_queue_interleaves_equal_weights():
    def run(mod):
        fq = mod.FairQueue(quantum=8.0)
        for i in range(10):
            fq.push(_Req("a", n_keys=8, name=f"a{i}"))
            fq.push(_Req("b", n_keys=8, name=f"b{i}"))
        return [r.tenant for r in _drain(fq)]

    port, ref = _both(run)
    assert port == ref
    assert all(port[i] != port[i - 1] for i in range(1, 19))


def test_fair_queue_weight_scales_share():
    def run(mod):
        fq = mod.FairQueue(quantum=8.0, weights={"heavy": 3.0})
        for i in range(30):
            fq.push(_Req("heavy", n_keys=8, name=f"h{i}"))
            fq.push(_Req("lite", n_keys=8, name=f"l{i}"))
        return [r.tenant for r in _drain(fq)]

    port, ref = _both(run)
    assert port == ref
    assert 8 <= port[:12].count("heavy") <= 10
    assert port[:12].count("lite") >= 2


def test_fair_queue_take_compat_charges_each_tenant():
    def run(mod):
        fq = mod.FairQueue(quantum=8.0)
        fq.push(_Req("a", n_keys=4, compat="x", name="a0"))
        fq.push(_Req("a", n_keys=4, compat="y", name="a1"))
        fq.push(_Req("b", n_keys=2, compat="x", name="b0"))
        taken = sorted(r.name for r in fq.take_compat("x"))
        return taken, fq.snapshot(), len(fq)

    port, ref = _both(run)
    assert port == ref
    taken, snap, n = port
    assert taken == ["a0", "b0"] and n == 1
    assert snap["a"]["deficit"] == -4.0 and "b" not in snap


def test_fair_queue_drop_abandoned_and_empty():
    def run(mod):
        fq = mod.FairQueue()
        empty = fq.next_head()
        fq.push(_Req("a", abandoned=True, name="dead"))
        fq.push(_Req("a", name="live"))
        gone = [r.name for r in fq.drop_abandoned()]
        return empty, gone, [r.name for r in _drain(fq)]

    port, ref = _both(run)
    assert port == ref == (None, ["dead"], ["live"])


def test_tenant_stats_p95_and_sheds():
    def run(mod):
        ts = mod.TenantStats()
        for i in range(100):
            ts.observe_wait("t", i / 100.0)
        ts.record_shed("t")
        ts.record_shed("u")
        return ts.wait_p95("t"), ts.snapshot(), ts.wait_p95("nobody")

    port, ref = _both(run)
    assert port == ref
    p95, snap, nobody = port
    assert 0.9 <= p95 <= 0.99 and nobody is None
    assert (snap["t"]["served"], snap["t"]["shed"], snap["u"]["shed"]) == \
        (100, 1, 1)


def test_latency_estimator_learns_observed_rate(monkeypatch):
    """Untrained cost models on both sides: the observed-rate path."""
    monkeypatch.delenv("JEPSEN_COSTMODEL", raising=False)

    def run(mod):
        est = mod.LatencyEstimator()
        default = est.predict_s(10)
        for _ in range(8):
            est.observe(10, 5.0)
        return default, est.predict_s(10), est.queue_wait_s(20)

    port, ref = _both(run)
    assert port == ref
    default, learned, wait = port
    assert learned > default and wait > 0


@pytest.mark.parametrize("n_keys,n_ops", [(1, 0), (10, 100), (200, 20000)])
def test_latency_estimator_reads_the_active_cost_model(monkeypatch, n_keys,
                                                       n_ops):
    """With no trained model both packages predict by the same
    heuristic; the port reads its own plan/costmodel.active_model."""
    from jepsen_tpu.plan import costmodel as ref_costmodel
    from jepsen_tpu_torch.plan import costmodel

    monkeypatch.delenv("JEPSEN_COSTMODEL", raising=False)
    assert costmodel.active_model() is None
    assert ref_costmodel.active_model() is None
    port, ref = _both(lambda mod: mod.LatencyEstimator().predict_s(
        n_keys, n_ops))
    assert port == ref > 0


def test_overload_shed_payload_roundtrip():
    def run(mod):
        e = mod.OverloadShed("queue too deep", retry_after_s=2.5,
                             tenant="alpha", estimate_s=9.0, deadline_s=3.0)
        p = e.payload()
        back = mod.OverloadShed.from_payload(p)
        return p, back.retry_after_s, back.tenant, back.reason

    port, ref = _both(run)
    assert port == ref
    p, retry, tenant, reason = port
    assert p["shed"] is True and p["retry-after-s"] == 2.5
    assert (retry, tenant) == (2.5, "alpha") and "queue too deep" in reason


def test_overload_shed_retry_after_floor():
    for bad in ({}, {"retry-after-s": 0}, {"retry-after-s": -4},
                {"retry-after-s": "soon"}):
        port, ref = _both(
            lambda mod: mod.OverloadShed.from_payload(bad).retry_after_s)
        assert port == ref >= 0.1


def test_client_shed_exception_carries_retry_after():
    from jepsen_tpu_torch.checkerd.client import (RemoteUnavailable,
                                                  ShedByServer)

    e = ShedByServer({"shed": True, "reason": "saturated",
                      "retry-after-s": 1.5, "tenant": "t"})
    assert e.retry_after_s == 1.5
    assert "saturated" in str(e)
    assert isinstance(e, RemoteUnavailable)


def _ladder(mod):
    return mod.BrownoutController(queue_high=10.0, rss_high_mb=None,
                                  up_count=2, down_count=3)


def test_brownout_escalates_in_order():
    def run(mod):
        b = _ladder(mod)
        seen = [(b.level, b.dropped_passes())]
        for depth in (15, 15, 25, 25):
            b.sample(depth)
            seen.append((b.level, b.dropped_passes(), b.shed_factor()))
        return seen

    port, ref = _both(run)
    assert port == ref
    assert port[0] == (0, ())
    assert port[1][0] == 0 and port[2][:2] == (1, ("stream",))
    assert port[4] == (2, ("stream", "batched"), 2.0)


def test_brownout_deescalates_with_hysteresis():
    def run(mod):
        b = _ladder(mod)
        for _ in range(4):
            b.sample(25)
        levels = [b.level]
        for _ in range(6):
            b.sample(0)
            levels.append(b.level)
        return levels, b.shed_factor(), b.transitions

    port, ref = _both(run)
    assert port == ref
    assert port[0] == [2, 2, 2, 1, 1, 1, 0] and port[1] == 1.0


def test_brownout_force_env(monkeypatch, tmp_path):
    def levels(mod):
        b = _ladder(mod)
        out = []
        monkeypatch.setenv(mod.FORCE_ENV, "2")
        out.append(b.level)
        p = tmp_path / f"force-{mod.__name__}"
        p.write_text("1")
        monkeypatch.setenv(mod.FORCE_ENV, f"file:{p}")
        out.append(b.level)
        p.unlink()
        monkeypatch.delenv(mod.FORCE_ENV)
        out.append(b.level)
        return out

    assert overload.FORCE_ENV == ref_overload.FORCE_ENV
    port, ref = _both(levels)
    assert port == ref == [2, 1, 0]


def _breaker(mod, now, **kw):
    kw.setdefault("failure_threshold", 3)
    return mod.CircuitBreaker(base_backoff_s=1.0, jitter=0.0,
                              clock=lambda: now[0], rng=lambda: 0.5, **kw)


def test_breaker_open_halfopen_close():
    def run(mod):
        now = [0.0]
        br = _breaker(mod, now)
        seen = [br.state, br.allow()]
        br.record_failure()
        br.record_failure()
        seen.append(br.allow())
        br.record_failure()
        seen += [br.state, br.allow()]
        now[0] = 1.1
        seen += [br.state, br.allow(), br.allow()]
        br.record_success()
        seen += [br.state, br.allow(), br.stats()]
        return seen

    port, ref = _both(run)
    assert port == ref
    assert port[:9] == ["closed", True, True, "open", False, "half-open",
                        True, False, "closed"]


def test_breaker_halfopen_failure_doubles_backoff():
    def run(mod):
        now = [0.0]
        br = _breaker(mod, now, failure_threshold=1)
        br.record_failure()
        now[0] = 1.1
        seen = [br.allow()]
        br.record_failure()
        now[0] = 2.1
        seen.append(br.allow())
        now[0] = 3.2
        seen.append(br.allow())
        return seen

    port, ref = _both(run)
    assert port == ref == [True, False, True]


def test_breaker_registry_per_address():
    overload.reset_breakers()
    try:
        a = overload.breaker_for("h:1")
        assert overload.breaker_for("h:1") is a
        assert overload.breaker_for("h:2") is not a
    finally:
        overload.reset_breakers()


def test_deadline_shed_and_served_match_the_reference(monkeypatch):
    """The same admissions through both packages' schedulers' shed
    decision: a deadline the estimate cannot meet sheds with the same
    payload fields; one it can is admitted."""
    from jepsen_tpu.checkerd import scheduler as ref_sched
    from jepsen_tpu_torch.checkerd import scheduler as sched

    monkeypatch.delenv("JEPSEN_COSTMODEL", raising=False)
    out = []
    for mod, omod in ((sched, overload), (ref_sched, ref_overload)):
        s = mod.Scheduler.__new__(mod.Scheduler)
        s._fq = omod.FairQueue()
        s.estimator = omod.LatencyEstimator()
        s.tenant_stats = omod.TenantStats()
        s.n_shed = 0
        for i in range(5):
            s._fq.push(_Req(f"t{i}", n_keys=40))
        got = []
        for deadline in (0.01, 1e6):
            req = mod.Request(run="r", model_spec={"type": "register"},
                              n_keys=100, deadline_s=deadline)
            try:
                s._maybe_shed_locked(req)
                got.append("admitted")
            except omod.OverloadShed as e:
                p = e.payload()
                got.append((p["reason"][:40], p["retry-after-s"],
                            p["tenant"]))
        out.append((got, s.n_shed))
    assert out[0] == out[1]
    assert out[0][0][1] == "admitted" and out[0][1] == 1
