"""The port's SLO engine, Prometheus text, time-series store and flight
recorder against the reference's.

* The same gauge/counter/chip-state sequences through both packages'
  SLO engines give the same firing/cleared transitions, and `slo.jsonl`
  files written by either package read in the other.
* `prometheus_text` is line-equal on the same registry contents:
  counters, gauges, extras, chip health, SLO firing gauges, labeled
  families and the quantile summaries of the time-series rings.
* SeriesStore files written by either package read in the other, with
  the same tiers; SeriesTail follows a file the other package appends.
* Flight-recorder dumps have the same shape from the same notes; the
  port notes degradation steps and blown checker budgets as the
  reference does.
* The online session's verdict lag reaches the quantile ring.
"""

import json
import os

import pytest
import torch

import jepsen_tpu.telemetry as ref_telemetry
from jepsen_tpu.telemetry import flight as ref_flight
from jepsen_tpu.telemetry import slo as ref_slo
from jepsen_tpu.telemetry import timeseries as ref_ts
from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.telemetry import flight, slo
from jepsen_tpu_torch.telemetry import timeseries as ts

PAIRS = ((telemetry, slo, ts, flight),
         (ref_telemetry, ref_slo, ref_ts, ref_flight))


@pytest.fixture(autouse=True)
def _scope():
    """Both packages: telemetry on, registries, rings, rule states and
    flight rings clean before and after."""
    prior = [t.enabled() for t, *_ in PAIRS]

    def clean():
        for t, s, series, fl in PAIRS:
            t.reset()
            s.reset()
            s.set_dir(None)
            series.reset_rings()
            fl.reset()
            fl.set_dir(None)

    for t, *_ in PAIRS:
        t.enable(True)
    clean()
    yield
    clean()
    for (t, *_), p in zip(PAIRS, prior):
        t.enable(p)


def _strip(rec):
    return {k: v for k, v in rec.items() if k != "t"}


#: (gauges, counters, chip state, extras) per evaluation tick.
TICKS = [
    ({"wgl.online.verdict-lag-s": 1.0}, {"node.quarantined": 0}, "ok", {}),
    ({"wgl.online.verdict-lag-s": 45.0}, {}, "ok",
     {"checkerd.queue-depth": 40}),
    ({}, {"interpreter.op-timeouts": 5}, "wedged",
     {"checkerd.queue-depth": 50, "checkerd.merge-ratio": 0.0}),
    ({"wgl.online.verdict-lag-s": 2.0}, {"interpreter.op-timeouts": 50,
                                         "node.quarantined": 1}, "ok",
     {"checkerd.queue-depth": 1, "checkerd.merge-ratio": 0.0}),
    ({}, {"interpreter.op-timeouts": 51}, None,
     {"checkerd.merge-ratio": 0.0}),
    ({}, {}, "absent", {"checkerd.merge-ratio": 0.5}),
]


@pytest.mark.parametrize("rules", ["default", "monitor"])
def test_rule_transitions_equal_the_reference(rules, tmp_path):
    out = []
    for t, s, _, fl in PAIRS:
        chosen = (s.DEFAULT_RULES if rules == "default"
                  else s.DEFAULT_RULES + s.MONITOR_RULES)
        s.reset(chosen)
        d = tmp_path / t.__name__
        s.set_dir(str(d))
        fl.set_dir(str(d))
        trans = []
        for i, (gauges, counters, chip, extras) in enumerate(TICKS):
            for k, v in gauges.items():
                t.gauge(k, v)
            for k, v in counters.items():
                t.count(k, v - t.counter_value(k))
            trans.append([_strip(r) for r in s.evaluate(
                extras, chip, now=1000.0 + 10 * i)])
        out.append((trans, s.firing_gauges(),
                    [_strip(r) for r in s.read(s.slo_path(str(d)))],
                    [{k: v for k, v in st.items() if k != "since"}
                     for st in s.status()]))
    assert out[0] == out[1]
    trans = out[0][0]
    assert any(r["rec"] == "firing" for tick in trans for r in tick)
    assert any(r["rec"] == "cleared" for tick in trans for r in tick)


def test_slo_journals_read_in_either_package(tmp_path):
    for t, s, _, _ in PAIRS:
        s.set_dir(str(tmp_path / t.__name__))
        t.gauge("wgl.online.verdict-lag-s", 99.0)
        s.evaluate(now=5.0)
        t.gauge("wgl.online.verdict-lag-s", 1.0)
        s.evaluate(now=6.0)
    port_path = slo.slo_path(str(tmp_path / telemetry.__name__))
    ref_path = ref_slo.slo_path(str(tmp_path / ref_telemetry.__name__))
    with open(port_path, "a") as f:
        f.write('{"rec": "firing", "ru')  # a torn tail
    assert ref_slo.read(port_path) == slo.read(port_path) == \
        slo.read(ref_path) == ref_slo.read(ref_path)
    assert [r["rec"] for r in slo.read(ref_path)] == ["firing", "cleared"]


def test_prometheus_text_is_line_equal(monkeypatch):
    for t, s, series, _ in PAIRS:
        t.count("checkerd.requests", 3)
        t.count("wgl.plan.compile", 2)
        t.count("weird name/with:chars", 1.5)
        t.gauge("wgl.witness.beam", 8)
        t.gauge("checkerd.queue-depth", 4)
        for v in (0.1, 0.2, 0.3, 5.0):
            series.observe("wgl.online.verdict-lag-s", v)
        s.evaluate({"checkerd.queue-depth": 40}, "ok", now=1.0)
        s.evaluate({"checkerd.queue-depth": 40}, "ok", now=2.0)
    kw = dict(extra_gauges={"checkerd.utilization": 0.25,
                            "checkerd.merge-ratio": 0.5, "bad": "x"},
              chip_state="ok",
              lint_findings={"error": 2, "fam": {"warn": 1}},
              extra_labeled={"checkerd.shed": ("tenant", {"a": 2, "b": 1},
                                               "counter"),
                             "checkerd.queue-wait-p95-seconds":
                                 ("tenant", {"a": 0.5}, "gauge")})
    port = telemetry.prometheus_text(**kw)
    ref = ref_telemetry.prometheus_text(**kw)
    assert port.splitlines() == ref.splitlines()
    assert 'jepsen_slo_firing{rule="checkerd-queue-depth"} 1' in port
    assert 'jepsen_wgl_online_verdict_lag_s_dist{quantile="0.95"}' in port
    # The default engine's state when no firing map is passed.
    assert telemetry.prometheus_text(chip_state="wedged").splitlines() == \
        ref_telemetry.prometheus_text(chip_state="wedged").splitlines()


def test_quantiles_equal_the_reference():
    for v in [0.5, 3.0, 1.0, 8.0, 2.0] * 300:
        ts.observe("x", v)
        ref_ts.observe("x", v)
    assert ts.quantiles("x") == ref_ts.quantiles("x")
    assert ts.quantile_gauges() == ref_ts.quantile_gauges()
    assert ts.ring_names() == ref_ts.ring_names() == ["x"]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_series_files_read_in_either_package(writer, tmp_path):
    w = ts if writer == "port" else ref_ts
    d = str(tmp_path / "series")
    store = w.SeriesStore(d, tier1_s=10.0, tier2_s=40.0)
    for i in range(30):
        store.append({"a": i, "b": 2.0 * i, "junk": "x"}, t=100.0 + 3 * i)
    store.close()
    with open(w.series_path(d, 0), "ab") as f:
        f.write(b"\x05\x00\x00")  # a torn tail
    for tier in (0, 1, 2):
        for name in ("a", "b"):
            got = ts.read_disk_series(d, name, tier=tier)
            assert got == ref_ts.read_disk_series(d, name, tier=tier)
            assert got, (tier, name)
        assert ts.read_disk_names(d, tier) == ref_ts.read_disk_names(d, tier)
    # A store reopened by the other package rebuilds the same rings.
    for mod in (ts, ref_ts):
        again = mod.SeriesStore(d, tier1_s=10.0, tier2_s=40.0)
        assert again.query("a") == [(100.0 + 3 * i, float(i))
                                    for i in range(30)]
        again.close()


def test_series_tail_follows_the_other_package(tmp_path):
    d = str(tmp_path / "tail")
    store = ref_ts.SeriesStore(d)
    tail = ts.SeriesTail(ts.series_path(d, 0), from_end=False)
    store.append({"a": 1.0}, t=1.0)
    store.flush()
    first = tail.poll()
    store.append({"a": 2.0}, t=2.0)
    store.flush()
    second = tail.poll()
    tail.close()
    store.close()
    assert [p["s"]["a"] for p in first + second] == [1.0, 2.0]


def _flight_shape(fl, t, d):
    fl.set_dir(d)
    t.count("checker.budget-exceeded")
    fl.note("degrade.witness.retry-halved")
    fl.note("checker-budget-exceeded", checker="X", budget_s=1.0)
    path = fl.dump("checker-budget-exceeded")
    with open(path) as f:
        snap = json.load(f)
    snap["events"] = [{k: v for k, v in e.items() if k != "t"}
                      for e in snap["events"]]
    snap.pop("dumped_at")
    return snap, fl.status()["events"], fl.dump_count()


def test_flight_dumps_have_the_same_shape(tmp_path):
    port = _flight_shape(flight, telemetry, str(tmp_path / "port"))
    ref = _flight_shape(ref_flight, ref_telemetry, str(tmp_path / "ref"))
    assert port == ref
    assert port[0]["reason"] == "checker-budget-exceeded"
    assert port[0]["counters"] == {"checker.budget-exceeded": 1}


def test_degrade_and_budget_notes_reach_the_flight_ring(tmp_path):
    """degrade.record notes degrade.<tier>.<action>; check_safe notes a
    blown budget and dumps a postmortem, as the reference does."""
    import threading

    from jepsen_tpu_torch.checker.core import Checker, check_safe
    from jepsen_tpu_torch.ops import degrade

    flight.set_dir(str(tmp_path))
    degrade.record("witness", "retry-halved")
    release = threading.Event()

    class Hang(Checker):
        def check(self, test, history, opts):
            release.wait(30)
            return {"valid": True}

    try:
        res = check_safe(Hang(), {"checker_budget": 0.05}, [], {})
    finally:
        release.set()
    assert res["valid"] == "unknown" and "budget" in res["error"]
    kinds = [e["kind"] for e in flight.events()]
    assert kinds == ["degrade.witness.retry-halved",
                     "checker-budget-exceeded"]
    assert flight.dump_count() == 1
    assert os.path.exists(tmp_path / flight.POSTMORTEM_FILE)
    # A check inside its budget returns its own verdict.
    assert check_safe(Hang(), {"checker_budget": 30}, [], {},
                      budget_s=None) is not None


def test_online_verdict_lag_reaches_the_quantile_ring():
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.streaming import StreamingSession
    from jepsen_tpu_torch.utils.histgen import random_register_history

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sess = StreamingSession(cas_register().packed(), device="cpu",
                                swap_ops=1 << 30, swap_interval_s=3600)
        for o in random_register_history(60, procs=3, info_rate=0.0,
                                         seed=2):
            sess.feed(o)
        sess.finish()
    finally:
        torch.set_num_threads(n)
    qs = ts.quantiles("wgl.online.verdict-lag-s")
    assert qs and qs["p50"] == pytest.approx(sess.verdict_lag_s)
    assert slo.firing_gauges()["verdict-lag"] == 0
