"""The port's telemetry, profile records and fault hook.

* `jepsen_tpu_torch.telemetry`: the cases of tests/test_telemetry.py
  that exercise `span`, `count`, `gauge`, threads, the event cap, the
  disabled no-op and `export`, against the port's API; and the spans
  the ported paths emit (witness, stream, online, ingest, checker).
* `telemetry.profile`: the store (append / read / normalize / by_pass /
  count_records, torn lines skipped), `capture` and `annotate`, and,
  for one bench-shaped check and one many-key check at a small size,
  records whose `pass`, `features` and `plan` equal the JAX package's.
  Excluded from that comparison: `timing` (wall clocks), `device` (the
  port names its torch device, the reference its JAX device), `cost`
  and `roofline` (the port counts its device calls' costs itself,
  telemetry/roofline.py; the reference reads XLA's) and the "mesh" knob
  (the JAX side runs on the tests' 8-device virtual CPU mesh; the port
  has none).  The "packed" knob is compared, with the packed member
  lanes off and at their default.
* The fault hook: the counterparts of tests/test_robustness.py's
  degradation cases.  A witness fault sheds the packed lanes, retries at
  half the block shape and then falls through; a device fault sheds the
  packed lanes, halves the beam and gives "unknown" with reason
  "device-resource-error".  Where the reference settles on its CPU
  engine once every tier failed (`JEPSEN_WGL_FAULT=all`), the port
  retries the device search once at half size and then raises,
  carrying the card probe's result."""

import json
import os
import threading

import pytest
import torch

import jepsen_tpu.parallel.independent as ref_ind
import jepsen_tpu.plan.cache as ref_cache
import jepsen_tpu.telemetry as ref_telemetry
from jepsen_tpu.checker.linearizable import Linearizable as RefLinearizable
from jepsen_tpu.history.core import history as ref_history
from jepsen_tpu.models import cas_register as ref_cas_register
from jepsen_tpu.telemetry import profile as ref_profile
from jepsen_tpu.utils.histgen import random_register_history as ref_gen
from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.checker import Linearizable
from jepsen_tpu_torch.checker.core import check_safe
from jepsen_tpu_torch.history.core import history
from jepsen_tpu_torch.history.packed import pack_history
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops import degrade, wgl_witness
from jepsen_tpu_torch.ops.kernels import KernelLaunchError
from jepsen_tpu_torch.parallel import (IndependentChecker, clear_settle_memo,
                                       kv)
from jepsen_tpu_torch.plan import cache as plan_cache
from jepsen_tpu_torch.telemetry import profile
from jepsen_tpu_torch.utils.histgen import (random_register_history,
                                            random_register_packed)


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


@pytest.fixture(autouse=True)
def _telemetry_scope(monkeypatch):
    """Each test starts enabled with a clean registry and no profile
    store, and leaves the module as it found it."""
    monkeypatch.delenv(degrade.FAULT_ENV, raising=False)
    prior = telemetry.enabled()
    telemetry.enable(True)
    telemetry.reset()
    profile.set_store(None)
    yield
    profile.set_store(None)
    telemetry.reset()
    telemetry.enable(prior)


# ---------------------------------------------------------------- registry


def test_span_aggregates_count_total_max():
    for _ in range(3):
        with telemetry.span("x.y"):
            pass
    st = telemetry.summary()["spans"]["x.y"]
    assert st["count"] == 3
    assert st["total_s"] >= 0
    assert st["max_s"] <= st["total_s"]
    assert st["mean_s"] == pytest.approx(st["total_s"] / 3, abs=2e-6)


def test_span_nesting_records_both_levels():
    with telemetry.span("outer"):
        with telemetry.span("inner"):
            pass
    spans = telemetry.summary()["spans"]
    assert spans["outer"]["count"] == 1
    assert spans["inner"]["count"] == 1
    assert spans["outer"]["total_s"] >= spans["inner"]["total_s"]


def test_span_records_on_exception():
    with pytest.raises(RuntimeError):
        with telemetry.span("boom"):
            raise RuntimeError("x")
    assert telemetry.summary()["spans"]["boom"]["count"] == 1


def test_spans_from_many_threads_all_land():
    N, REPS = 8, 50
    barrier = threading.Barrier(N)

    def work():
        barrier.wait()
        for _ in range(REPS):
            with telemetry.span("t.work"):
                pass
            telemetry.count("t.n")

    threads = [threading.Thread(target=work) for _ in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    s = telemetry.summary()
    assert s["spans"]["t.work"]["count"] == N * REPS
    assert s["counters"]["t.n"] == N * REPS
    trace = telemetry.chrome_trace()
    tids = {e["tid"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert len(tids) == N


def test_counters_and_gauges():
    telemetry.count("c", 3)
    telemetry.count("c", 4)
    telemetry.gauge("g", 10)
    telemetry.gauge("g", 2)
    telemetry.gauge("g", 7)
    s = telemetry.summary()
    assert s["counters"]["c"] == 7
    assert telemetry.counter_value("c") == 7.0
    assert telemetry.counter_value("absent") == 0.0
    assert s["gauges"]["g"] == {"last": 7, "min": 2, "max": 10,
                                "samples": 3}


def test_top_spans_and_phases():
    with telemetry.span("p.slow"):
        for _ in range(10000):
            pass
    with telemetry.span("p.fast"):
        pass
    tops = telemetry.top_spans(1)
    assert tops[0][0] == "p.slow"
    ph = telemetry.phases("p")
    assert set(ph) == {"slow", "fast"}
    assert ph["slow"] >= ph["fast"]


def test_event_buffer_cap_drops_events_not_stats(monkeypatch):
    monkeypatch.setattr(telemetry, "MAX_TRACE_EVENTS", 5)
    for _ in range(8):
        with telemetry.span("capped"):
            pass
    s = telemetry.summary()
    assert s["spans"]["capped"]["count"] == 8
    assert s["trace_events"] == 5
    assert s["trace_events_dropped"] == 3


def test_disabled_span_is_shared_noop_and_records_nothing():
    telemetry.enable(False)
    s1 = telemetry.span("a")
    s2 = telemetry.span("b", attr=1)
    assert s1 is s2
    with s1:
        pass
    telemetry.count("c")
    telemetry.gauge("g", 1)
    telemetry.enable(True)
    s = telemetry.summary()
    assert s["spans"] == {} and s["counters"] == {} and s["gauges"] == {}


def test_enabled_flag_reflects_enable_calls():
    assert telemetry.enabled() is True
    telemetry.enable(False)
    assert telemetry.enabled() is False


def test_trace_context_seeds_and_mints():
    telemetry.seed_trace({"trace-id": "abc"})
    assert telemetry.trace_id() == "abc"
    telemetry.seed_trace(None)
    tid = telemetry.trace_id()
    assert len(tid) == 16 and tid != "abc"
    assert telemetry.new_span_id() != telemetry.new_span_id()


# ----------------------------------------------------------------- exporters


def test_export_writes_valid_summary_and_chrome_trace(tmp_path):
    with telemetry.span("e.one", k="v"):
        pass
    telemetry.count("e.n", 2)
    paths = telemetry.export(str(tmp_path))
    assert paths is not None
    sum_path, trace_path = paths
    summ = json.loads(open(sum_path).read())
    assert summ["spans"]["e.one"]["count"] == 1
    assert summ["counters"]["e.n"] == 2
    trace = json.loads(open(trace_path).read())
    assert trace["displayTimeUnit"] == "ms"
    evs = trace["traceEvents"]
    xs = [e for e in evs if e["ph"] == "X"]
    assert len(xs) == 1
    e = xs[0]
    assert e["name"] == "e.one" and e["cat"] == "e"
    assert isinstance(e["ts"], float) and isinstance(e["dur"], float)
    assert e["args"] == {"k": "v"}
    metas = [e for e in evs if e["ph"] == "M"]
    assert metas and all(m["name"] == "thread_name" for m in metas)


def test_export_disabled_returns_none(tmp_path):
    telemetry.enable(False)
    assert telemetry.export(str(tmp_path)) is None
    assert not os.path.exists(tmp_path / "telemetry.json")


def test_export_survives_unwritable_dir():
    with telemetry.span("x"):
        pass
    assert telemetry.export("/proc/nonexistent/nope") is None


# ------------------------------------------------------- spans of the paths


def test_check_safe_produces_per_checker_spans():
    class Named:
        name = "named-checker"

        def check(self, test, history, opts):
            return {"valid": True}

    h = random_register_history(60, procs=2, info_rate=0.0, seed=3)
    assert check_safe(Linearizable(cas_register(), device="cpu"), {}, h,
                      {})["valid"] is True
    assert check_safe(Named(), {}, h, {})["valid"] is True
    spans = telemetry.summary()["spans"]
    assert "checker.Linearizable" in spans
    assert "checker.named-checker" in spans


def test_checking_paths_emit_the_reference_spans():
    from jepsen_tpu_torch.streaming import StreamingSession

    h = random_register_history(400, procs=4, info_rate=0.05, seed=5)
    Linearizable(cas_register(), device="cpu").check({}, h, {})
    keyed = history([o.replace(value=kv(f"k{i}", o.value)) for i in range(3)
                     for o in random_register_history(
                         30, procs=2, info_rate=0.0, seed=6 + i)])
    IndependentChecker(Linearizable(cas_register(), device="cpu"),
                       device="cpu").check({}, keyed, {})
    sess = StreamingSession(cas_register().packed(), swap_ops=1 << 30,
                            swap_interval_s=3600.0, advance_rows=64,
                            device="cpu")
    for op in random_register_history(600, procs=4, info_rate=0.0,
                                      seed=8):
        sess.feed(op)
    sess.finish()
    spans = telemetry.summary()["spans"]
    for name in ("wgl.witness", "wgl.witness.plan", "wgl.witness.chunk",
                 "wgl.stream", "wgl.online.swap", "wgl.online.advance",
                 "wgl.online.chunk", "ingest.snapshot", "ingest.finish"):
        assert name in spans, name
    c = telemetry.summary()["counters"]
    assert c["wgl.plan.compile"] >= 2 and c["wgl.plan.execute"] >= 2
    assert c["wgl.witness.hit"] >= 1
    assert c["wgl.plan.witness-block-heuristic"] >= 1
    assert telemetry.settle_counters()["wgl.settle.stream-proven"] == 3


# ------------------------------------------------------------ profile store


def test_profile_store_roundtrip_and_torn_lines(tmp_path):
    path = profile.set_store(str(tmp_path))
    assert path == str(tmp_path / profile.PROFILE_FILE)
    assert profile.store_path() == path
    for name in ("witness", "stream", "witness"):
        with profile.capture(name, ops=10, ok=9) as cap:
            cap.knob(beam=8)
    with open(path, "a") as f:
        f.write('{"pass": "torn", "featu\n')  # a crash mid-append
        f.write("garbage\n\n")
        f.write(json.dumps({"pass": 7, "timing": {"total_s": "x"}}) + "\n")
    recs = profile.read(path)
    assert [r["pass"] for r in recs] == ["witness", "stream", "witness",
                                        "unknown"]
    assert profile.by_pass() == {"witness": 2, "stream": 1, "unknown": 1}
    assert profile.count_records() == 4
    r = recs[0]
    assert r["v"] == profile.SCHEMA_VERSION
    assert r["features"] == {"ops": 10, "ok": 9} and r["plan"] == {"beam": 8}
    assert set(r["timing"]) == {"compile_s", "execute_s", "total_s"}
    assert r["cost"] == profile.COST_NULL
    assert r["roofline"] == profile.ROOFLINE_NULL
    assert r["device"] == profile.DEVICE_NULL  # no device named
    old = recs[3]
    assert old["v"] == 1 and old["timing"] == {}
    assert profile.read(str(tmp_path / "missing.jsonl")) == []
    assert profile.set_store(None) is None
    assert profile.count_records() == 0


def test_capture_is_a_noop_when_disabled(tmp_path):
    profile.set_store(str(tmp_path))
    telemetry.enable(False)
    with profile.capture("witness", ops=1) as cap:
        cap.knob(x=1)
        profile.annotate(y=2)  # no active capture: a no-op
    assert cap.plan == {"x": 1}
    assert not os.path.exists(profile.store_path())


def test_capture_folds_execute_spans_and_nests(tmp_path):
    profile.set_store(str(tmp_path))
    with profile.capture("settle", device="cpu", keys=2) as outer:
        with profile.capture("batched", keys=1):
            with telemetry.span("wgl.batched.block"):
                pass
            profile.annotate(beam=32)
        with telemetry.span("wgl.bfs.compile"):
            pass
        profile.annotate(after=1)
        outer.outcome = {"ok": 1}
        profile.note_cost({"flops": 3.0})
    recs = profile.read(profile.store_path())
    assert [r["pass"] for r in recs] == ["batched", "settle"]
    batched, settle = recs
    assert batched["plan"] == {"beam": 32}
    assert settle["plan"] == {"after": 1}
    assert batched["timing"]["execute_s"] > 0
    # The outer record sees its child's execute span and its own
    # compile span.
    assert settle["timing"]["execute_s"] >= batched["timing"]["execute_s"]
    assert settle["timing"]["compile_s"] > 0
    assert settle["cost"]["device_calls"] == 1
    assert settle["cost"]["flops"] == 3.0
    assert settle["device"] == {"platform": "cpu", "device_kind": "cpu",
                                "peak_bytes": None}
    assert settle["outcome"] == {"ok": 1}


def test_capture_records_an_error_outcome(tmp_path):
    profile.set_store(str(tmp_path))
    with pytest.raises(KeyError):
        with profile.capture("stream"):
            raise KeyError("x")
    assert profile.read(profile.store_path())[0]["outcome"] == \
        "error:KeyError"


def _records(mod):
    """Every record of a store as (pass, features, plan), with the knobs
    the comparison leaves out (see the module docstring) removed,
    sorted: settle threads append in any order."""
    out = []
    for r in mod.read(mod.store_path()):
        plan = {k: v for k, v in r["plan"].items()
                if k != "mesh"}
        out.append(json.dumps([r["pass"], r["features"], plan],
                              sort_keys=True))
    return sorted(out)


@pytest.fixture(params=["0", None], ids=["wide", "packed"])
def both_stores(request, tmp_path, monkeypatch):
    """Profile stores for both packages, both on the plan route, with
    wide member bitsets (JEPSEN_WGL_PACKED=0) and then at the default,
    packed lanes."""
    monkeypatch.delenv("JEPSEN_PLAN", raising=False)
    monkeypatch.delenv("JEPSEN_PLAN_CACHE", raising=False)
    if request.param is None:
        monkeypatch.delenv("JEPSEN_WGL_PACKED", raising=False)
    else:
        monkeypatch.setenv("JEPSEN_WGL_PACKED", request.param)
    ref_prior = ref_telemetry.enabled()
    ref_telemetry.enable(True)
    ref_telemetry.reset()
    plan_cache.reset_for_tests()
    ref_cache.reset_for_tests()
    clear_settle_memo()
    ref_ind.clear_settle_memo()
    profile.set_store(str(tmp_path / "port"))
    ref_profile.set_store(str(tmp_path / "ref"))
    yield
    ref_profile.set_store(None)
    ref_telemetry.enable(ref_prior)


#: One model pair for the profile comparisons.
_MODELS = {}


def _models():
    if not _MODELS:
        _MODELS["cas"] = (cas_register(), ref_cas_register())
    return _MODELS["cas"]


def test_profile_records_equal_the_reference_bench_shape(both_stores):
    """The bench history's shape (16 processes, 5% :info) at 3,000 ops."""
    m, ref_m = _models()
    kw = dict(procs=16, info_rate=0.05, seed=45100)
    got = Linearizable(m, device="cpu").check(
        {}, random_register_history(3000, **kw), {})
    want = RefLinearizable(ref_m).check({}, ref_gen(3000, **kw), {})
    assert (got["valid"], got["algorithm"]) == (want["valid"],
                                                want["algorithm"])
    mine = _records(profile)
    assert mine == _records(ref_profile)
    assert [json.loads(r)[0] for r in mine] == ["witness"]
    rec = profile.read(profile.store_path())[0]
    assert rec["device"]["platform"] == "cpu"


def test_profile_records_equal_the_reference_many_keys(both_stores):
    """bench.py run_mixed's shape at 40 keys x 60 ops, 6 bad."""
    m, ref_m = _models()
    bad = {3, 11, 17, 24, 30, 38}

    def ops(gen, kvf):
        out = []
        for i in range(40):
            for o in gen(60, procs=4, info_rate=0.05, seed=i,
                         bad=i in bad):
                out.append(o.replace(value=kvf(f"k{i}", o.value)))
        return out

    got = IndependentChecker(Linearizable(m, device="cpu"),
                             device="cpu").check(
        {}, history(ops(random_register_history, kv)), {})
    want = ref_ind.IndependentChecker(RefLinearizable(ref_m)).check(
        {}, ref_history(ops(ref_gen, ref_ind.kv)), {})
    assert got["failure-count"] == want["failure-count"] == 6
    mine = _records(profile)
    assert mine == _records(ref_profile)
    assert sorted({json.loads(r)[0] for r in mine}) == ["settle", "stream"]


# ---------------------------------------------------------------- the faults


def _small_packed(n=200):
    pm = cas_register().packed()
    return random_register_packed(n, procs=2, info_rate=0.0, seed=11,
                                  model=pm), pm


def test_resource_classification():
    assert degrade.is_resource_error(MemoryError())
    assert degrade.is_resource_error(degrade.InjectedFault("x"))
    assert degrade.is_resource_error(
        RuntimeError("RESOURCE_EXHAUSTED: out of memory allocating"))
    assert not degrade.is_resource_error(ValueError("bad shape"))
    assert not degrade.is_resource_error(KeyboardInterrupt())
    exhausted = degrade.CardExhausted("x", {"ok": False})
    assert degrade.is_device_fault(exhausted)
    assert not degrade.is_resource_error(exhausted)
    assert not degrade.is_device_fault(degrade.InjectedFault("x"))


def test_maybe_fault_env(monkeypatch):
    monkeypatch.setenv(degrade.FAULT_ENV, "witness,device")
    assert degrade.fault_tiers() == {"witness", "device"}
    with pytest.raises(degrade.InjectedFault):
        degrade.maybe_fault("witness")
    degrade.maybe_fault("batched")  # not named: no-op
    monkeypatch.setenv(degrade.FAULT_ENV, "all")
    with pytest.raises(degrade.InjectedFault):
        degrade.maybe_fault("batched")
    monkeypatch.delenv(degrade.FAULT_ENV)
    degrade.maybe_fault("witness")  # hook disarmed


def test_capture_nests_and_counts():
    with degrade.capture() as outer:
        degrade.record("witness", "retry-halved", RuntimeError("oom"))
        with degrade.capture() as inner:
            degrade.record("device", "fall-through")
    assert [e["tier"] for e in inner] == ["device"]
    assert [e["tier"] for e in outer] == ["witness", "device"]
    assert "oom" in outer[0]["error"]
    rc = telemetry.resilience_counters()
    assert rc["wgl.degrade.witness.retry-halved"] == 1
    assert rc["wgl.degrade.device.fall-through"] == 1


def test_witness_fault_retries_then_falls_through(monkeypatch):
    from jepsen_tpu_torch.ops.wgl_witness import check_wgl_witness

    packed, pm = _small_packed()
    monkeypatch.setenv(degrade.FAULT_ENV, "witness")
    with degrade.capture() as steps:
        res = check_wgl_witness(packed, pm, device="cpu")
    assert res is None  # fall-through means "escalate", never a verdict
    assert [s["action"] for s in steps if s["tier"] == "witness"] == [
        "packed-fallback", "retry-halved", "fall-through"]


def test_witness_out_of_memory_retries_at_half_the_block_shape(
        monkeypatch):
    """An out-of-memory error inside a sweep is the witness tier's own:
    the packed lanes go first, at the same block shape; a second one
    takes the retry at half the block shape, which here succeeds."""
    from jepsen_tpu_torch.ops.wgl_witness import check_wgl_witness

    packed, pm = _small_packed(600)
    real = wgl_witness.sweep
    shapes = []

    def oom_once(pm_, start_k, bars, *a, **k):
        shapes.append(bars.shape[1])
        if len(shapes) <= 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(pm_, start_k, bars, *a, **k)

    monkeypatch.setattr(wgl_witness, "sweep", oom_once)
    with degrade.capture() as steps:
        res = check_wgl_witness(packed, pm, device="cpu")
    assert res is not None and res.valid is True
    assert [(s["tier"], s["action"]) for s in steps] == [
        ("witness", "packed-fallback"), ("witness", "retry-halved")]
    assert shapes[:2] == [2048, 2048] and set(shapes[2:]) == {1024}


def test_device_fault_degrades_to_unknown(monkeypatch):
    from jepsen_tpu_torch.ops.wgl import check_wgl_device

    packed, pm = _small_packed()
    monkeypatch.setenv(degrade.FAULT_ENV, "device")
    with degrade.capture() as steps:
        res = check_wgl_device(packed, pm, witness=False, device="cpu")
    assert res.valid == "unknown"
    assert res.reason == "device-resource-error"
    assert [(s["tier"], s["action"]) for s in steps] == [
        ("device", "packed-fallback"), ("device", "retry-halved"),
        ("device", "fall-through")]


def _wide_refutation():
    """An invalid cas-register history whose BFS frontier, at block 8,
    starts one block 277 configurations wide (beam 512) after starting
    others narrow (23 wide at beam 256): 92 packed ops, exact refutation
    at max_beam 512, beam overflow at max_beam 256."""
    return random_register_history(120, procs=8, info_rate=0.1, seed=1,
                                   bad_at=0.9)


def _fault_once(monkeypatch, when):
    """Makes the BFS's first block whose (start width, beam) satisfies
    `when` raise an out-of-memory error, once with each member layout
    (packed words, then the bool rows it falls back to); later blocks
    run."""
    from jepsen_tpu_torch.ops import wgl

    real = wgl._run_block
    fired = []
    layouts = set()

    def block(member, states, alive, iters, tables, B, *a, **k):
        if member.dtype not in layouts and when(int(alive.sum()), B):
            layouts.add(member.dtype)
            fired.append((int(alive.sum()), B))
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(member, states, alive, iters, tables, B, *a, **k)

    monkeypatch.setattr(wgl, "_run_block", block)
    return fired


def test_device_fault_on_a_wide_frontier_gives_out_whole(monkeypatch):
    """A block whose frontier is wider than half the beam is not cut to
    fit: that would turn the refutation into a beam overflow, which the
    CPU would settle.  The BFS gives out for the caller's halved retry."""
    from jepsen_tpu_torch.ops.wgl import check_wgl_device

    pm = cas_register().packed()
    packed = pack_history(_wide_refutation(), pm.encode)
    fired = _fault_once(monkeypatch, lambda w, B: w > B // 2)
    with degrade.capture() as steps:
        res = check_wgl_device(packed, pm, beam=256, max_beam=512, block=8,
                               witness=False, device="cpu")
    assert fired == [(277, 512)] * 2
    assert (res.valid, res.reason) == ("unknown", "device-resource-error")
    assert [(s["tier"], s["action"]) for s in steps] == [
        ("device", "packed-fallback"), ("device", "fall-through")]


def test_device_halved_beam_is_not_doubled_back(monkeypatch):
    """After the halved retry the search stays at most half as wide: a
    later block that overflows gives out rather than doubling back to
    the beam the device could not hold."""
    from jepsen_tpu_torch.ops.wgl import check_wgl_device

    pm = cas_register().packed()
    packed = pack_history(_wide_refutation(), pm.encode)
    fired = _fault_once(monkeypatch, lambda w, B: w == 23)
    with degrade.capture() as steps:
        res = check_wgl_device(packed, pm, beam=256, max_beam=512, block=8,
                               witness=False, device="cpu")
    assert fired == [(23, 256)] * 2
    assert (res.valid, res.reason) == ("unknown", "device-resource-error")
    assert [(s["tier"], s["action"]) for s in steps] == [
        ("device", "packed-fallback"), ("device", "retry-halved"),
        ("device", "fall-through")]
    assert "after the halved retry" in steps[-1]["error"]


def test_device_fault_on_a_wide_frontier_raises_not_settles(monkeypatch):
    """The checker retries the whole search at half size; that search
    overflows its halved beam, so the check raises with the probe and
    no CPU engine runs (the reference settles on its CPU engine).  The
    refutation screens, which would refute this history on the host,
    are turned off so that the device search runs."""
    import importlib

    lin_mod = importlib.import_module("jepsen_tpu_torch.checker.linearizable")
    monkeypatch.setattr(lin_mod, "check_refute", lambda *a, **k: None)
    fired = _fault_once(monkeypatch, lambda w, B: w > B // 2)

    def no_cpu(*a, **k):
        raise AssertionError("a device fault reached the CPU engine")

    monkeypatch.setattr(Linearizable, "_cpu_exact", no_cpu)
    with degrade.capture() as steps:
        with pytest.raises(degrade.CardExhausted) as ei:
            Linearizable(cas_register(), beam=256, max_beam=512, block=8,
                         device="cpu").check({}, _wide_refutation(), {})
    assert fired == [(277, 512)] * 2
    assert "overflowed its halved beam" in str(ei.value)
    assert [(s["tier"], s["action"]) for s in steps
            if s["tier"] != "witness"] == [
        ("device", "packed-fallback"), ("device", "fall-through"),
        ("dispatch", "retry-halved")]


def test_witness_fault_leaves_the_verdict_to_the_bfs(monkeypatch):
    """JEPSEN_WGL_FAULT=witness: the frontier BFS settles the check."""
    h = random_register_history(300, procs=3, info_rate=0.02, seed=5)
    monkeypatch.setenv(degrade.FAULT_ENV, "witness")
    out = Linearizable(cas_register(), device="cpu").check({}, h, {})
    assert (out["valid"], out["algorithm"]) == (True, "wgl-tpu")
    assert [s["action"] for s in out["degradations"]] == [
        "packed-fallback", "retry-halved", "fall-through"]


def test_stream_and_batched_faults_fall_through(monkeypatch):
    bad = {1}
    h = history([o.replace(value=kv(f"k{i}", o.value)) for i in range(4)
                 for o in random_register_history(40, procs=3,
                                                  info_rate=0.0, seed=i,
                                                  bad=i in bad)])
    monkeypatch.setenv(degrade.FAULT_ENV, "stream,batched")
    out = IndependentChecker(Linearizable(cas_register(), device="cpu"),
                             device="cpu").check({}, h, {})
    assert out["valid"] is False and out["failures"] == ["k1"]
    steps = [(s["tier"], s["action"]) for s in out["degradations"]]
    # The batched BFS sheds its packed lanes, then, at its narrowest
    # beam (32), takes no halving.
    assert steps == [("stream", "fall-through"),
                     ("batched", "packed-fallback"),
                     ("batched", "fall-through")]
    # The batched BFS left its keys "unknown": the exact CPU settle
    # decides them, on the ladder's last tier as in the reference.
    assert out["tiers"]["cpu-settled"] == 3


def test_all_faults_raise_after_the_halved_retry(monkeypatch):
    """The reference settles this check on its CPU engine
    ("wgl-tpu+cpu-fallback"); the port retries the device search once
    at half size and raises, with the card probe's result."""
    h = random_register_history(300, procs=3, info_rate=0.02, seed=5)
    monkeypatch.setenv(degrade.FAULT_ENV, "all")
    with degrade.capture() as steps:
        with pytest.raises(degrade.CardExhausted) as ei:
            Linearizable(cas_register(), time_limit_s=60.0,
                         device="cpu").check({}, h, {})
    assert ei.value.probe["detail"].startswith("not probed")
    assert "card probe" in str(ei.value)
    once = [("witness", "packed-fallback"), ("witness", "retry-halved"),
            ("witness", "fall-through"), ("device", "packed-fallback"),
            ("device", "retry-halved"), ("device", "fall-through")]
    assert [(s["tier"], s["action"]) for s in steps] == (
        once + [("dispatch", "retry-halved")] + once)
    assert telemetry.counter_value("wgl.plan.execute") == 1


def test_probe_card_reports_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe would find it")
    p = degrade.probe_card(timeout_s=120.0)
    assert p["ok"] is False and p["name"] is None
    assert p["detail"].startswith("probe exit")


def test_probe_card_times_out(monkeypatch):
    import subprocess

    def slow(*a, **k):
        raise subprocess.TimeoutExpired(cmd="probe", timeout=k["timeout"])

    monkeypatch.setattr(subprocess, "run", slow)
    assert degrade.probe_card(timeout_s=0.5) == {
        "ok": False, "name": None, "detail": "probe timed out after 0.5 s"}


def test_a_kernel_failure_is_never_degraded(monkeypatch):
    def failing(*a, **k):
        raise KernelLaunchError("witness_sweep launch failed: out of memory")

    monkeypatch.setattr(wgl_witness, "sweep", failing)
    packed, pm = _small_packed()
    with degrade.capture() as steps:
        with pytest.raises(KernelLaunchError):
            wgl_witness.check_wgl_witness(packed, pm, device="cpu")
    assert steps == []
