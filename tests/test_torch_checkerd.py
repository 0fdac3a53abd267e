"""The port's checker daemon (jepsen_tpu_torch.checkerd) on the CPU.

Every case of tests/test_checkerd.py against a port daemon started with
`device="cpu"`: the wire protocol (store-block frames, the packed
columnar bytes, byte for byte the reference's), verdict parity of a
RemoteChecker round trip with the in-process checker (and the JAX
package's as the oracle), cross-run cohort merging, per-request budgets
(a blown budget is "unknown", never a wrong verdict), the in-process
fallback when no daemon listens, and the plan-memo warm start.  Then
what the port adds or must hold on its own:

* interoperability: the reference's client against a port daemon, and
  the port's client against a reference daemon, with equal results;
* the queue journal: a daemon stopped with an unfinished ticket
  finishes it after a restart, and either package replays the other's
  journal;
* a faulted cohort (JEPSEN_WGL_FAULT) ends with the error result, never
  a CPU verdict; the cohort after a blown budget is correct while the
  abandoned one may still run;
* a daemon asked for CUDA without a card raises at start; STATS names
  the device; `/metrics` parses with the SLO families.

Every daemon listens on `conftest.free_port()` and every wait has its
own time limit.
"""

import io
import json
import threading
import time
import urllib.request

import pytest
import torch

from conftest import free_port

import jepsen_tpu.checkerd.client as ref_client
import jepsen_tpu.checkerd.server as ref_server
import jepsen_tpu.parallel.independent as ref_ind
from jepsen_tpu.checker.linearizable import Linearizable as RefLinearizable
from jepsen_tpu.history.core import History as RefHistory
from jepsen_tpu.history.packed import pack_history as ref_pack_history
from jepsen_tpu.history.packed import packed_to_bytes as ref_packed_to_bytes
from jepsen_tpu.models.registers import Register as RefRegister
from jepsen_tpu.parallel.independent import KV as RefKV
from jepsen_tpu.parallel.independent import \
    IndependentChecker as RefIndependentChecker
from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch.checker import Linearizable
from jepsen_tpu_torch.checkerd import journal as qjournal
from jepsen_tpu_torch.checkerd.client import (CheckerdClient, RemoteChecker,
                                              wrap_remote)
from jepsen_tpu_torch.checkerd.protocol import (F_PACKED, F_SUBMIT,
                                                ProtocolError,
                                                model_from_spec,
                                                model_to_spec, pack_key_frame,
                                                read_frame, unpack_key_frame,
                                                write_frame)
from jepsen_tpu_torch.checkerd.scheduler import Request, Scheduler
from jepsen_tpu_torch.checkerd.server import make_server
from jepsen_tpu_torch.history.core import History
from jepsen_tpu_torch.history.packed import (PACKED_COLUMNS, pack_history,
                                             packed_from_bytes,
                                             packed_to_bytes)
from jepsen_tpu_torch.models.registers import CASRegister, Register
from jepsen_tpu_torch.ops import degrade
from jepsen_tpu_torch.parallel import independent as pind
from jepsen_tpu_torch.parallel.independent import KV, IndependentChecker

#: Seconds any one daemon round trip may take in these tests.
WAIT_S = 60.0


@pytest.fixture(autouse=True, params=["0", None], ids=["wide", "packed"])
def one_torch_thread(request, monkeypatch):
    """One torch thread (the suite runs several test processes at once),
    no fault injection, the reference on its own ladder, and both
    packages with wide member bitsets (JEPSEN_WGL_PACKED=0), then at
    the default, packed lanes."""
    monkeypatch.delenv(degrade.FAULT_ENV, raising=False)
    if request.param is None:
        monkeypatch.delenv("JEPSEN_WGL_PACKED", raising=False)
    else:
        monkeypatch.setenv("JEPSEN_WGL_PACKED", request.param)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# History builders


def _reg_ops(key, pairs, start_index=0, process=0, kv=KV):
    """[(written, read-back), ...] -> op dicts for one register key."""
    ops = []
    i = start_index
    for wrote, read in pairs:
        for typ, f, v in (("invoke", "write", wrote), ("ok", "write", wrote),
                          ("invoke", "read", None), ("ok", "read", read)):
            ops.append({"index": i, "type": typ, "process": process,
                        "f": f, "value": kv(key, v), "time": i})
            i += 1
    return ops


def _mixed_ops(kv=KV):
    """Key "good" linearizable, key "bad" reads a never-written value."""
    ops = _reg_ops("good", [(1, 1), (2, 2)], kv=kv)
    return ops + _reg_ops("bad", [(1, 7)], start_index=len(ops), process=1,
                          kv=kv)


def _mixed_history():
    return History(_mixed_ops())


def _in_process():
    return IndependentChecker(Linearizable(Register(), device="cpu"),
                              device="cpu")


def _reference_in_process():
    return RefIndependentChecker(RefLinearizable(RefRegister()))


class _Daemon:
    """A port daemon on a free port, served from a thread; `stop()`
    shuts it down and joins within the test's limit."""

    def __init__(self, **kw):
        kw.setdefault("device", "cpu")
        kw.setdefault("batch_window_s", 0.0)
        self.srv = make_server("127.0.0.1", free_port(), **kw)
        self.addr = f"127.0.0.1:{self.srv.server_address[1]}"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def stop(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.srv.scheduler.stop()
        self.thread.join(timeout=5)
        assert not self.thread.is_alive()


@pytest.fixture()
def daemon():
    d = _Daemon()
    try:
        yield d.srv, d.addr
    finally:
        d.stop()


def _run_threads(threads, limit=WAIT_S):
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=limit)
    assert not any(th.is_alive() for th in threads)


# ---------------------------------------------------------------------
# Protocol plumbing (no daemon needed)


def test_frame_roundtrip_json_and_binary():
    buf = io.BytesIO()
    write_frame(buf, F_SUBMIT, {"run": "r1", "n-keys": 2})
    write_frame(buf, F_PACKED, b"\x00\x01binary\xff")
    write_frame(buf, F_SUBMIT, {"empty": None})
    buf.seek(0)
    assert read_frame(buf) == (F_SUBMIT, {"run": "r1", "n-keys": 2})
    assert read_frame(buf) == (F_PACKED, b"\x00\x01binary\xff")
    assert read_frame(buf) == (F_SUBMIT, {"empty": None})
    assert read_frame(buf) is None  # clean EOF


def test_frame_crc_and_truncation_rejected():
    buf = io.BytesIO()
    write_frame(buf, F_SUBMIT, {"run": "r1"})
    raw = bytearray(buf.getvalue())
    raw[-1] ^= 0xFF  # corrupt payload -> CRC mismatch
    with pytest.raises(ProtocolError):
        read_frame(io.BytesIO(bytes(raw)))
    with pytest.raises(ProtocolError):
        read_frame(io.BytesIO(buf.getvalue()[:-3]))  # torn frame


def test_key_frame_roundtrip():
    blob = pack_key_frame(42, b"payload")
    assert unpack_key_frame(blob) == (42, b"payload")


def test_packed_bytes_roundtrip():
    """Round trip, and the bytes equal the reference's for the same
    history, so either package reads the other's frames."""
    ops = _reg_ops("k", [(1, 1), (2, 3)])
    p = pack_history(History(ops), Register().packed().encode)
    blob = packed_to_bytes(p)
    q = packed_from_bytes(blob)
    assert q.n == p.n
    for name, _ in PACKED_COLUMNS:
        assert (getattr(q, name) == getattr(p, name)).all(), name
    ref_p = ref_pack_history(RefHistory(_reg_ops("k", [(1, 1), (2, 3)],
                                                 kv=RefKV)),
                             RefRegister().packed().encode)
    assert ref_packed_to_bytes(ref_p) == blob


def test_packed_bytes_validation():
    p = pack_history(History(_reg_ops("k", [(1, 1)])),
                     Register().packed().encode)
    blob = packed_to_bytes(p)
    with pytest.raises(ValueError):
        packed_from_bytes(b"XXXX" + blob[4:])  # bad magic
    with pytest.raises(ValueError):
        packed_from_bytes(blob[:-1])  # torn column


def test_model_spec_roundtrip():
    for model in (Register(), Register(3), CASRegister(), CASRegister(5)):
        spec = model_to_spec(model)
        assert spec is not None
        back = model_from_spec(spec)
        assert type(back) is type(model)
        assert model_to_spec(back) == spec
    with pytest.raises(ValueError):
        model_from_spec({"type": "no-such-model"})


def test_unspecable_model_returns_none():
    class Weird(Register):
        pass

    assert model_to_spec(Weird()) is None


# ---------------------------------------------------------------------
# Daemon round trips


def test_remote_verdict_parity(daemon):
    """Daemon verdicts identical to in-process, and to the JAX
    package's in-process checker."""
    _, addr = daemon
    h = _mixed_history()
    test = {"name": "parity"}
    inproc = _in_process().check(test, h, {})
    ref = _reference_in_process().check(test, RefHistory(_mixed_ops(RefKV)),
                                        {})
    remote = RemoteChecker(_in_process(), addr, run_id="parity").check(
        test, h, {})
    assert remote["valid"] == inproc["valid"] == ref["valid"] is False
    assert sorted(remote["results"]) == sorted(inproc["results"])
    for k in inproc["results"]:
        assert remote["results"][k]["valid"] == \
            inproc["results"][k]["valid"] == ref["results"][k]["valid"], k
    assert remote["checkerd"]["merged-runs"] == 1
    assert "bad" in remote["failures"]


def test_packed_wire_parity(daemon):
    """Binary transport: pre-packed columns yield the same verdicts."""
    _, addr = daemon
    pm = Register().packed()
    good = pack_history(History(_reg_ops("g", [(1, 1)])), pm.encode)
    bad = pack_history(History(_reg_ops("b", [(1, 9)])), pm.encode)
    with CheckerdClient(addr) as c:
        ticket = c.submit_packed(
            "packed-run", model_to_spec(Register()), [good, bad])
        res = c.wait(ticket, deadline_s=WAIT_S)
    krs = res["key-results"]
    assert [kr["valid"] for kr in krs] == [True, False]


def test_two_runs_merge_into_one_cohort():
    """Two concurrent runs inside one batch window settle as one
    cohort."""
    d = _Daemon(batch_window_s=0.6)
    try:
        barrier = threading.Barrier(2, timeout=WAIT_S)
        results = {}

        def run(name):
            h = History(_reg_ops(f"{name}-k", [(1, 1), (2, 2)]))
            rc = RemoteChecker(_in_process(), d.addr, run_id=name,
                               fallback=False)
            barrier.wait()
            results[name] = rc.check({"name": name}, h, {})

        _run_threads([threading.Thread(target=run, args=(n,))
                      for n in ("run-a", "run-b")])
        assert sorted(results) == ["run-a", "run-b"]
        for name, res in results.items():
            assert res["valid"] is True, name
            assert res["checkerd"]["merged-runs"] == 2, name
        with CheckerdClient(d.addr) as c:
            stats = c.stats()
        assert stats["cohorts-merged"] >= 1
        assert stats["merge-ratio"] > 0
        assert set(stats["runs"]) >= {"run-a", "run-b"}
    finally:
        d.stop()


def test_budget_exceeded_returns_unknown(daemon):
    """A blown request budget degrades to unknown, never blocks the
    daemon or returns a fabricated verdict."""
    _, addr = daemon
    res = RemoteChecker(
        _in_process(), addr, run_id="broke", fallback=False,
    ).check({"name": "broke", "checker_budget": 0}, _mixed_history(), {})
    assert res["valid"] == "unknown"
    assert res["checkerd"].get("budget-exceeded")
    for kr in res["results"].values():
        assert kr["valid"] == "unknown"


def test_daemon_down_falls_back_in_process():
    """No daemon listening -> RemoteChecker degrades to the wrapped
    in-process checker and annotates the result."""
    addr = f"127.0.0.1:{free_port()}"  # nothing listening here
    res = RemoteChecker(_in_process(), addr, run_id="lonely").check(
        {"name": "lonely"}, _mixed_history(), {})
    assert res["valid"] is False
    assert "fallback" in res["checkerd"]
    assert "bad" in res["failures"]


def test_daemon_down_without_fallback_is_unknown():
    addr = f"127.0.0.1:{free_port()}"
    res = RemoteChecker(
        _in_process(), addr, run_id="strict", fallback=False,
    ).check({"name": "strict"}, _mixed_history(), {})
    assert res["valid"] == "unknown"
    assert "checkerd unavailable" in res["error"]


def test_wrap_remote_shapes():
    addr = "127.0.0.1:1"
    assert isinstance(wrap_remote(_in_process(), addr), RemoteChecker)
    assert isinstance(
        wrap_remote(Linearizable(Register(), device="cpu"), addr),
        RemoteChecker)

    class Other:
        def check(self, test, history, opts):
            return {"valid": True}

    other = Other()
    assert wrap_remote(other, addr) is other


# One packing mode: a second instance of this test would find the
# process warm from the first, and its run 1 would time noise.
@pytest.mark.parametrize("one_torch_thread", [None], ids=["packed"],
                         indirect=True)
def test_second_run_rides_the_warm_path(daemon):
    """Same workload twice: run 2 reuses the daemon's cached model and
    settle memo, so its server-side check time beats run 1's."""
    _, addr = daemon
    pind.clear_settle_memo()
    h = _mixed_history()
    t1 = RemoteChecker(_in_process(), addr, run_id="cold",
                       fallback=False).check({"name": "cold"}, h, {})
    t2 = RemoteChecker(_in_process(), addr, run_id="warm",
                       fallback=False).check({"name": "warm"}, h, {})
    assert t2["valid"] == t1["valid"]
    assert t2["checkerd"]["check-s"] < t1["checkerd"]["check-s"]


def test_restarted_daemon_warm_starts_from_plan_cache(tmp_path):
    """With a plan-cache dir the daemon journals settled plan-node
    verdicts; a restarted daemon serves the byte-identical resubmission
    from the journal, and a budget change misses."""
    from jepsen_tpu_torch.plan import cache as plan_cache

    h = _mixed_history()

    def one_round(run_id, time_limit_s=None):
        plan_cache.reset_for_tests()
        d = _Daemon(plan_cache_dir=str(tmp_path))
        try:
            base = IndependentChecker(
                Linearizable(Register(), time_limit_s=time_limit_s,
                             device="cpu"), device="cpu")
            res = RemoteChecker(base, d.addr, run_id=run_id,
                                fallback=False).check({"name": run_id}, h,
                                                      {})
            return res, d.srv.scheduler.stats()["plan"]
        finally:
            d.stop()
            plan_cache.reset_for_tests()

    pind.clear_settle_memo()
    r1, p1 = one_round("cold")
    assert r1["valid"] is False
    memo1 = p1["cache"]["memo"]
    assert memo1["puts"] >= 1
    pind.clear_settle_memo()
    r2, p2 = one_round("warm")  # fresh scheduler, same directory
    assert r2["valid"] is False
    memo2 = p2["cache"]["memo"]
    assert memo2["loaded"] >= memo1["puts"]
    assert memo2["hits"] >= 1
    for k in r1["results"]:
        assert r2["results"][k]["valid"] == r1["results"][k]["valid"]
    pind.clear_settle_memo()
    _, p3 = one_round("budget-change", time_limit_s=7.25)
    assert p3["cache"]["memo"]["hits"] == 0


# ---------------------------------------------------------------------
# Interoperability: either package's client, either package's daemon


def test_reference_client_against_a_port_daemon(daemon):
    _, addr = daemon
    h = RefHistory(_mixed_ops(RefKV))
    ref_ind.clear_settle_memo()
    want = _reference_in_process().check({"name": "x"}, h, {})
    got = ref_client.RemoteChecker(
        _reference_in_process(), addr, run_id="ref-client",
        fallback=False).check({"name": "ref-client"}, h, {})
    assert "fallback" not in got["checkerd"]
    assert got["valid"] == want["valid"] is False
    assert {k: r["valid"] for k, r in got["results"].items()} == \
        {k: r["valid"] for k, r in want["results"].items()}
    # Packed frames from the reference's client decode in the port.
    pm = RefRegister().packed()
    packs = [ref_pack_history(RefHistory(_reg_ops(k, [(1, v)], kv=RefKV)),
                              pm.encode) for k, v in (("g", 1), ("b", 9))]
    with ref_client.CheckerdClient(addr) as c:
        ticket = c.submit_packed("ref-packed",
                                 {"type": "register", "value": None}, packs)
        res = c.wait(ticket, deadline_s=WAIT_S)
    assert [kr["valid"] for kr in res["key-results"]] == [True, False]


def test_port_client_against_a_reference_daemon():
    srv = ref_server.make_server("127.0.0.1", free_port(), batch_window_s=0.0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    addr = f"127.0.0.1:{srv.server_address[1]}"
    try:
        h = _mixed_history()
        want = _in_process().check({"name": "x"}, h, {})
        got = RemoteChecker(_in_process(), addr, run_id="port-client",
                            fallback=False).check({"name": "port-client"},
                                                  h, {})
        assert "fallback" not in got["checkerd"]
        assert got["valid"] == want["valid"] is False
        assert {k: r["valid"] for k, r in got["results"].items()} == \
            {k: r["valid"] for k, r in want["results"].items()}
        pm = Register().packed()
        packs = [pack_history(History(_reg_ops(k, [(1, v)])), pm.encode)
                 for k, v in (("g", 1), ("b", 9))]
        with CheckerdClient(addr) as c:
            ticket = c.submit_packed("port-packed",
                                     model_to_spec(Register()), packs)
            res = c.wait(ticket, deadline_s=WAIT_S)
        assert [kr["valid"] for kr in res["key-results"]] == [True, False]
    finally:
        srv.shutdown()
        srv.server_close()
        srv.scheduler.stop()
        t.join(timeout=5)


# ---------------------------------------------------------------------
# The queue journal


def _request(run, ops):
    subs = {0: History(ops, reindex=False)}
    return Request(run=run, model_spec=model_to_spec(Register()),
                   n_keys=1, subs=subs)


def test_restart_replays_an_unfinished_ticket(tmp_path):
    """A daemon stopped with a journaled, unfinished ticket finishes it
    after a restart, under the same ticket id, with the in-process
    verdict."""
    path = str(tmp_path / qjournal.QUEUE_FILE)
    ops = _reg_ops("bad", [(1, 7)])
    want = _in_process().check({}, History(ops), {})["valid"]
    # A journal as a daemon leaves it when it dies after TICKET and
    # before the verdict.
    j = qjournal.QueueJournal(path)
    j.record_submit("t-unfinished", qjournal.request_to_record(
        _request("journaled", ops)))
    j.close()
    d = _Daemon(queue_path=path)
    try:
        with CheckerdClient(d.addr) as c:
            _, payload = c.poll("t-unfinished")
            deadline = time.monotonic() + WAIT_S
            while payload.get("key-results") is None:
                assert time.monotonic() < deadline
                time.sleep(0.05)
                _, payload = c.poll("t-unfinished")
        assert payload["valid"] == want is False
        assert d.srv.scheduler.stats()["replayed"] == 1
    finally:
        d.stop()
    # Finished now: a second restart answers from the journal.
    assert qjournal.QueueJournal(path).unfinished() == {}


def test_journals_replay_in_either_package(tmp_path):
    """A submit record written by either package's journal rebuilds in
    the other's, with the same ops and packed columns."""
    from jepsen_tpu.checkerd import journal as ref_journal

    # Op values as they come back from JSON: lists.
    ops = _reg_ops("k", [(1, 1)], kv=lambda k, v: [k, v])
    p = pack_history(History(_reg_ops("k", [(1, 1)])),
                     Register().packed().encode)
    req = _request("x", ops)
    req.packs = {1: p}
    port_path = str(tmp_path / "port.queue")
    j = qjournal.QueueJournal(port_path)
    j.record_submit("t1", qjournal.request_to_record(req))
    j.close()
    ref_rec = ref_journal.QueueJournal(port_path).unfinished()["t1"]
    back = ref_journal.request_from_record(ref_rec)
    assert [o.to_dict() for o in back.subs[0]] == ops
    assert ref_packed_to_bytes(back.packs[1]) == packed_to_bytes(p)
    ref_path = str(tmp_path / "ref.queue")
    rj = ref_journal.QueueJournal(ref_path)
    rj.record_submit("t2", ref_rec)
    rj.close()
    mine = qjournal.request_from_record(
        qjournal.QueueJournal(ref_path).unfinished()["t2"])
    assert mine.subs[0].to_dicts() == ops
    assert packed_to_bytes(mine.packs[1]) == packed_to_bytes(p)


# ---------------------------------------------------------------------
# No fallback hides the device; budgets; start-up; STATS and /metrics


def test_faulted_cohort_returns_the_error_result(daemon, monkeypatch):
    """JEPSEN_WGL_FAULT=all: every device tier runs out, the halved
    retry raises CardExhausted, and the cohort ends with the reference's
    error result — "unknown" naming the fault — never a CPU verdict."""
    _, addr = daemon
    monkeypatch.setenv(degrade.FAULT_ENV, "all")
    monkeypatch.setattr(degrade, "probe_card",
                        lambda timeout_s=60.0: {"ok": False, "name": None,
                                                "detail": "test"})
    # A key past the plan's 2,000-op long-key bound takes the per-key
    # device ladder, whose halved retry raises when it runs out again.
    from jepsen_tpu_torch.utils.histgen import random_register_history

    h = History([o.replace(value=KV("k", o.value)) for o in
                 random_register_history(4000, procs=3, info_rate=0.02,
                                         seed=5)])
    pind.clear_settle_memo()
    base = IndependentChecker(Linearizable(CASRegister(), device="cpu"),
                              device="cpu")
    res = RemoteChecker(base, addr, run_id="faulty",
                        fallback=False).check({"name": "faulty"}, h, {})
    assert res["valid"] == "unknown"
    assert "checkerd cohort failed" in res["checkerd"]["error"]
    assert "CardExhausted" in res["checkerd"]["error"]
    assert all(r["valid"] == "unknown" for r in res["results"].values())


def test_next_cohort_is_right_after_an_abandoned_one(monkeypatch):
    """The budget timeout abandons a cohort thread that may still be
    checking; the next cohort, started while it runs, gets its own
    right verdicts, and exact_float32's lock (which the abandoned thread
    holds an entry of) is sound once it ends: the caller's TF32 setting
    comes back."""
    from jepsen_tpu_torch.parallel import independent as ind_mod

    release = threading.Event()
    parked = threading.Event()
    real_check = ind_mod.IndependentChecker._check_linearizable

    def slow(self, test, subs, opts, dev, tiers):
        # The "slow" run's checker (time limit 1.5 s) parks inside an
        # exact_float32 block until the test releases it.
        if getattr(self.base, "time_limit_s", None) == 1.5:
            with _device.exact_float32():
                parked.set()
                release.wait(WAIT_S)
        return real_check(self, test, subs, opts, dev, tiers)

    monkeypatch.setattr(ind_mod.IndependentChecker, "_check_linearizable",
                        slow)
    before = _device._tf32_swap(None)
    _device._tf32_swap(before)
    d = _Daemon()
    try:
        h = _mixed_history()
        slow_base = IndependentChecker(
            Linearizable(Register(), time_limit_s=1.5, device="cpu"),
            device="cpu")
        blown = RemoteChecker(slow_base, d.addr, run_id="slow",
                              fallback=False).check(
            {"name": "slow", "checker_budget": 0.3}, h, {})
        assert blown["valid"] == "unknown"
        assert blown["checkerd"]["budget-exceeded"]
        assert parked.is_set() and _device._tf32_depth == 1
        pind.clear_settle_memo()
        want = _in_process().check({}, h, {})
        got = RemoteChecker(_in_process(), d.addr, run_id="next",
                            fallback=False).check({"name": "next"}, h, {})
        assert got["valid"] == want["valid"] is False
        assert {k: r["valid"] for k, r in got["results"].items()} == \
            {k: r["valid"] for k, r in want["results"].items()}
        release.set()
        deadline = time.monotonic() + WAIT_S
        while _device._tf32_depth:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert _device._tf32_swap(before) == before
    finally:
        release.set()
        d.stop()


def test_daemon_without_a_card_raises_at_start(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(_device.DeviceUnavailable):
        make_server("127.0.0.1", free_port(), device="cuda")
    assert degrade.chip_state() == "absent"
    with pytest.raises(_device.DeviceUnavailable):
        Scheduler(device="cuda")


def test_stats_and_metrics(daemon, tmp_path):
    srv, addr = daemon
    RemoteChecker(_in_process(), addr, run_id="m", fallback=False).check(
        {"name": "m"}, _mixed_history(), {})
    with CheckerdClient(addr) as c:
        st = c.stats()
    assert st["devices"] == {"count": 1, "platform": "cpu", "kind": "cpu"}
    assert st["requests"] >= 1 and st["cohorts"] >= 1
    from jepsen_tpu_torch.checkerd.server import make_metrics_server

    msrv = make_metrics_server(srv.scheduler, "127.0.0.1", free_port())
    t = threading.Thread(target=msrv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{msrv.server_address[1]}/metrics"
        with urllib.request.urlopen(url, timeout=WAIT_S) as r:
            body = r.read().decode()
    finally:
        msrv.shutdown()
        msrv.server_close()
        t.join(timeout=5)
    families = {}
    for line in body.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            families[name] = kind
        elif line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            float(value)  # every sample parses
    assert families["jepsen_checkerd_queue_depth"] == "gauge"
    assert families["jepsen_slo_firing"] == "gauge"
    assert families["jepsen_chip_health"] == "gauge"
    assert 'jepsen_slo_firing{rule="checkerd-queue-depth"} 0' in body
    json.dumps(st)  # STATS is JSON-able
