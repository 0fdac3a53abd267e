"""The port's checkerd federation on the CPU: the router
(checkerd/router.py), the streamed upload (streaming/remote.py) and the
`checkerd` / `checkerd-router` subcommands.

tests/test_federation.py and tests/test_streaming.py's two `RemoteFeed`
cases run through `jepsen_tpu_torch` (tests/torch_ported.py), against
port daemons and routers started here with `device="cpu"` (a ported
file's fixtures are not collected, so the two it uses are rewritten
below).  Then what the port must hold on its own:

* a ticket journal written by the reference's router (in front of a
  port daemon) reopens in the port's router: the finished ticket polls
  to the journaled bytes, the unfinished one is re-placed and polls to
  the same verdict; and the other way round;
* a streaming run with a checkerd address mirrors its ops through
  `maybe_session`'s feed and RemoteChecker consumes that ticket; a
  device fault while the feed is built raises, any other error only
  drops the feed;
* `jepsen checkerd --device cpu` and `jepsen checkerd-router` run as
  processes and serve a RemoteChecker with the in-process verdicts and
  the router's `/metrics`; `checkerd` with no card exits 254.

Every daemon listens on an ephemeral port and every wait has its own
time limit.
"""

import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

import torch_ported
from conftest import free_port

from jepsen_tpu_torch.checkerd.router import Router, make_router_server
from jepsen_tpu_torch.checkerd.server import make_server

import test_federation as REF_FED  # noqa: E402 — the reference's helpers

FED = torch_ported.load("test_federation")
STREAM = torch_ported.load("test_streaming")
STREAM_CASES = ["test_streamed_upload_verdict_parity",
                "test_commit_with_diverged_keys_dies"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several test processes at once,
    and a daemon's checks run under budgets."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return t


def _stop_daemon(srv, t=None):
    srv.shutdown()
    srv.server_close()
    srv.scheduler.stop()
    if t is not None:
        t.join(timeout=5)


@pytest.fixture()
def router_pair():
    """test_federation.py's fixture on the port: two CPU daemons with a
    2 s batch window behind one router."""
    d1 = make_server("127.0.0.1", 0, batch_window_s=2.0, device="cpu")
    d2 = make_server("127.0.0.1", 0, batch_window_s=2.0, device="cpu")
    threads = [_serve(d1), _serve(d2)]
    addrs = [f"127.0.0.1:{d.server_address[1]}" for d in (d1, d2)]
    rt = make_router_server("127.0.0.1", 0, daemons=addrs,
                            probe_interval_s=0.2)
    threads.append(_serve(rt))
    raddr = f"127.0.0.1:{rt.server_address[1]}"
    stopped = []
    try:
        yield (d1, d2), addrs, rt, raddr, stopped
    finally:
        rt.shutdown()
        rt.server_close()
        rt.router.stop()
        for d in (d1, d2):
            if d not in stopped:
                _stop_daemon(d)
        for th in threads:
            th.join(timeout=5)


@pytest.fixture()
def daemon():
    """test_streaming.py's fixture on the port: one CPU daemon."""
    srv = make_server("127.0.0.1", 0, batch_window_s=0.0, device="cpu")
    t = _serve(srv)
    try:
        yield srv, f"127.0.0.1:{srv.server_address[1]}"
    finally:
        _stop_daemon(srv, t)


@pytest.mark.parametrize("case", torch_ported.cases(FED))
def test_federation_cases_through_the_port(case, request):
    torch_ported.run(FED, case, request)


@pytest.mark.parametrize("case", STREAM_CASES)
def test_remote_feed_cases_through_the_port(case, request):
    torch_ported.run(STREAM, case, request)


def test_federation_case_list():
    """Every non-slow case of test_federation.py runs; its slow one is
    tools/federation_smoke.py (the reference's processes)."""
    assert len(torch_ported.cases(FED)) == 9
    assert set(STREAM_CASES) <= set(torch_ported.cases(STREAM))


# -- journals across packages ------------------------------------------------


def _ref_router_run(path, daemon_addr, prefix):
    """The reference's router, journaling into `path`, in front of a
    port daemon: one finished ticket (by the reference's RemoteChecker)
    and an unfinished copy of its frames journaled as "t-open".
    Returns the finished ticket and its payload."""
    from jepsen_tpu.checker.linearizable import Linearizable as RefLin
    from jepsen_tpu.checkerd import router as ref_router
    from jepsen_tpu.checkerd.client import RemoteChecker as RefRemote
    from jepsen_tpu.checkerd.journal import frames_to_record
    from jepsen_tpu.models.registers import Register as RefRegister
    from jepsen_tpu.parallel.independent import \
        IndependentChecker as RefIndependent

    rt = ref_router.make_router_server("127.0.0.1", 0, daemons=[daemon_addr],
                                       probe_interval_s=0.2, queue_path=path)
    t = _serve(rt)
    try:
        raddr = f"127.0.0.1:{rt.server_address[1]}"
        res = RefRemote(RefIndependent(RefLin(RefRegister())), raddr,
                        run_id=prefix, fallback=False).check(
            {"name": prefix}, REF_FED._mixed_history(prefix), {})
        assert res["valid"] is False, res
        (ticket, rec), = rt.router._tickets.items()
        rt.router.journal.record_submit("t-open", {
            "run": rec.run, "tenant": rec.tenant, "spec-key": rec.spec_key,
            "frames": frames_to_record(rec.frames)})
        return ticket, rec.result
    finally:
        rt.shutdown()
        rt.server_close()
        rt.router.stop()
        t.join(timeout=5)


def _poll_until(router, ticket, deadline_s=60.0):
    from jepsen_tpu_torch.checkerd.protocol import F_PENDING, F_RESULT

    t0 = time.monotonic()
    while True:
        ftype, payload = router.poll(ticket)
        if ftype == F_RESULT:
            return payload
        assert ftype == F_PENDING, (ftype, payload)
        assert time.monotonic() - t0 < deadline_s, "ticket never finished"
        time.sleep(0.05)


def test_port_router_serves_the_reference_routers_journal(tmp_path,
                                                          daemon):
    """The port's router reopens a journal the reference's router wrote:
    the finished ticket answers with the journaled result, and the
    unfinished one is re-placed on a port daemon and polls to the same
    per-key verdicts."""
    _, addr = daemon
    path = str(tmp_path / "router.queue")
    ticket, payload = _ref_router_run(path, addr, "xj")
    r = Router([addr], queue_path=path, probe_interval_s=0.2)
    try:
        assert {ticket, "t-open"} <= set(r._tickets)
        assert r.n_replayed == 1
        assert _poll_until(r, ticket) == payload
        again = _poll_until(r, "t-open")
        assert [k["valid"] for k in again["key-results"]] == \
            [k["valid"] for k in payload["key-results"]] == [True, False]
    finally:
        r.stop()


def test_reference_router_serves_the_port_routers_journal(tmp_path,
                                                          router_pair):
    """And the other way: a ticket the port's router finished and
    journaled answers from the reference's router after a restart."""
    from jepsen_tpu.checkerd.protocol import F_RESULT as REF_RESULT
    from jepsen_tpu.checkerd.router import Router as RefRouter
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.checkerd.client import RemoteChecker
    from jepsen_tpu_torch.models.registers import Register
    from jepsen_tpu_torch.parallel.independent import IndependentChecker

    _, addrs, _, _, _ = router_pair
    path = str(tmp_path / "router.queue")
    rt = make_router_server("127.0.0.1", 0, daemons=addrs,
                            probe_interval_s=0.2, queue_path=path)
    t = _serve(rt)
    try:
        res = RemoteChecker(
            IndependentChecker(Linearizable(Register(), device="cpu"),
                               device="cpu"),
            f"127.0.0.1:{rt.server_address[1]}", run_id="pj",
            fallback=False).check({"name": "pj"},
                                  FED._mixed_history("pj"), {})
        assert res["valid"] is False
        (ticket, rec), = rt.router._tickets.items()
        payload = rec.result
    finally:
        rt.shutdown()
        rt.server_close()
        rt.router.stop()
        t.join(timeout=5)
    ref = RefRouter(addrs, queue_path=path, probe_interval_s=0.2)
    try:
        assert ref.poll(ticket) == (REF_RESULT, payload)
    finally:
        ref.stop()


# -- the streaming session's feed ---------------------------------------------


def _stream_test(addr, keys=4):
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models.registers import Register
    from jepsen_tpu_torch.parallel.independent import IndependentChecker

    lin = Linearizable(Register(), device="cpu")
    return {"name": "feed-run", "checkerd": addr, "model": Register(),
            "checker": IndependentChecker(lin, device="cpu")}


def test_maybe_session_streams_to_the_daemon_and_the_ticket_is_used(
        daemon):
    """A streaming run with a checkerd address: the session mirrors
    every routed op, commits at finish, and RemoteChecker takes the
    streamed ticket instead of uploading the history again; the verdicts
    are the in-process ones."""
    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch.checkerd.client import wrap_remote
    from jepsen_tpu_torch.streaming import maybe_session

    _, addr = daemon
    test = _stream_test(addr)
    sess = maybe_session(test, device="cpu")
    assert sess is not None and sess._remote is not None
    h = STREAM._keyed_mixed_history(6, 8, bad_every=3, seed=7)
    for op in h:
        sess.feed(op)
    st = sess.finish()
    assert st["remote"]["ops-sent"] > 0 and "ticket" in st["remote"], st
    test["streaming-session"] = sess
    was = telemetry.enabled()
    telemetry.enable(True)
    try:
        before = telemetry.counter_value("checkerd.stream-ticket")
        remote = wrap_remote(test["checker"], addr, run_id="feed-run").check(
            test, h, {})
        assert telemetry.counter_value("checkerd.stream-ticket") == before + 1
    finally:
        telemetry.enable(was)
    local = test["checker"].check({}, h, {})
    assert {k: r["valid"] for k, r in remote["results"].items()} == \
        {k: r["valid"] for k, r in local["results"].items()}


@pytest.mark.parametrize("device_fault", [True, False])
def test_maybe_session_narrows_feed_errors(daemon, monkeypatch,
                                           device_fault):
    """The reference drops the feed on any error; the port re-raises a
    device fault and drops the feed on anything else."""
    from jepsen_tpu_torch.ops.degrade import DeviceUnavailable
    from jepsen_tpu_torch.streaming import maybe_session, remote

    def boom(*a, **kw):
        raise (DeviceUnavailable("no card") if device_fault
               else ConnectionError("daemon gone"))

    monkeypatch.setattr(remote, "remote_feed_for", boom)
    test = _stream_test(daemon[1])
    if device_fault:
        with pytest.raises(DeviceUnavailable):
            maybe_session(test, device="cpu")
    else:
        sess = maybe_session(test, device="cpu")
        try:
            assert sess is not None and sess._remote is None
        finally:
            sess.finish()


# -- the subcommands as processes --------------------------------------------


def _wait_port(port, proc, timeout_s=60.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        assert proc.poll() is None, proc.stdout.read()
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1.0):
                return
        except OSError:
            time.sleep(0.1)
    raise AssertionError(f"port {port} never listened")


def test_checkerd_and_router_subcommands_serve(tmp_path):
    """`kvdb checkerd --device cpu` and `kvdb checkerd-router` as
    processes: a RemoteChecker through the router gets the in-process
    verdicts, and the router's /metrics shows its gauges."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.checkerd.client import RemoteChecker, fetch_stats
    from jepsen_tpu_torch.models.registers import Register
    from jepsen_tpu_torch.parallel.independent import IndependentChecker

    dport, rport, mport = free_port(), free_port(), free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    suite = [sys.executable, "-m", "jepsen_tpu_torch.suites.kvdb"]
    procs = [subprocess.Popen(
        suite + ["checkerd", "--device", "cpu", "--host", "127.0.0.1",
                 "--port", str(dport), "--queue", str(tmp_path / "d.queue")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)]
    try:
        _wait_port(dport, procs[0])
        procs.append(subprocess.Popen(
            suite + ["checkerd-router", "--host", "127.0.0.1", "--port",
                     str(rport), "--daemon", f"127.0.0.1:{dport}",
                     "--metrics-port", str(mport)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        _wait_port(rport, procs[1])
        chk = IndependentChecker(Linearizable(Register(), device="cpu"),
                                 device="cpu")
        h = FED._mixed_history("cli")
        res = RemoteChecker(chk, f"127.0.0.1:{rport}", run_id="cli",
                            fallback=False).check({"name": "cli"}, h, {})
        local = chk.check({}, h, {})
        assert {k: r["valid"] for k, r in res["results"].items()} == \
            {k: r["valid"] for k, r in local["results"].items()}
        st = fetch_stats(f"127.0.0.1:{rport}")
        assert st["router"] is True and st["results"] == 1
        daemon_st = st["daemons"][f"127.0.0.1:{dport}"]
        assert daemon_st["devices"]
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{mport}/metrics", timeout=10).read().decode()
        for family in ("jepsen_router_daemons", "jepsen_router_failovers",
                       "jepsen_router_results"):
            assert family in body, family
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)


def test_checkerd_subcommand_without_a_card_exits_254(monkeypatch):
    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.suites import kvdb

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kvdb.main(["checkerd", "--port", "0"]) == cli.EXIT_ERROR


def test_router_subcommand_needs_a_daemon():
    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.suites import kvdb

    assert kvdb.main(["checkerd-router", "--port", "0"]) == cli.EXIT_UNKNOWN
