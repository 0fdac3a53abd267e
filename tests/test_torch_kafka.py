"""The port's Kafka workload (jepsen_tpu_torch/workloads/kafka.py and
kafka_viz.py) against the JAX package's, on the CPU: every case of
tests/test_kafka.py through the port; histories made by the JAX
package's own `workload()` (seeded, every fault mode, rw edges off and
on) analyzed by both packages with equal records; a cyclic history of
more than 256 vertices, whose cycles both packages extract on their
device path; the checker's artifact files; and a whole run through the
port's CLI, re-analyzed from the store."""

import json
import threading
import time

import pytest
import torch

import jepsen_tpu.generator as rgen
import jepsen_tpu.generator.testkit as rtk
import jepsen_tpu.history as rh
import jepsen_tpu.store as rstore
from jepsen_tpu.workloads import kafka as rk
from jepsen_tpu.workloads.kafka_viz import write_artifacts as r_artifacts
from jepsen_tpu_torch import cli, store
from jepsen_tpu_torch import history as ph
from jepsen_tpu_torch.device import DeviceUnavailable
from jepsen_tpu_torch.ops import scc
from jepsen_tpu_torch import workloads
from jepsen_tpu_torch.workloads import kafka as pk
from jepsen_tpu_torch.workloads.kafka_viz import write_artifacts as p_artifacts
import torch_ported
from chip_smoke import kafka_cycle_ops

PORTED = torch_ported.load("test_kafka")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", torch_ported.cases(PORTED))
def test_kafka_cases_through_the_port(case, request):
    torch_ported.run(PORTED, case, request)


# -- seeded histories of the JAX package's workload -----------------------


def reference_history(seed, faults, n_ops=120, keys=3):
    """A history of the JAX package's kafka `workload()`, its generator
    (`limit`ed, then its final polls) run by the JAX package's
    deterministic simulation against the workload's in-memory log, one
    client per process."""
    wl = rk.workload({"seed": seed, "faults": faults, "fault-rate": 0.1,
                      "key-count": keys, "final-polls": 4})
    clients = {}

    def complete(ctx, inv):
        c = clients.get(inv.process)
        if c is None:
            c = clients[inv.process] = wl["client"].open({}, "n1")
        return c.invoke({}, inv).replace(time=inv.time + 10)

    g = rgen.clients(rgen.phases(rgen.limit(n_ops, wl["generator"]),
                                 wl["final-generator"]))
    return rh.history(rtk.simulate(g, complete,
                                   ctx=rtk.n_plus_nemesis_context(3)))


def carried(h):
    """The port's history of the same ops, through Op.to_dict."""
    return ph.History([o.to_dict() for o in h], reindex=False)


FAULTS = [None, "lose-acked", "duplicate", "skip-offset", "unseen"]


@pytest.mark.parametrize("rw_edges", [False, True])
@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_histories_equal_the_reference(seed, fault, rw_edges):
    h = reference_history(seed, {fault} if fault else None)
    want = rk.analyze(h, rw_edges=rw_edges)
    got = pk.analyze(carried(h), rw_edges=rw_edges, device="cpu")
    assert got == want
    if fault in ("lose-acked", "duplicate"):
        assert got["valid"] is False


def cyclic_history(pairs):
    """`pairs` copies of test_kafka.py's test_wr_ww_cycle_detected, each
    on its own keys (`chip_smoke.kafka_cycle_ops`, phase 13c's
    fixture)."""
    return rh.history([rh.Op(**d) for d in kafka_cycle_ops(pairs)])


@pytest.mark.parametrize("rw_edges", [False, True])
def test_large_cyclic_graph_equals_the_reference(rw_edges, monkeypatch):
    """At 300 vertices a flagged graph extracts its cycles on the
    device path in both packages (B8): the records are equal, and the
    anomaly types are those of the host search (graph.check_cycles) of
    the same graph."""
    from jepsen_tpu_torch.checker.elle.graph import check_cycles

    h = cyclic_history(150)
    seen, extractions = {}, []
    screen, extract = scc.check_cycles_device, scc.extract_cycles_device

    def spy(graphs, **kw):
        seen["g"] = graphs[0]
        return screen(graphs, **kw)

    monkeypatch.setattr(scc, "check_cycles_device", spy)
    monkeypatch.setattr(scc, "extract_cycles_device",
                        lambda *a, **kw: extractions.append(1) or
                        extract(*a, **kw))
    want = rk.analyze(h, rw_edges=rw_edges)
    got = pk.analyze(carried(h), rw_edges=rw_edges, device="cpu")
    assert got == want
    assert len(seen["g"].vertices) == 300 and extractions
    assert got["anomaly-types"] == sorted(
        {c["type"] for c in check_cycles(seen["g"])}) == ["G0", "G1c"]


def test_checker_writes_the_references_artifacts(tmp_path):
    """KafkaChecker's store artifacts: the JAX package's file names, and
    equal JSON and DOT files."""
    h = reference_history(2, {"duplicate", "lose-acked"}, n_ops=80)
    h = rh.history(list(h) + list(cyclic_history(2)), reindex=True)
    outs = []
    for sub, checker, hist in (
            ("ref", rk.KafkaChecker(), h),
            ("port", pk.KafkaChecker(device="cpu"), carried(h))):
        d = tmp_path / sub
        res = checker.check({}, hist, {"dir": str(d)})
        assert res["valid"] is False
        files = sorted(p.name for p in (d / "kafka").iterdir())
        texts = {n: (d / "kafka" / n).read_text() for n in files
                 if not n.endswith(".svg")}
        outs.append((files, {n: json.loads(t) if n.endswith(".json") else t
                             for n, t in texts.items()}))
    assert outs[0] == outs[1]
    assert any(n.startswith("cycle-") for n in outs[1][0])
    assert {"anomalies.json", "unseen.json", "unseen.svg",
            "realtime-lag.svg"} <= set(outs[1][0])


def test_write_artifacts_equal_on_a_valid_run(tmp_path):
    h = reference_history(3, None, n_ops=60)
    res = rk.analyze(h)
    assert res["valid"] is True
    r_artifacts(res, {"dir": str(tmp_path / "ref")}, list(h))
    p_artifacts(res, {"dir": str(tmp_path / "port")}, list(carried(h)))
    for d in ("ref", "port"):
        assert sorted(p.name for p in (tmp_path / d / "kafka").iterdir()) \
            == ["realtime-lag.svg", "unseen.json", "unseen.svg"]
    assert json.loads((tmp_path / "ref/kafka/unseen.json").read_text()) == \
        json.loads((tmp_path / "port/kafka/unseen.json").read_text())


# -- the device ----------------------------------------------------------


def test_no_card_raises_before_any_analysis(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = carried(cyclic_history(1))
    with pytest.raises(DeviceUnavailable):
        pk.analyze(h)
    with pytest.raises(DeviceUnavailable):
        pk.KafkaChecker().check({}, h, {})
    with pytest.raises(DeviceUnavailable):
        pk.workload({})["checker"].check({}, h, {})
    assert pk.analyze(h, device="cpu")["valid"] is False


def test_large_graph_goes_to_the_host_in_both_packages(monkeypatch):
    """Past 1,024 vertices the graph skips the screen in both packages
    (the JAX package's rule, kept): no screen call, equal records."""
    h = cyclic_history(520)
    screens = []
    real = scc.screen_cycles
    monkeypatch.setattr(scc, "screen_cycles",
                        lambda *a, **kw: screens.append(1) or real(*a, **kw))
    got = pk.analyze(carried(h), device="cpu")
    assert got == rk.analyze(h)
    assert not screens
    assert {"G0", "G1c"} <= set(got["anomaly-types"])


# -- a whole run through the port's CLI -----------------------------------


def test_cli_run_and_analyze(tmp_path):
    """`cli test --workload kafka --device cpu` and then `cli analyze` of
    the stored run: the run is valid, the re-analysis (the stored poll
    maps revived) equals it, and so does the JAX package's analysis of
    the stored history."""
    argv = ["--workload", "kafka", "--dummy-ssh", "--device", "cpu",
            "--concurrency", "1", "--time-limit", "1", "--key-count", "4",
            "--max-writes-per-key", "64", "--final-polls", "6",
            "--seed", "11", "--store-dir", str(tmp_path / "s")]
    parser = cli.single_test_cmd(workloads.test_fn,
                                 extra_opts=workloads._extra_opts)
    assert cli.run(parser, ["test", *argv]) == cli.EXIT_VALID
    d = store.latest(str(tmp_path / "s"))
    tf = store.load(d)
    try:
        ran, stored = tf.results, tf.history()
    finally:
        tf.close()
    assert ran["valid"] is True and sum(o.is_ok for o in stored) > 50
    assert any(isinstance(k, str) for o in stored
               if o.f == "poll" and o.is_ok
               for m in o.value if m[0] == "poll" for k in m[1])
    assert cli.run(parser, ["analyze", *argv]) == cli.EXIT_VALID
    tf = store.load(d)
    try:
        again = tf.results
    finally:
        tf.close()
    assert again == ran
    rtf = rstore.load(d)
    try:
        rh_stored = rtf.history()
    finally:
        rtf.close()
    revived = pk.revive_polls(stored)
    ref = rk.analyze(rh.History([o.to_dict() for o in revived],
                                reindex=False).client_ops())
    ran.pop("resilience", None)
    assert json.loads(store.format._encode(ref)) == ran
    assert len(rh_stored) == len(stored)


def test_revive_polls_restores_the_keys():
    h = ph.History([
        ph.Op(type="ok", f="send", value=[["send", 3, [0, 7]]], process=0),
        ph.Op(type="ok", f="assign", value=[3, "k"], process=1),
        ph.Op(type="ok", f="poll", value=[["poll", {"3": [[0, 7]],
                                                   "k": []}]], process=1),
    ])
    out = pk.revive_polls(h)
    assert out[2].value == [["poll", {3: [[0, 7]], "k": []}]]
    assert [o.index for o in out] == [0, 1, 2]
    assert out[0] is h[0]


def test_in_memory_broker_commits_whole_transactions():
    """The port's in-memory client holds the log's lock across a whole
    transaction: a second client's transaction that starts while the
    first is between its sends waits for it, so two concurrent
    fault-free transactions never interleave into a G0 (the JAX
    package's client locks per micro-op)."""
    state = pk.LogState()
    first, second = (pk.InMemoryKafkaClient(state).open({}, "n1")
                     for _ in range(2))
    between = threading.Event()
    real_send = state.send

    def send(k, v):
        off = real_send(k, v)
        if v == "a1":
            between.set()
            time.sleep(0.2)  # room for the second transaction to cut in
        return off

    state.send = send

    def txn(p, mops):
        return ph.Op(type="invoke", f="txn", value=mops, process=p)

    t = threading.Thread(target=first.invoke, args=(
        {}, txn(0, [["send", "x", "a1"], ["send", "y", "a2"]])))
    t.start()
    between.wait()
    second.invoke({}, txn(1, [["send", "y", "b1"], ["send", "x", "b2"]]))
    t.join()
    assert (state.logs["x"], state.logs["y"]) == (["a1", "b2"], ["a2", "b1"])
    h = ph.history([
        ph.Op(type="ok", f="txn", process=p, value=[
            ["send", k, [state.logs[k].index(v), v]] for k, v in mops])
        for p, mops in ((0, [("x", "a1"), ("y", "a2")]),
                        (1, [("y", "b1"), ("x", "b2")]))])
    assert pk.analyze(h, device="cpu")["valid"] is True
