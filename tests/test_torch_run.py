"""A Jepsen test run through the port (jepsen_tpu_torch core, cli and
workloads) on the CPU, against the JAX package: tests/test_core.py's
shapes with device="cpu", each run's stored history checked again by
the reference's checkers with equal results; the north-star
(linearizable_register) and list-append workloads whole-stack through
the CLI; `cli analyze` of a stored run; and the exit codes of a run
with no card (before its first op, with no history written) and of a
device fault during analysis (EXIT_ERROR, never unknown or valid)."""

import os
import random
import threading

import pytest

import jepsen_tpu.checker as rchk
import jepsen_tpu.parallel as rpar
import jepsen_tpu.store as rstore
from jepsen_tpu.checker.elle import AppendChecker as RAppend
from jepsen_tpu.models import cas_register as r_cas
from jepsen_tpu_torch import checker as chk
from jepsen_tpu_torch import cli, core, store
from jepsen_tpu_torch import client as jc
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import net as jnet
from jepsen_tpu_torch import workloads
from jepsen_tpu_torch.device import DeviceUnavailable
from jepsen_tpu_torch.history import FAIL, OK
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops import degrade


class AtomRegister(jc.Client):
    def __init__(self, state=None, lock=None):
        self.state = state if state is not None else {"v": None}
        self.lock = lock or threading.Lock()

    def open(self, test, node):
        return AtomRegister(self.state, self.lock)

    def invoke(self, test, op):
        with self.lock:
            if op.f == "write":
                self.state["v"] = op.value
                return op.complete(OK)
            if op.f == "read":
                return op.complete(OK, value=self.state["v"])
            old, new = op.value
            if self.state["v"] == old:
                self.state["v"] = new
                return op.complete(OK)
            return op.complete(FAIL)


def register_test(tmp_path, **overrides):
    """tests/test_core.py's register test, on the port, on the CPU."""
    t = {
        "name": "register-smoke",
        "nodes": ["n1", "n2", "n3"],
        "concurrency": "2n",
        "store-dir": str(tmp_path / "store"),
        "ssh": {"dummy?": True},
        "net": jnet.noop,
        "device": "cpu",
        "client": AtomRegister(),
        "model": cas_register(),
        "generator": gen.time_limit(0.4, gen.clients(gen.stagger(
            0.005, gen.mix([
                gen.FnGen(lambda: {"f": "read"}),
                gen.FnGen(lambda: {"f": "write",
                                   "value": random.randrange(5)}),
                gen.FnGen(lambda: {"f": "cas",
                                   "value": (random.randrange(5),
                                             random.randrange(5))})])))),
        "checker": chk.compose({
            "stats": chk.Stats(),
            "linear": chk.linearizable(algorithm="wgl-tpu", device="cpu")}),
    }
    t.update(overrides)
    return t


def reference_check(d):
    """The reference's checkers (stats; linearizable, exact CPU engine)
    on the history stored in run dir `d`, read by the reference."""
    tf = rstore.load(d)
    try:
        h = tf.history()
    finally:
        tf.close()
    h = h.map(lambda o: o.replace(value=tuple(o.value))
              if o.f == "cas" and isinstance(o.value, list) else o)
    return rchk.compose({
        "stats": rchk.Stats(),
        "linear": rchk.linearizable(model=r_cas(), algorithm="cpu"),
    }).check({}, h, {})


def same_verdicts(port, ref):
    assert port["valid"] == ref["valid"]
    assert port["stats"] == ref["stats"]
    assert port["linear"]["valid"] == ref["linear"]["valid"]


def test_full_lifecycle_equals_the_reference_checkers(tmp_path):
    test = core.run(register_test(tmp_path))
    assert test["results"]["valid"] is True
    assert test["device"] == "cpu"
    d = store.test_dir(test)
    tf = store.load(d)
    try:
        assert tf.results["valid"] is True
        assert len(list(tf.iter_ops())) == len(test["history"])
        assert tf.test["concurrency"] == 6
        assert tf.test["device"] == "cpu"
    finally:
        tf.close()
    assert os.path.exists(os.path.join(d, "history.txt"))
    assert os.path.exists(os.path.join(d, "jepsen.log"))
    same_verdicts(test["results"], reference_check(d))


def test_rerun_analysis_equals_the_reference_checkers(tmp_path):
    test = core.run(register_test(tmp_path))
    d = store.test_dir(test)
    merged = core.rerun_analysis(d, register_test(tmp_path))
    same_verdicts(merged["results"], reference_check(d))
    tf = store.load(d)
    try:
        assert tf.results == merged["results"]
    finally:
        tf.close()


def test_cli_test_and_analyze(tmp_path, capsys):
    def suite(opts):
        return register_test(tmp_path, nodes=opts["nodes"],
                             concurrency=opts["concurrency"])

    parser = cli.single_test_cmd(suite, name="register")
    argv = ["--dummy-ssh", "--device", "cpu", "--store-dir",
            str(tmp_path / "store")]
    assert cli.run(parser, ["test", "--nodes", "a,b,c", "--concurrency",
                            "1n", *argv]) == cli.EXIT_VALID
    assert "valid=True" in capsys.readouterr().out
    assert cli.run(parser, ["analyze", *argv]) == cli.EXIT_VALID
    d = store.latest(str(tmp_path / "store"))
    tf = store.load(d)
    try:
        same_verdicts(tf.results, reference_check(d))
    finally:
        tf.close()


def test_cli_invalid_exit_code(tmp_path):
    class AlwaysInvalid(chk.Checker):
        def check(self, test, history, opts):
            return {"valid": False, "because": "testing"}

    parser = cli.single_test_cmd(
        lambda opts: register_test(tmp_path, checker=AlwaysInvalid()))
    assert cli.run(parser, ["test", "--dummy-ssh", "--device", "cpu",
                            "--store-dir", str(tmp_path / "store")]) \
        == cli.EXIT_INVALID


def test_cli_test_all_and_repair(tmp_path):
    parser = cli.single_test_cmd(
        lambda opts: register_test(tmp_path),
        tests_fn=lambda opts: [register_test(tmp_path, name="a"),
                               register_test(tmp_path, name="b")])
    argv = ["--dummy-ssh", "--device", "cpu", "--store-dir",
            str(tmp_path / "store")]
    assert cli.run(parser, ["test-all", *argv]) == cli.EXIT_VALID
    # A fault-free run's ledger is clean: nothing to repair.
    assert cli.run(parser, ["repair", *argv]) == cli.EXIT_VALID


def test_final_generator_phased_in(tmp_path):
    test = core.run(register_test(
        tmp_path, generator=gen.clients(gen.limit(5, {"f": "write",
                                                      "value": 1})),
        **{"final-generator": gen.once({"f": "read"})}))
    assert test["history"][-1].f == "read"
    assert test["history"][-1].value == 1


def test_crashed_run_leaves_readable_file(tmp_path):
    """A client bug mid-run still leaves the test map readable."""

    class Bomb(jc.Client):
        def open(self, test, node):
            return self

        def invoke(self, test, op):
            return op.complete(OK)

        def setup(self, test):
            raise RuntimeError("setup exploded")

    with pytest.raises(RuntimeError):
        core.run(register_test(tmp_path, client=Bomb()))
    d = store.latest(str(tmp_path / "store"))
    for pkg_store in (store, rstore):
        tf = pkg_store.load(d)
        try:
            assert tf.test["name"] == "register-smoke"
        finally:
            tf.close()


def test_rerun_analysis_keeps_stored_shape(tmp_path):
    t = register_test(tmp_path)
    t["nodes"] = ["a", "b", "c", "d", "e", "f", "g"]
    d = store.test_dir(core.run(t))
    assert len(core.rerun_analysis(d, register_test(tmp_path))["nodes"]) \
        == 7


# -- the north-star and list-append workloads through the CLI ------------


def _revived_for_reference(d):
    """The stored keyed history, read by the reference, with its KV
    values back (the reference stores them as lists, as the port
    does)."""
    tf = rstore.load(d)
    try:
        h = tf.history()
    finally:
        tf.close()

    def back(o):
        k, v = o.value
        return o.replace(value=rpar.KV(k, tuple(v) if isinstance(v, list)
                                       else v))
    return h.map(back)


def _per_key(results):
    return {str(k): r["valid"] for k, r in results["results"].items()}


class StaleRead(workloads.linearizable_register.InMemoryKVRegisterClient):
    """Reads of keys below `bad` return a value no write wrote."""

    bad = 2

    def open(self, test, node):
        return StaleRead(self.state, self.lock)

    def invoke(self, test, op):
        out = super().invoke(test, op)
        k = op.value.key
        if op.f == "read" and k < self.bad and out.type == OK:
            out = out.replace(value=type(op.value)(k, 99))
        return out


def _lr_suite(client=None):
    def suite(opts):
        t = workloads.test_fn(opts)
        if client is not None:
            t["client"] = client
        return t
    return suite


LR_ARGS = ["--workload", "linearizable-register", "--dummy-ssh",
           "--device", "cpu", "--key-count", "6", "--per-key-limit", "30",
           "--threads-per-key", "2", "--concurrency", "6", "--time-limit",
           "30", "--seed", "5"]


@pytest.mark.parametrize("bad", [False, True])
def test_north_star_workload_whole_stack(tmp_path, bad):
    """`cli test` of linearizable_register on the CPU (the port's
    default algorithm, the witness and its plain sweep), then `cli
    analyze` of the stored run: per-key verdicts equal the reference's
    exact CPU engine on the stored history, and the re-analysis equals
    the run's."""
    parser = cli.single_test_cmd(_lr_suite(StaleRead() if bad else None),
                                 extra_opts=workloads._extra_opts)
    argv = [*LR_ARGS, "--store-dir", str(tmp_path / "store")]
    want_code = cli.EXIT_INVALID if bad else cli.EXIT_VALID
    assert cli.run(parser, ["test", *argv]) == want_code
    d = store.latest(str(tmp_path / "store"))
    tf = store.load(d)
    try:
        ran = tf.results
        assert len(list(tf.iter_ops())) == 2 * 6 * 30
    finally:
        tf.close()
    ref = rpar.independent_checker(rchk.linearizable(
        model=r_cas(), algorithm="cpu")).check({}, _revived_for_reference(d),
                                               {})
    assert _per_key(ran) == _per_key(ref)
    assert ran["valid"] == ref["valid"] == (not bad)
    if bad:
        assert sorted(k for k, v in _per_key(ran).items()
                      if v is False) == ["0", "1"]
    assert cli.run(parser, ["analyze", *argv]) == want_code
    tf = store.load(d)
    try:
        assert _per_key(tf.results) == _per_key(ran)
    finally:
        tf.close()


def _reference_keyed(d):
    """The stored keyed history, read by the reference, with the values
    the run held in memory: KV(key, KV(key, payload)), a cas payload a
    tuple."""
    tf = rstore.load(d)
    try:
        h = tf.history()
    finally:
        tf.close()

    def payload(f, v):
        if isinstance(v, list) and len(v) == 2:
            inner = v[1]
            if f == "cas" and isinstance(inner, list):
                inner = tuple(inner)
            return rpar.KV(v[0], inner)
        return v

    return h.map(lambda o: o.replace(value=rpar.KV(
        o.value[0], payload(o.f, o.value[1])))
        if isinstance(o.value, list) else o)


def test_keyed_run_writes_the_references_key_artifacts(tmp_path,
                                                       monkeypatch):
    """A keyed run stores independent/<key>/{results.json,history.txt}
    for every key, as the reference's IndependentChecker does for the
    same history: the history files byte for byte, the results equal
    but for "elapsed-s" (a wall clock), and "counterexample-file" equal
    below each store root: the SVG both packages draw for a refuted
    key (checker/linviz.py), which exists in both stores."""
    import json

    monkeypatch.delenv("JEPSEN_WGL_PACKED", raising=False)
    parser = cli.single_test_cmd(_lr_suite(StaleRead()),
                                 extra_opts=workloads._extra_opts)
    argv = [*LR_ARGS, "--store-dir", str(tmp_path / "store")]
    assert cli.run(parser, ["test", *argv]) == cli.EXIT_INVALID
    d = store.latest(str(tmp_path / "store"))
    ref_dir = tmp_path / "ref"
    ref = rpar.independent_checker(rchk.linearizable(model=r_cas())).check(
        {}, _reference_keyed(d), {"dir": str(ref_dir)})
    assert ref["valid"] is False
    ours = os.path.join(d, "independent")
    keys = sorted(os.listdir(ours))
    assert keys == sorted(os.listdir(ref_dir / "independent")) == [
        str(k) for k in range(6)]

    def read(root, k, name, mode="r"):
        with open(os.path.join(root, k, name), mode) as f:
            return f.read()

    def results(root, k):
        r = json.loads(read(root, k, "results.json"))
        r.pop("elapsed-s", None)
        cx = r.get("counterexample-file")
        if cx is not None:
            assert os.path.isfile(cx), cx
            r["counterexample-file"] = os.path.relpath(
                cx, os.path.dirname(root))
        return r

    for k in keys:
        assert read(ours, k, "history.txt", "rb") == read(
            ref_dir / "independent", k, "history.txt", "rb")
        assert results(ours, k) == results(ref_dir / "independent", k)
    assert [k for k in keys if results(ours, k)["valid"] is False] == [
        "0", "1"]
    assert {results(ours, k).get("counterexample-file")
            for k in ("0", "1")} == {"linear.svg"}


def test_north_star_workload_online(tmp_path):
    """--streaming: the online session checks keys while the run
    generates them, and the per-key verdicts are its own."""
    argv = [*LR_ARGS, "--streaming", "--store-dir", str(tmp_path / "s")]
    assert workloads.main(["test", *argv]) == cli.EXIT_VALID
    tf = store.load(store.latest(str(tmp_path / "s")))
    try:
        res = tf.results
    finally:
        tf.close()
    assert res["valid"] is True
    assert "streaming" in res
    algos = {r.get("algorithm") for r in res["results"].values()}
    assert "wgl-online" in algos, algos


def test_list_append_workload_whole_stack(tmp_path):
    """`cli test` of the list-append workload: the verdict and anomaly
    types equal the reference's host search on the stored history."""
    argv = ["--workload", "list-append", "--dummy-ssh", "--device", "cpu",
            "--concurrency", "4", "--time-limit", "1.5", "--seed", "3",
            "--store-dir", str(tmp_path / "store")]
    assert workloads.main(["test", *argv]) == cli.EXIT_VALID
    d = store.latest(str(tmp_path / "store"))
    tf = rstore.load(d)
    try:
        ran, h = tf.results, tf.history()
    finally:
        tf.close()
    ref = RAppend("serializable", device="off").check({}, h, {})
    assert ran["valid"] == ref["valid"] is True
    assert ran.get("anomaly-types") == ref.get("anomaly-types")
    assert sum(o.is_ok for o in h) > 50


# -- no card, device faults ----------------------------------------------


def _no_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_no_card_fails_before_the_first_op(tmp_path, monkeypatch):
    """Without a card and without --device cpu, `cli test` exits
    EXIT_ERROR before the suite builds a generator: no op, no store
    directory, no history; core.run raises before its store dir."""
    _no_card(monkeypatch)
    built = []

    def suite(opts):
        built.append(opts)
        return register_test(tmp_path)

    parser = cli.single_test_cmd(suite)
    root = tmp_path / "store"
    assert cli.run(parser, ["test", "--dummy-ssh", "--store-dir",
                            str(root)]) == cli.EXIT_ERROR
    assert built == [] and not root.exists()
    assert workloads.main(["test", "--dummy-ssh", "--store-dir",
                           str(root)]) == cli.EXIT_ERROR
    assert not root.exists()
    t = register_test(tmp_path)
    del t["device"]
    with pytest.raises(DeviceUnavailable):
        core.run(t)
    assert not root.exists()


def test_device_fault_in_analysis_exits_error(tmp_path, monkeypatch):
    """JEPSEN_WGL_FAULT=all: every device tier of the linearizable
    checker fails and its ladder ends in CardExhausted — `cli test` and
    `cli analyze` exit EXIT_ERROR, never EXIT_UNKNOWN or EXIT_VALID
    (the reference's check_safe would make it "unknown"), and
    core.analyze raises it."""
    parser = cli.single_test_cmd(lambda opts: register_test(tmp_path))
    argv = ["--dummy-ssh", "--device", "cpu", "--store-dir",
            str(tmp_path / "store")]
    assert cli.run(parser, ["test", *argv]) == cli.EXIT_VALID
    monkeypatch.setenv(degrade.FAULT_ENV, "all")
    assert cli.run(parser, ["analyze", *argv]) == cli.EXIT_ERROR
    assert cli.run(parser, ["test", *argv]) == cli.EXIT_ERROR
    t = register_test(tmp_path)
    h = core.run({**t, "checker": None})["history"]
    with pytest.raises(degrade.CardExhausted):
        core.analyze(t, h)


def test_analyze_routes_through_the_daemon_address(tmp_path, monkeypatch):
    """test["checkerd"] sends the linearizable part of the checker tree
    to the daemon (checkerd.client.wrap_remote, Compose children
    included); the stats child stays in process."""
    from jepsen_tpu_torch.checkerd import client as cd

    seen = []

    def remote_check(self, test, history, opts):
        seen.append(self.addr)
        return {"valid": True, "via": "checkerd"}

    monkeypatch.setattr(cd.RemoteChecker, "check", remote_check)
    res = core.run(register_test(tmp_path, checkerd="127.0.0.1:1"))["results"]
    assert res["valid"] is True
    assert res["linear"] == {"valid": True, "via": "checkerd"}
    assert "by-f" in res["stats"]
    assert seen == ["127.0.0.1:1"]
