"""The port's five demo suites (jepsen_tpu_torch/suites/) against their
real C++ servers, on the CPU: tests/test_kvdb_suite.py's cases run
through `jepsen_tpu_torch` (g++ builds and real daemons, the checkers
on the CPU), the `slow`-marked cases of the five suite test files the
same way, a run of the JAX package's kvdb, txnd and logd suites
re-analyzed by the port's `cli analyze` with equal results, and the
copied C and C++ sources byte for byte the reference's."""

import filecmp
import json
import pathlib
import shutil

import pytest

import jepsen_tpu.store as rstore
import jepsen_tpu.suites.kvdb as rkvdb
import jepsen_tpu.suites.logd as rlogd
import jepsen_tpu.suites.txnd as rtxnd
import jepsen_tpu_torch.store as pstore
import jepsen_tpu_torch.suites.kvdb as pkvdb
import jepsen_tpu_torch.suites.logd as plogd
import jepsen_tpu_torch.suites.txnd as ptxnd
import torch_ported
from chip_smoke import untimed

ROOT = pathlib.Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++")

KVDB = torch_ported.load("test_kvdb_suite")
SLOW = [torch_ported.load(f"test_{s}_suite")
        for s in ("kvdb", "logd", "txnd", "repkv", "electd")]


def _ids(x):
    return x if isinstance(x, str) else x.__name__[len("ported_"):]


@pytest.mark.parametrize("mod, case",
                         [(KVDB, c) for c in torch_ported.cases(KVDB)],
                         ids=_ids)
def test_kvdb_suite_through_the_port(mod, case, request):
    torch_ported.run(mod, case, request)


@pytest.mark.slow
@pytest.mark.parametrize(
    "mod, case",
    [(m, c) for m in SLOW for c in torch_ported.cases(m, slow=True)],
    ids=_ids)
def test_slow_suite_cases_through_the_port(mod, case, request):
    torch_ported.run(mod, case, request)


def test_case_counts():
    """Seven unmarked kvdb cases run in tier-1; 31 slow ones in all."""
    assert len(torch_ported.cases(KVDB)) == 7
    assert sum(len(torch_ported.cases(m, slow=True)) for m in SLOW) == 31


def _results(store_mod, d) -> dict:
    tf = store_mod.load(d)
    try:
        return untimed(json.loads(json.dumps(tf.results, sort_keys=True,
                                              default=str)))
    finally:
        tf.close()


@pytest.mark.parametrize("ref, port, argv", [
    (rkvdb, pkvdb, ["--time-limit", "4", "--concurrency", "4",
                    "--seed", "11", "--interval", "1.5"]),
    (rtxnd, ptxnd, ["--time-limit", "4", "--seed", "11"]),
    (rlogd, plogd, ["--time-limit", "4", "--seed", "11", "--faults",
                    "kill", "--interval", "1.5"]),
], ids=["kvdb-register", "txnd-wr", "logd-kafka"])
def test_port_analyzes_a_stored_reference_run(ref, port, argv, tmp_path):
    """The JAX package's suite runs against its server; the port's
    `cli analyze` of the stored run gives the run's own results and exit
    code, wall-clock readings and the run's node-health record
    ("resilience", which only a live run has) aside.  The run's results
    are the oracle, not the JAX package's re-analysis: that one reads a
    stored Kafka poll map's keys as JSON's strings, where the port
    revives them (kafka.revive_polls)."""
    store_dir = str(tmp_path / "store")
    code = ref.main(["test", *argv, "--store-dir", store_dir])
    d = rstore.latest(store_dir)
    expected = _results(rstore, d)
    expected.pop("resilience", None)
    assert port.main(["analyze", "--device", "cpu", *argv,
                      "--store-dir", store_dir, d]) == code
    assert _results(pstore, d) == expected


@pytest.mark.parametrize("rel", [
    "demo/kvdb.cpp", "demo/logd.cpp", "demo/txnd.cpp", "demo/repkv.cpp",
    "demo/electd.cpp", "resources/bump-time.c", "resources/strobe-time.c"])
def test_copied_sources_are_the_references(rel):
    assert filecmp.cmp(ROOT / "jepsen_tpu" / rel,
                       ROOT / "jepsen_tpu_torch" / rel, shallow=False)


def test_demo_source_resolves_inside_the_port():
    from jepsen_tpu_torch import demo

    for name in ("kvdb", "logd", "txnd", "repkv", "electd"):
        path = pathlib.Path(demo.source(name))
        assert path.parent == ROOT / "jepsen_tpu_torch" / "demo"
    with pytest.raises(FileNotFoundError):
        demo.source("nope")


SUITES = ("kvdb", "logd", "txnd", "repkv", "electd")


@pytest.mark.parametrize("name", SUITES)
def test_suite_needs_the_card_unless_asked_for_the_cpu(name, tmp_path,
                                                       monkeypatch):
    """Without a card a suite's `test` exits 254 before its first op:
    no server built, no store directory written."""
    import importlib

    import torch

    from jepsen_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"jepsen_tpu_torch.suites.{name}")
    store_dir = tmp_path / "store"
    assert mod.main(["test", "--time-limit", "1", "--store-dir",
                     str(store_dir)]) == cli.EXIT_ERROR
    assert not store_dir.exists()


@pytest.mark.parametrize("dirty", [False, True])
def test_lint_subcommand(dirty, tmp_path, capsys):
    """`kvdb lint --root <fixture>`: the port's jepsenlint over a tree
    holding one module, exit 0 when it is clean and 1 when it narrows a
    value with no range guard."""
    pkg = tmp_path / "jepsen_tpu_torch"
    pkg.mkdir()
    cast = "torch.int32" if dirty else "torch.int64"
    (pkg / "fixture.py").write_text(
        f"import torch\n\n\ndef f(x):\n    return x.to({cast})\n")
    assert pkvdb.main(["lint", "--root", str(tmp_path)]) == int(dirty)
    out = capsys.readouterr().out
    assert "jepsenlint: 1 files" in out
    assert ("device.unguarded-narrowing" in out) == dirty


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(pred, proc, deadline_s: float, what: str):
    import time

    deadline = time.monotonic() + deadline_s
    while True:
        v = pred()
        if v:
            return v
        assert proc is None or proc.poll() is None, f"{what}: exited"
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.2)


def _standing_serve(tmp_path):
    """`logd serve` as a process: `/` and `/monitor` answer; SIGTERM
    stops it."""
    import subprocess
    import sys
    import urllib.request

    port = _free_port()
    (tmp_path / "store").mkdir()
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.suites.logd", "serve",
         "--store-dir", str(tmp_path / "store"), "--host", "127.0.0.1",
         "--port", str(port)], cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)

    def get(path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=10) as r:
                return r.status, r.read().decode()
        except OSError:
            return None

    try:
        code, body = _wait(lambda: get("/"), proc, 90, "serve listening")
        assert code == 200 and "jepsen-tpu store" in body
        code, body = get("/monitor")
        assert code == 200 and "no series store found" in body
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def _standing_monitor(tmp_path):
    """`kvdb monitor --device cpu` with the dashboard embedded: exit 0,
    every key proven, the summary and the series on disk."""
    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.telemetry import timeseries

    d = tmp_path / "mon"
    assert pkvdb.main(["monitor", "--device", "cpu", "--store-dir", str(d),
                       "--duration", "1.5", "--rate", "2000", "--keys",
                       "2", "--cadence", "0.3", "--advance-rows", "256",
                       "--serve-port", "0"]) == cli.EXIT_VALID
    summary = json.loads((d / "monitor-summary.json").read_text())
    assert summary["ok_keys"] == 2 and summary["unknown_keys"] == 0
    assert summary["device"] == "cpu"
    assert timeseries.read_disk_series(str(d), "monitor.ops-per-s")


def _standing_fleet(tmp_path):
    """`kvdb fleet add` then `kvdb fleet run --device cpu` as a process:
    the tenant's live kvdb monitor starts with `--device cpu`, completes
    a fault window, and is drained into its summary on SIGTERM."""
    import signal
    import subprocess
    import sys

    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.monitor import fleet

    root = str(tmp_path / "fleet")
    assert pkvdb.main(["fleet", "add", "--dir", root, "--tenant", "t1",
                       "--rate", "40", "--cadence", "0.5"]) \
        == cli.EXIT_VALID
    store = pathlib.Path(fleet.tenant_store_dir(root, "t1"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.suites.kvdb", "fleet",
         "run", "--dir", root, "--device", "cpu", "--tick", "0.2",
         "--drain-timeout", "60"], cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        def windows():
            try:
                return json.loads((store / "live-status.json")
                                  .read_text())["windows"] >= 1
            except (OSError, ValueError, KeyError):
                return False

        _wait(windows, proc, 180, "a fault window")
        status = fleet.read_status(root)
        assert status["tenants"]["t1"]["alive"] is True
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    summary = json.loads((store / "monitor-summary.json").read_text())
    assert summary["device"] == "cpu" and summary["ops"] > 0
    assert summary["live"]["residue"]["clean"] is True
    assert fleet.read_status(root)["tenants"]["t1"]["alive"] is False


@pytest.mark.parametrize("command", ["serve", "monitor", "fleet"])
def test_standing_subcommands_through_the_suite_cli(command, tmp_path):
    {"serve": _standing_serve, "monitor": _standing_monitor,
     "fleet": _standing_fleet}[command](tmp_path)


def test_search_needs_two_nodes_and_the_card(tmp_path, monkeypatch):
    """`search` is a suite subcommand: kvdb's single node is refused
    with the usage exit, and without a card it exits 254 before the
    first iteration."""
    import torch

    from jepsen_tpu_torch import cli

    store_dir = tmp_path / "store"
    assert pkvdb.main(["search", "--device", "cpu", "--store-dir",
                       str(store_dir)]) == cli.EXIT_USAGE
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pkvdb.main(["search", "--store-dir",
                       str(store_dir)]) == cli.EXIT_ERROR
    assert not (store_dir / "kvdb-register-search").exists()


def test_repkv_search_through_its_cli(tmp_path):
    """`repkv search` against the real servers, checked on the CPU: the
    search dir written, each iteration's stored verdict that of the
    exact CPU engine on its stored history, a convicting iteration's
    dossier refuted from its JSON alone, and no server left."""
    import jepsen_tpu_torch.suites.repkv as prepkv
    from chip_smoke import _servers
    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.history import History, Op
    from jepsen_tpu_torch.models import cas_register

    store_dir = tmp_path / "store"
    argv = ["search", "--device", "cpu", "--node", "n1", "--node", "n2",
            "--node", "n3", "--search-families", "partition,kill",
            "--max-iterations", "2", "--shrink-attempts", "1",
            "--budget", "60", "--seed", "1", "--store-dir", str(store_dir)]
    try:
        assert prepkv.main(argv) == cli.EXIT_VALID
    finally:
        left = _servers(str(tmp_path))
    assert not left, left
    sdir = store_dir / "repkv-register-search"
    state = json.loads((sdir / "search.json").read_text())
    # Shrink runs count against --max-iterations, as in the reference's
    # search: a seed-partition iteration that convicts (repkv's unsafe
    # reads under a partition may or may not go stale) spends the second
    # run on its shrink, and seed-kill then never runs.
    labels = [h["label"] for h in state["iterations"]]
    if state["iterations"][0]["interesting"]:
        assert labels == ["seed-partition"], labels
        assert state["cells"][0]["shrink_runs"] == 1, state["cells"]
    else:
        assert labels == ["seed-partition", "seed-kill"], labels
    runs = sorted(p for p in (sdir / "runs").glob("*/2*") if p.is_dir())
    assert len(runs) >= 2
    for d in runs:
        tf = pstore.load(str(d))
        try:
            res, h = tf.results, tf.history()
        finally:
            tf.close()
        exact = Linearizable(cas_register(), "cpu", device="cpu").check(
            {}, h.client_ops(), {})
        assert res["linear"]["valid"] == exact["valid"], d
        for dossier in (res.get("forensics") or {}).get("dossiers", []):
            ce = json.loads(pathlib.Path(
                dossier["dir"], "counterexample.json").read_text())
            mini = History([Op.from_dict(o) for o in ce["ops"]],
                           reindex=False)
            assert Linearizable(cas_register(), "cpu", device="cpu").check(
                {}, mini, {})["valid"] is False
