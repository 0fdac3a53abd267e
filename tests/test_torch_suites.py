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


@pytest.mark.parametrize("command", ["serve", "monitor", "fleet",
                                     "checkerd", "checkerd-router", "lint"])
def test_unported_subcommands_name_their_item(command, capsys):
    from jepsen_tpu_torch import cli

    assert pkvdb.main([command]) == cli.EXIT_USAGE
    item = cli.NOT_PORTED_COMMANDS[command]
    assert f"Queue A item {item}" in capsys.readouterr().err


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
    assert [h["label"] for h in state["iterations"]][:2] == [
        "seed-partition", "seed-kill"]
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
