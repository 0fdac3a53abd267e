"""The port's live-target monitor on the CPU (monitor/live.py).

tests/test_monitor_live.py runs through `jepsen_tpu_torch`
(tests/torch_ported.py; its `telem` fixture is rewritten below, since a
ported file's fixtures are not collected): the client pool's event
shape, quarantine fast-fail, the nemesis driver's coverage and
checkpoints, resume, heals on stop, the repair sweep and the graceful
SIGTERM drain, against in-process fakes.  Then the real path: `jepsen
monitor --suite kvdb --device cpu` through kvdb's CLI against its C++
server, with kill and pause windows, exits 0 with every key proven, both
families injected and healed in the fault ledger and a clean residue
probe, and no server left behind.
"""

import json

import pytest
import torch

import torch_ported
from chip_smoke import _servers

from jepsen_tpu_torch import cli, telemetry
from jepsen_tpu_torch.nemesis import ledger
from jepsen_tpu_torch.suites import kvdb as pkvdb

LIVE = torch_ported.load("test_monitor_live")


@pytest.fixture
def telem():
    """test_monitor_live.py's fixture on the port's registry."""
    old = telemetry.enabled()
    telemetry.enable(True)
    telemetry.reset()
    yield
    telemetry.reset()
    telemetry.enable(old)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", torch_ported.cases(LIVE))
def test_monitor_live_cases_through_the_port(case, request):
    torch_ported.run(LIVE, case, request)


def test_monitor_live_case_list():
    assert len(torch_ported.cases(LIVE)) == 8


def test_resolve_suite_loads_the_ports_suites():
    from jepsen_tpu_torch.monitor import live

    for name in ("kvdb", "logd", "electd", "txnd", "repkv"):
        adapter = live.resolve_suite(name)
        assert adapter["name"] == name
        assert callable(adapter["client"]) and callable(adapter["test"])
        assert adapter["client"].__module__ == \
            f"jepsen_tpu_torch.suites.{name}"
    with pytest.raises(ValueError, match="unknown monitor suite"):
        live.resolve_suite("etcd")


def test_live_kvdb_monitor_through_the_cli(tmp_path):
    store = tmp_path / "store"
    rc = pkvdb.main(["monitor", "--suite", "kvdb", "--device", "cpu",
                     "--store-dir", str(store), "--duration", "6",
                     "--rate", "50", "--keys", "2", "--procs-per-key", "2",
                     "--cadence", "1", "--live-faults", "kill,pause",
                     "--window-gap", "0.2"])
    assert rc == cli.EXIT_VALID
    summary = json.loads((store / "monitor-summary.json").read_text())
    assert summary["ok_keys"] == 2 and summary["unknown_keys"] == 0
    live = summary["live"]
    assert live["suite"] == "kvdb" and live["driver"]["windows"] >= 1
    assert live["residue"]["clean"] is True
    assert live["outstanding-at-exit"] == 0
    records = ledger.read_records(ledger.ledger_path(str(store / "live")))
    healed = {r["id"] for r in records if r.get("rec") == "healed"}
    tags = {r.get("tag") for r in records
            if r.get("rec") == "intent" and r["id"] in healed}
    assert {"db-kill", "db-pause"} <= tags, tags
    assert summary["ops"] > 0 and summary["device"] == "cpu"
    assert not _servers(str(store))
