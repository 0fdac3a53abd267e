"""The port's multi-tenant fleet on the CPU (monitor/fleet.py,
monitor/retention.py).

tests/test_fleet.py runs through `jepsen_tpu_torch`
(tests/torch_ported.py, its `telem` fixture rewritten below): registry
durability, supervision isolation, rolling restarts, drain and resume,
retention, the tee's shed backoff and the live families, against fake
children.  Then what the port must hold on its own:

* a registry written by either package, torn tail included, reads the
  same in the other;
* `retention.sweep` deletes the same files on the same tree as the
  reference's, with equal reports;
* the supervisor resolves its device when it is made (no card: it
  raises, and `jepsen fleet run` exits 254 before any child) and hands
  the resolved device to each tenant child as `--device`;
* a child's uptime ends when it exits, not when a tick notices, so a
  slow tick cannot make a crash-looping child look healthy.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

import torch_ported

from jepsen_tpu_torch import cli, telemetry
from jepsen_tpu_torch.monitor import fleet as pfleet
from jepsen_tpu_torch.monitor import retention as pret
from jepsen_tpu_torch.suites import kvdb as pkvdb

FLEET = torch_ported.load("test_fleet")


@pytest.fixture
def telem():
    """test_fleet.py's fixture on the port's registry."""
    old = telemetry.enabled()
    telemetry.enable(True)
    telemetry.reset()
    yield
    telemetry.reset()
    telemetry.enable(old)


@pytest.mark.parametrize("case", torch_ported.cases(FLEET))
def test_fleet_cases_through_the_port(case, request):
    torch_ported.run(FLEET, case, request)


def test_fleet_case_list():
    assert len(torch_ported.cases(FLEET)) == 18


# -- the registry across packages --------------------------------------------


def _mutate(reg, spec_cls):
    reg.add(spec_cls(name="a", suite="kvdb", nodes=("n1",), weight=2.0,
                     live_faults=("kill", "pause"), retain_bytes=1 << 20))
    reg.add(spec_cls(name="b", suite="logd", rate=75.0))
    reg.add(spec_cls(name="c", suite="electd"))
    reg.set_state("a", "drained")
    reg.bump_generation("b")
    reg.remove("c")


def _view(tenants):
    return {n: s.to_json() for n, s in sorted(tenants.items())}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_registry_either_package_wrote_reads_in_the_other(tmp_path,
                                                            writer):
    from jepsen_tpu.monitor import fleet as rfleet

    w, r = (rfleet, pfleet) if writer == "reference" else (pfleet, rfleet)
    root = str(tmp_path)
    _mutate(w.FleetRegistry(root), w.TenantSpec)
    with open(os.path.join(root, w.FLEET_JOURNAL), "a") as f:
        f.write('{"seq": 99, "op": "remove", "ten')
    want = _view(w.FleetRegistry(root).load())
    assert sorted(want) == ["a", "b"]
    assert want["a"]["state"] == "drained"
    assert want["b"]["generation"] == 1
    assert _view(r.FleetRegistry(root).load()) == want
    # A stale snapshot (crash between journal and snapshot) replays the
    # same in the other package too.
    os.unlink(os.path.join(root, w.FLEET_FILE))
    assert _view(r.FleetRegistry(root).load()) == want
    # And the reader's next mutation is read back by the writer.
    r.FleetRegistry(root).add(r.TenantSpec(name="d", suite="repkv"))
    assert sorted(w.FleetRegistry(root).load()) == ["a", "b", "d"]


# -- retention against the reference -----------------------------------------


def _tree(store, now):
    d = os.path.join(store, "forensics", "monitor")
    os.makedirs(d)
    for i in range(9):
        p = os.path.join(d, f"d{i}.json")
        with open(p, "w") as f:
            f.write("x" * (200 + 50 * i))
        t = now - 86400 * (12 - i)
        os.utime(p, (t, t))
    for name, age, size in (("series-t0.jtpu", 40, 900),
                            ("series-t0.jtpu.1", 30, 700),
                            ("series-t1.jtpu.1", 3, 500),
                            ("series-t2.jtpu", 1, 100)):
        p = os.path.join(store, name)
        with open(p, "wb") as f:
            f.write(b"\0" * size)
        os.utime(p, (now - 86400 * age, now - 86400 * age))


@pytest.mark.parametrize("policy", [
    dict(retain_dossiers=4, retain_days=365.0),
    dict(retain_dossiers=100, retain_days=7.0),
    dict(retain_dossiers=100, retain_days=365.0, budget_bytes=1500),
    dict(retain_dossiers=6, retain_days=10.0, budget_bytes=2500),
])
def test_retention_sweep_equals_the_reference(tmp_path, policy):
    from jepsen_tpu.monitor import retention as rret

    now = time.time()
    ref_store, port_store = str(tmp_path / "ref"), str(tmp_path / "port")
    _tree(ref_store, now)
    shutil.copytree(ref_store, port_store, copy_function=shutil.copy2)
    ref = rret.sweep(ref_store, rret.RetentionPolicy(**policy), now=now)
    port = pret.sweep(port_store, pret.RetentionPolicy(**policy), now=now)
    assert port == ref
    assert port["deleted"], port

    def left(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert left(port_store) == left(ref_store)
    assert pret.disk_bytes(port_store) == rret.disk_bytes(ref_store)
    again = pret.sweep(port_store, pret.RetentionPolicy(**policy), now=now)
    assert again["deleted"] == []


# -- the device --------------------------------------------------------------


def test_tenant_children_get_the_resolved_device(tmp_path):
    sup = pfleet.FleetSupervisor(str(tmp_path), device="cpu")
    assert sup.device == "cpu"
    assert sup.spawn.keywords == {"device": "cpu"}
    spec = pfleet.TenantSpec(name="t", suite="logd", nodes=("n1",),
                             live_faults=("kill", "pause"),
                             sinks=("file:/x",))
    argv = pfleet.tenant_argv(spec, "/s", "127.0.0.1:9", device="cpu")
    assert argv[1:7] == ["-m", "jepsen_tpu_torch.suites.logd", "monitor",
                         "--suite", "logd", "--device"]
    assert argv[7] == "cpu"
    for flag, value in (("--store-dir", "/s"), ("--endpoint", "127.0.0.1:9"),
                        ("--live-faults", "kill,pause"), ("--node", "n1"),
                        ("--sink", "file:/x"), ("--tenant", "t"),
                        ("--search-dir", "/s/search")):
        assert argv[argv.index(flag) + 1] == value
    # The child's parser takes every flag of it.
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; from jepsen_tpu_torch import cli; "
         "from jepsen_tpu_torch.suites import logd; "
         "p = cli.single_test_cmd(lambda o: {}); "
         "o = p.parse_args(sys.argv[1:]); print(o.device, o.tenant)",
         *argv[3:]], capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["cpu", "t"]


def test_fleet_without_a_card_raises_before_any_child(tmp_path,
                                                      monkeypatch):
    from jepsen_tpu_torch.device import DeviceUnavailable

    root = str(tmp_path / "fleet")
    pfleet.FleetRegistry(root).add(pfleet.TenantSpec(name="a"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        pfleet.FleetSupervisor(root)
    assert pkvdb.main(["fleet", "run", "--dir", root]) == cli.EXIT_ERROR
    assert not os.path.exists(os.path.join(root, pfleet.TENANTS_DIR))
    assert not os.path.exists(os.path.join(root, pfleet.FLEET_STATUS))


def test_fleet_registry_verbs_through_the_suite_cli(tmp_path, capsys):
    root = str(tmp_path / "fleet")
    assert pkvdb.main(["fleet", "add", "--dir", root, "--tenant", "a",
                       "--suite", "logd", "--node", "n1",
                       "--live-faults", "kill,pause"]) == cli.EXIT_VALID
    assert pkvdb.main(["fleet", "add", "--dir", root, "--tenant", "b",
                       "--node", "n1"]) == cli.EXIT_USAGE
    assert pkvdb.main(["fleet", "drain", "--dir", root, "--tenant",
                       "a"]) == cli.EXIT_VALID
    assert pkvdb.main(["fleet", "restart", "--dir", root, "--tenant",
                       "a"]) == cli.EXIT_VALID
    assert pkvdb.main(["fleet", "resume", "--dir", root, "--tenant",
                       "zz"]) == cli.EXIT_USAGE
    capsys.readouterr()
    assert pkvdb.main(["fleet", "status", "--dir", root]) == cli.EXIT_VALID
    out = capsys.readouterr().out
    assert "1 tenant(s)" in out and "drained" in out and "gen=1" in out
    spec = pfleet.FleetRegistry(root).load()["a"]
    assert spec.suite == "logd" and spec.live_faults == ("kill", "pause")
    assert pkvdb.main(["fleet", "remove", "--dir", root, "--tenant",
                       "a"]) == cli.EXIT_VALID
    assert pfleet.FleetRegistry(root).load() == {}


# -- uptime ends at the exit -------------------------------------------------


def test_a_childs_uptime_ends_when_it_exits(tmp_path):
    """A child that exits at once is a crash-loop however late the tick
    that reaps it: its uptime is read at its exit."""
    root = str(tmp_path)
    sup = pfleet.FleetSupervisor(
        root, device="cpu", min_uptime_s=1.0, park_after=3,
        spawn=lambda spec, store, ep: subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.exit(3)"]))
    ch = pfleet._Child(pfleet.TenantSpec(name="a"), sup.clock, sup.rng,
                       0.05, 0.2, 3)
    sup._start(ch)
    ch.proc.wait(timeout=60)
    deadline = time.monotonic() + 10
    while ch.exited_at is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert ch.exited_at is not None
    time.sleep(1.2)  # a tick this late would read an uptime past 1 s
    sup._reap(ch)
    assert ch.last_exit == 3
    assert ch.crash_loops == 1


# -- a parked tenant's dossier is on disk before its state -------------------


def test_parked_state_follows_its_dossier(tmp_path, monkeypatch):
    """`_park` writes the tenant's dossier before the registry says
    "parked", so a reader that sees the state finds the dossier.  The
    crash-loop case reads the dossier directory once the registry says
    parked; with the reference's order (state, then dossier) it found
    none under load."""
    root = str(tmp_path)
    pfleet.FleetRegistry(root).add(pfleet.TenantSpec(name="bad"))
    sup = pfleet.FleetSupervisor(root, device="cpu", park_after=2,
                                 spawn=lambda spec, store, ep: None)
    ddir = os.path.join(pfleet.tenant_store_dir(root, "bad"), "forensics",
                        "monitor")
    seen = []
    set_state = sup.registry.set_state

    def spy(name, state):
        if state == "parked":
            seen.append(sorted(os.listdir(ddir)) if os.path.isdir(ddir)
                        else [])
        return set_state(name, state)

    monkeypatch.setattr(sup.registry, "set_state", spy)
    ch = pfleet._Child(sup.registry.load()["bad"], sup.clock, sup.rng,
                       0.05, 0.2, 2)
    ch.crash_loops = 2
    sup._park(ch, 3, 0.1)
    assert sup.registry.load()["bad"].state == "parked"
    assert len(seen) == 1
    assert [f for f in seen[0] if f.startswith("fleet-parked-")], seen
