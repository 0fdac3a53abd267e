"""The port's self-chaos harness (nemesis/selfchaos.py) on the CPU.

tests/test_selfchaos.py runs through `jepsen_tpu_torch`
(tests/torch_ported.py), whose device redirect makes the fleet resolve
"cuda" to the CPU in this process.  Then what the port must hold on its
own: the fleet resolves its device once, here, and hands every child
the resolved name (`--device cpu` below, never a child's own choice);
it raises before any child starts when CUDA is asked for and missing;
a child that exits on its own is reported; and a short chaos schedule
against a real router and two daemon processes on the CPU keeps every
invariant.
"""

import os

import pytest
import torch

import torch_ported

from jepsen_tpu_torch.nemesis import selfchaos as sc

CHAOS = torch_ported.load("test_selfchaos")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several test processes at once,
    and the daemons' checks run under budgets."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", torch_ported.cases(CHAOS))
def test_selfchaos_cases_through_the_port(case, request):
    torch_ported.run(CHAOS, case, request)


def test_selfchaos_case_list():
    assert len(torch_ported.cases(CHAOS)) == 16


def test_fleet_without_a_card_raises_before_any_child(tmp_path,
                                                      monkeypatch):
    """"cuda" with no card raises in the parent: no child is started
    to decide on its own."""
    from jepsen_tpu_torch.ops.degrade import DeviceUnavailable

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        sc.ChaosFleet(1, str(tmp_path))
    assert not os.listdir(tmp_path)


def _cmdline(pid: int) -> list:
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        return f.read().decode().split("\0")


def test_fleet_children_get_the_resolved_device(tmp_path):
    """Each daemon child is the port's server with `--device cpu`, the
    parent's resolved device; the router has no device; a daemon that
    dies on its own shows in dead_children()."""
    fleet = sc.ChaosFleet(2, str(tmp_path), device="cpu")
    try:
        fleet.start()
        for p in fleet.daemons:
            argv = _cmdline(p.pid)
            assert "jepsen_tpu_torch.checkerd.server" in argv
            assert argv[argv.index("--device") + 1] == "cpu"
        assert "jepsen_tpu_torch.checkerd.router" in _cmdline(
            fleet.router.pid)
        assert "--device" not in _cmdline(fleet.router.pid)
        assert fleet.dead_children() == []
        fleet.daemons[1].kill()
        fleet.daemons[1].wait(timeout=10)
        dead = fleet.dead_children()
        assert len(dead) == 1 and dead[0].startswith("d1 exited")
        fleet.kill_daemon(0)  # the harness's own kill is not a death
        assert len(fleet.dead_children()) == 1
    finally:
        fleet.stop()


def test_free_ports_lie_below_the_ephemeral_range():
    """A fleet's ports lie below the kernel's ephemeral range, so no
    outgoing connection can be given a killed daemon's port before its
    restart binds it again; none is handed out twice, and each is free."""
    import socket

    low = sc._ephemeral_low()
    ports = [sc._free_port() for _ in range(64)]
    assert len(set(ports)) == len(ports)
    if low > sc.MIN_PORT + 1024:
        assert all(sc.MIN_PORT <= p < low for p in ports)
    for p in ports[:8]:
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", p))


def test_child_that_cannot_start_fails_fast(tmp_path):
    """A daemon child that exits before listening fails start_daemon at
    once with its log, instead of the listening timeout."""
    fleet = sc.ChaosFleet(1, str(tmp_path), device="cpu")
    fleet.device = "no-such-device"
    try:
        with pytest.raises(RuntimeError, match="exited"):
            fleet.start_daemon(0)
    finally:
        fleet.stop()


def test_chaos_run_on_the_cpu_keeps_the_invariants(tmp_path):
    """A short seeded schedule (daemon kill with a journal tear, a
    partition, a slow peer) against a router and two CPU daemon
    processes under three tenants: no lost verdict, no divergent
    replay, no fault the fleet failed to inject or heal, no child dead
    on its own."""
    sched = sc.compile_schedule(5, n_daemons=2, duration_s=6.0, n_faults=3,
                                families=("daemon-kill", "journal-tear",
                                          "partition", "slow-peer"))
    out = sc.run_chaos(sched, n_daemons=2, workdir=str(tmp_path),
                       whale="whale", light="alpha",
                       tenants=("whale", "alpha", "beta"),
                       fairness_bound_s=60.0, settle_s=30.0, device="cpu")
    assert out["valid"], out["violations"]
    kinds = out["history"]["kinds"]
    assert kinds.get("ack", 0) >= 3 and kinds.get("verdict", 0) >= 3, out
    # A heal that restarts a daemon blocks the schedule until the child
    # listens (as in the reference), so on a loaded host later faults
    # may fall past the window: at least the first one lands.
    assert 1 <= len(out["faults-injected"]) <= 3
