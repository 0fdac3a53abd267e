#!/usr/bin/env python
"""Fault-matrix harness for the port: the robustness layer end to end.

Runs a dummy-remote register suite through the whole lifecycle of
`jepsen_tpu_torch` (core.run -> store -> analyze) under each injected
failure, with tools/fault_matrix.py's seven cells, names and contract:

  hanging-client    an op that never returns; the op_timeout watchdog
                    must complete it as :info and rotate the worker
  hanging-checker   a compose child that sleeps forever; the
                    checker_budget must degrade it to unknown while
                    its siblings still report
  crashing-checker  a compose child that raises; isolated the same way
  wgl-fault         two runs of the device checker under
                    JEPSEN_WGL_FAULT: "witness" (the witness tier fails,
                    is retried at half its block shape and falls
                    through; the frontier BFS on the card proves the
                    history) and "all" (every tier fails; the checker
                    raises `degrade.CardExhausted` with the card probe's
                    result, and the run's history is on disk)
  nemesis-crash     every fault family stranded mid-run, then repair
  node-death        one node dies mid-run under the tolerate policy
  composed-faults   an overlapping kill and partition on one node

asserting in every cell that the run terminates within its deadline,
the history is saved and reloadable, and per-checker verdicts are
present (with the degraded tiers where the ladder ran).

wgl-fault is where the port parts from the reference's cell: the
reference settles the verdict on the exact CPU engine after every tier
failed; the port never moves a device check to the CPU, so "all" ends
in `CardExhausted` and no verdict.

The checkers and the test map run on `--device` ("cuda" by default;
"cpu" for the tests):

    python3 tools/port_fault_matrix.py [--device cpu] [cell ...]

prints one JSON line, {"fault_matrix": "ok", "device": ..., "scenarios":
{name: detail}}, and exits 0; a failing cell raises.  `run_matrix()`
and the `scenario_*` functions are importable.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from jepsen_tpu_torch import client as jc  # noqa: E402

#: Per-scenario wall-clock ceiling: generous next to the knobs below
#: (op_timeout <= 1 s, checker_budget <= 2 s), tight next to a hang.
SCENARIO_DEADLINE_S = 120.0


def _register_test(store_dir: str, device: str = "cuda",
                   **overrides) -> dict:
    """A dummy-remote cas-register test map on `device` (the
    reference's factory, with the port's "device")."""
    import random

    from jepsen_tpu_torch import checker as chk
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch import net as jnet
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.models import cas_register

    t = {
        "name": "fault-matrix",
        "nodes": ["n1", "n2", "n3"],
        "concurrency": "2n",
        "store-dir": store_dir,
        "ssh": {"dummy?": True},
        "net": jnet.noop,
        "device": device,
        "client": _AtomRegister(),
        "model": cas_register(),
        "generator": gen.time_limit(
            0.4,
            gen.clients(gen.stagger(0.005, gen.mix([
                gen.FnGen(lambda: {"f": "read"}),
                gen.FnGen(lambda: {"f": "write",
                                   "value": random.randrange(5)}),
            ]))),
        ),
        "checker": chk.compose({
            "stats": chk.Stats(),
            "linear": linearizable(algorithm="cpu", device=device),
        }),
    }
    t.update(overrides)
    return t


class _AtomRegister(jc.Client):
    """In-memory linearizable register (shared-state client)."""

    def __init__(self, state=None, lock=None):
        self.state = state if state is not None else {"v": None}
        self.lock = lock or threading.Lock()

    def open(self, test, node):
        return _AtomRegister(self.state, self.lock)

    def invoke(self, test, op):
        from jepsen_tpu_torch.history import FAIL, OK

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


class _HangingRegister(_AtomRegister):
    """Hangs forever on ~every 10th write; released on teardown so the
    abandoned daemon threads exit once the scenario is over."""

    def __init__(self, state=None, lock=None, release=None, counter=None):
        super().__init__(state, lock)
        self.release = release if release is not None else threading.Event()
        self.counter = counter if counter is not None else [0]

    def open(self, test, node):
        return _HangingRegister(
            self.state, self.lock, self.release, self.counter
        )

    def invoke(self, test, op):
        if op.f == "write":
            with self.lock:
                self.counter[0] += 1
                hang = self.counter[0] % 10 == 0
            if hang:
                self.release.wait(SCENARIO_DEADLINE_S)
        return super().invoke(test, op)


class _MortalRegister(_AtomRegister):
    """An _AtomRegister whose node can die: once `dead[node]` is set,
    opens are refused and in-flight invokes drop the connection — the
    client's-eye view of a host that is simply gone."""

    def __init__(self, state=None, lock=None, dead=None, node=None):
        super().__init__(state, lock)
        self.dead = dead if dead is not None else {}
        self.node = node

    def open(self, test, node):
        if self.dead.get(node):
            raise ConnectionRefusedError(f"{node} is dead")
        return _MortalRegister(self.state, self.lock, self.dead, node)

    def invoke(self, test, op):
        if self.dead.get(self.node):
            raise ConnectionResetError(f"{self.node} died mid-op")
        return super().invoke(test, op)


def _run_with_deadline(test: dict) -> dict:
    """core.run under the scenario deadline: a matrix cell that hangs
    is itself a robustness failure and must be reported, not waited on."""
    from jepsen_tpu_torch import core
    from jepsen_tpu_torch.utils import JepsenTimeout, timeout

    res = timeout(SCENARIO_DEADLINE_S * 1000.0, lambda: core.run(test))
    if res is JepsenTimeout:
        raise AssertionError(
            f"run did not terminate within {SCENARIO_DEADLINE_S} s"
        )
    return res


def _saved_ops(d: str) -> tuple:
    """(ops, results) of the run stored in `d`."""
    from jepsen_tpu_torch import store

    tf = store.load(d)
    try:
        return sum(1 for _ in tf.iter_ops()), tf.results
    finally:
        tf.close()


def _assert_history_saved(test: dict) -> None:
    """The store dir must hold a re-loadable history + results."""
    from jepsen_tpu_torch import store

    n, results = _saved_ops(store.test_dir(test))
    assert n == len(test["history"]), (
        f"saved history has {n} ops, run produced {len(test['history'])}"
    )
    assert results is not None and "valid" in results


@contextlib.contextmanager
def _env(name: str, value: str):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def scenario_hanging_client(store_dir: str, device: str = "cuda") -> dict:
    client = _HangingRegister()
    test = _register_test(
        store_dir,
        device,
        client=client,
        op_timeout=0.5,
        drain_timeout=2.0,
    )
    try:
        test = _run_with_deadline(test)
    finally:
        client.release.set()
    h = test["history"]
    timed_out = [
        o for o in h if o.is_info and "timed out" in (o.error or "")
    ]
    assert timed_out, "watchdog never fired on the hanging client"
    for o in h:
        if o.is_invoke:
            assert h.completion(o) is not None, "unpaired invocation"
    _assert_history_saved(test)
    res = test["results"]
    assert "stats" in res and "linear" in res
    return {
        "ops": len(h),
        "op_timeouts": len(timed_out),
        "valid": res["valid"],
    }


def scenario_hanging_checker(store_dir: str, device: str = "cuda") -> dict:
    from jepsen_tpu_torch import checker as chk
    from jepsen_tpu_torch.checker.linearizable import linearizable

    ev = threading.Event()

    def hang(test, history, opts):
        ev.wait(SCENARIO_DEADLINE_S)
        return {"valid": True}

    test = _register_test(
        store_dir,
        device,
        checker=chk.compose({
            "stats": chk.Stats(),
            "linear": linearizable(algorithm="cpu", device=device),
            "hung": chk.checker(hang, name="hung"),
        }),
        checker_budget=2.0,
    )
    try:
        test = _run_with_deadline(test)
    finally:
        ev.set()
    res = test["results"]
    assert res["hung"]["valid"] == "unknown"
    assert "budget" in res["hung"]["error"]
    # Siblings' partial results survive the hung child.
    assert res["stats"]["valid"] is True
    assert res["linear"]["valid"] is True
    assert res["valid"] == "unknown"
    _assert_history_saved(test)
    return {"valid": res["valid"], "hung": res["hung"]["error"]}


def scenario_crashing_checker(store_dir: str, device: str = "cuda") -> dict:
    from jepsen_tpu_torch import checker as chk
    from jepsen_tpu_torch.checker.linearizable import linearizable

    def boom(test, history, opts):
        raise RuntimeError("checker crashed")

    test = _register_test(
        store_dir,
        device,
        checker=chk.compose({
            "stats": chk.Stats(),
            "linear": linearizable(algorithm="cpu", device=device),
            "crash": chk.checker(boom, name="crash"),
        }),
    )
    test = _run_with_deadline(test)
    res = test["results"]
    assert res["crash"]["valid"] == "unknown"
    assert "checker crashed" in res["crash"]["error"]
    assert "traceback" in res["crash"]
    assert res["stats"]["valid"] is True
    assert res["linear"]["valid"] is True
    _assert_history_saved(test)
    return {"valid": res["valid"], "crash": res["crash"]["error"]}


def _wgl_test(store_dir: str, device: str) -> dict:
    from jepsen_tpu_torch import checker as chk
    from jepsen_tpu_torch.checker.linearizable import linearizable

    return _register_test(
        store_dir,
        device,
        checker=chk.compose({
            "stats": chk.Stats(),
            "linear": linearizable(algorithm="wgl-tpu", time_limit_s=60.0,
                                   device=device),
        }),
    )


def scenario_wgl_fault(store_dir: str, device: str = "cuda") -> dict:
    """The device checker under JEPSEN_WGL_FAULT, twice.  "witness":
    the witness tier fails, its halved retry fails, and the frontier
    BFS proves the history on the device; the ladder's path is in the
    metadata.  "all": every tier fails and the checker raises
    `CardExhausted` out of the run, carrying the card probe's result;
    no verdict, and the history the run stored is on disk."""
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.ops import degrade

    test = _wgl_test(os.path.join(store_dir, "witness"), device)
    with _env(degrade.FAULT_ENV, "witness"):
        test = _run_with_deadline(test)
    res = test["results"]
    lin = res["linear"]
    assert lin["valid"] is True, lin
    assert lin.get("degradations"), "degraded tiers missing from metadata"
    tiers = {s["tier"] for s in lin["degradations"]}
    assert tiers == {"witness"}, tiers
    assert res["stats"]["valid"] is True
    _assert_history_saved(test)

    all_dir = os.path.join(store_dir, "all")
    with _env(degrade.FAULT_ENV, "all"):
        try:
            _run_with_deadline(_wgl_test(all_dir, device))
        except degrade.CardExhausted as e:
            err = e
        else:
            raise AssertionError("JEPSEN_WGL_FAULT=all reached a verdict")
    assert "card probe" in str(err), err
    n_ops, results = _saved_ops(store.latest(all_dir))
    assert n_ops > 0 and results is None, (n_ops, results)
    return {
        "valid": res["valid"],
        "algorithm": lin["algorithm"],
        "degraded_tiers": sorted(tiers),
        "all": {"raised": type(err).__name__, "probe_ok": err.probe["ok"],
                "stored_ops": n_ops},
    }


def scenario_nemesis_crash(store_dir: str, device: str = "cuda") -> dict:
    """Control-plane crash mid-fault, then `jepsen repair`: all four
    fault families (partition, netem, clock, process) are injected and
    their heals abandoned via JEPSEN_NEMESIS_FAULT=abandon — the
    in-test stand-in for a SIGKILL'd control process.  The run must
    leave outstanding ledger entries on disk (and count them as
    nemesis.residue.outstanding), and `core.repair` must replay every
    compensator until the residue sweep reports clean — twice, since
    repairing a clean dir is a no-op."""
    import random

    from jepsen_tpu_torch import core, generator as gen, net as jnet
    from jepsen_tpu_torch import store, telemetry
    from jepsen_tpu_torch.nemesis import combined as ncombined
    from jepsen_tpu_torch.nemesis import core as ncore
    from jepsen_tpu_torch.nemesis import ledger as nledger
    from jepsen_tpu_torch.nemesis.faults import ClockNemesis, HammerTime

    packet_nem = ncombined.packet_package(
        {"faults": {"packet"}, "interval": 0.05}
    )["nemesis"]
    nem = ncore.compose([
        ({"start-partition": "start", "stop-partition": "stop"},
         ncore.partitioner(
             lambda nodes: ncore.complete_grudge(ncore.bisect(nodes)))),
        packet_nem,
        ClockNemesis(),
        ({"start-hammer": "start", "stop-hammer": "stop"},
         HammerTime("regd")),
    ])
    nem_gen = [
        {"type": "info", "f": "start-partition", "value": None},
        {"type": "info", "f": "start-packet"},
        {"type": "info", "f": "bump", "value": 1000},
        {"type": "info", "f": "start-hammer", "value": None},
    ]
    client_gen = gen.stagger(0.005, gen.mix([
        gen.FnGen(lambda: {"f": "read"}),
        gen.FnGen(lambda: {"f": "write", "value": random.randrange(5)}),
    ]))
    test = _register_test(
        store_dir,
        device,
        net=jnet.iptables,  # real net impl; commands no-op on dummy remotes
        nemesis=nem,
        generator=gen.time_limit(0.8, gen.nemesis(nem_gen, client_gen)),
    )
    was_enabled = telemetry.enabled()
    telemetry.enable(True)
    try:
        with _env(nledger.FAULT_ENV, "abandon"):
            test = _run_with_deadline(test)
    finally:
        telemetry.enable(was_enabled)
    _assert_history_saved(test)

    d = store.test_dir(test)
    led_path = nledger.ledger_path(d)
    outstanding = nledger.outstanding_entries(
        nledger.read_records(led_path)
    )
    fams = {e["fault"] for e in outstanding}
    assert {"partition", "netem", "clock", "process"} <= fams, (
        f"expected all four families stranded, got {sorted(fams)}"
    )
    resil = test["results"].get("resilience") or {}
    assert resil.get("nemesis.residue.outstanding", 0) >= 4, resil

    # Recovery: repair reopens sessions from the stored test map alone.
    report = core.repair(d)
    assert report["clean"], report
    assert set(report["healed"]) == {e["id"] for e in outstanding}, report
    # Idempotence: a second repair finds nothing to do.
    report2 = core.repair(d)
    assert report2["outstanding"] == 0 and report2["clean"], report2
    return {
        "stranded_families": sorted(fams),
        "stranded_entries": len(outstanding),
        "healed": len(report["healed"]),
        "second_repair_outstanding": report2["outstanding"],
    }


def scenario_node_death(store_dir: str, device: str = "cuda") -> dict:
    """One node dies permanently mid-run under `tolerate` policy: its
    opens are refused and in-flight invokes disconnect.  The health
    monitor must pick up the passive signals, confirm via probes, and
    quarantine the node; from then on its ops complete as fast :fail
    (the armed op_timeout must never fire), the run completes on the
    two survivors, and the results carry the availability timeline."""
    import random

    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch.history import FAIL

    dead: dict = {}
    victim = "n3"
    test = _register_test(
        store_dir,
        device,
        client=_MortalRegister(dead=dead),
        op_timeout=5.0,
        **{
            "node-loss-policy": "tolerate:2",
            "health-probe": lambda test, node: not dead.get(node),
            # ~0.45 s of probation before quarantine: long enough that
            # the dead node's workers demonstrably retry (and fail)
            # opens first, short enough to leave >1 s of fast-fail.
            "health-probe-interval": 0.15,
            "health-quarantine-after": 3,
        },
    )
    test["generator"] = gen.time_limit(
        2.0,
        gen.clients(gen.stagger(0.01, gen.mix([
            gen.FnGen(lambda: {"f": "read"}),
            gen.FnGen(lambda: {"f": "write",
                               "value": random.randrange(5)}),
        ]))),
    )
    killer = threading.Timer(0.4, lambda: dead.__setitem__(victim, True))
    was_enabled = telemetry.enabled()
    telemetry.enable(True)
    killer.start()
    try:
        test = _run_with_deadline(test)
    finally:
        killer.cancel()
        telemetry.enable(was_enabled)
    _assert_history_saved(test)

    res = test["results"]
    resil = res.get("resilience") or {}
    nodes = resil.get("nodes") or {}
    assert nodes.get(victim, {}).get("state") == "quarantined", nodes
    timeline = nodes[victim]["timeline"]
    assert any(e["to"] == "quarantined" for e in timeline), timeline
    # Survivors stayed healthy and did real work.
    h = test["history"]
    oks = [o for o in h if o.is_ok]
    assert oks, "no successful ops on the surviving nodes"
    for n in ("n1", "n2"):
        assert nodes.get(n, {}).get("state") == "healthy", nodes
    # Ops against the corpse fast-failed — no per-op timeout burn: the
    # armed watchdog never fired.
    fast_fails = [
        o for o in h
        if o.type == FAIL and "quarantined" in (o.error or "")
    ]
    assert fast_fails, "no fast-fail ops against the quarantined node"
    assert resil.get("interpreter.op-timeouts", 0) == 0, resil
    assert resil.get("node.quarantined", 0) >= 1, resil
    assert resil.get("client.open.failed", 0) >= 1, resil
    return {
        "ops": len(h),
        "ok_ops": len(oks),
        "fast_fails": len(fast_fails),
        "timeline": [
            {"from": e["from"], "to": e["to"]} for e in timeline
        ],
    }


class _KillableDB:
    """A DB whose kill/start toggle the same `dead` map
    _MortalRegister reads: killing the process takes the node's client
    face down too, exactly what an overlapping partition+kill composes
    against."""

    def __init__(self, dead):
        from jepsen_tpu_torch import db as jdb

        self._base = jdb.NoopDB()
        self.dead = dead

    def __getattr__(self, name):
        return getattr(self._base, name)

    def kill(self, test, sess, node):
        self.dead[node] = True

    def start(self, test, sess, node):
        self.dead[node] = False

    def pause(self, test, sess, node):
        self.dead[node] = True

    def resume(self, test, sess, node):
        self.dead[node] = False


def scenario_composed_faults(store_dir: str, device: str = "cuda") -> dict:
    """Overlapping kill+partition on the SAME node under tolerate:2 —
    the fault composition class a one-fault-at-a-time matrix never
    exercises: n3's process is killed while a partition isolates n3
    from the survivors, then both heal in overlap order.  Asserts the
    run terminates, every ledger entry is healed (kill's db-start and
    the partition's net-heal), the residue sweep finds nothing, and the
    checker still reaches a verdict on the surviving majority.

    The schedule is a search genome compiled through
    `nemesis.search.compile_schedule` — the path `jepsen search`
    candidates take — so this cell also pins the genome->generator
    contract against a known composition."""
    import random

    from jepsen_tpu_torch import generator as gen, net as jnet
    from jepsen_tpu_torch import store, telemetry
    from jepsen_tpu_torch.nemesis import ledger as nledger, search

    dead: dict = {}
    victim = "n3"
    sched = search.Schedule(seed=11, events=(
        search.Event(family="kill", t=0.15, duration=0.5,
                     targets=[victim], salt=1),
        search.Event(family="partition", t=0.3, duration=0.5,
                     params={"kind": "one", "isolate": victim}, salt=2),
    ))
    client_gen = gen.stagger(0.005, gen.mix([
        gen.FnGen(lambda: {"f": "read"}),
        gen.FnGen(lambda: {"f": "write", "value": random.randrange(5)}),
    ]))
    test = _register_test(
        store_dir,
        device,
        net=jnet.iptables,  # real net impl; commands no-op on dummy remotes
        client=_MortalRegister(dead=dead),
        db=_KillableDB(dead),
        **{"node-loss-policy": "tolerate:2"},
    )
    # Both events take at most one node down at once — the tolerate:2
    # floor the search itself would enforce holds by construction.
    assert search.respects_floor(sched, len(test["nodes"]), 2)
    pkg = search.compile_schedule(sched, {"interval": 0.05},
                                  nodes=test["nodes"])
    fs = [op["f"] for _, op in pkg["timeline"]]
    assert fs == ["kill", "start-partition", "start", "stop-partition"], fs
    test["nemesis"] = pkg["nemesis"]
    test["generator"] = gen.time_limit(
        pkg["horizon"] + 0.4, gen.nemesis(pkg["generator"], client_gen)
    )
    was_enabled = telemetry.enabled()
    telemetry.enable(True)
    try:
        test = _run_with_deadline(test)
    finally:
        telemetry.enable(was_enabled)
    _assert_history_saved(test)

    d = store.test_dir(test)
    records = nledger.read_records(nledger.ledger_path(d))
    fams = {e["fault"] for e in records if e.get("rec") == "intent"}
    assert {"process", "partition"} <= fams, sorted(fams)
    outstanding = nledger.outstanding_entries(records)
    assert not outstanding, outstanding
    assert dead.get(victim) is False, dead  # the DB came back
    resil = test["results"].get("resilience") or {}
    residue = {k: v for k, v in resil.items()
               if k.startswith("nemesis.residue.") and v}
    assert not residue, residue
    res = test["results"]
    assert res["stats"]["valid"] is True, res["stats"]
    assert res["linear"]["valid"] in (True, False), res["linear"]
    h = test["history"]
    assert any(o.f == "kill" and o.type == "info" for o in h)
    assert any(o.f == "start-partition" and o.type == "info" for o in h)
    return {
        "timeline": fs,
        "ledger_families": sorted(fams),
        "ops": len(h),
        "valid": res["valid"],
    }


SCENARIOS = {
    "hanging-client": scenario_hanging_client,
    "hanging-checker": scenario_hanging_checker,
    "crashing-checker": scenario_crashing_checker,
    "wgl-fault": scenario_wgl_fault,
    "nemesis-crash": scenario_nemesis_crash,
    "node-death": scenario_node_death,
    "composed-faults": scenario_composed_faults,
}


def run_matrix(names=None, device: str = "cuda") -> dict:
    """Runs each scenario in its own temp store dir on `device`;
    returns {name: detail}.  Raises AssertionError on the first failing
    cell (and `CardExhausted` or any other device fault as it is)."""
    from jepsen_tpu_torch import device as _device

    dev = str(_device.resolve(device))
    out = {}
    for name, fn in SCENARIOS.items():
        if names and name not in names:
            continue
        with tempfile.TemporaryDirectory(prefix=f"fm-{name}-") as d:
            out[name] = fn(os.path.join(d, "store"), dev)
    return out


def main(argv) -> int:
    import logging

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("cells", nargs="*", metavar="cell",
                    help=f"any of {', '.join(SCENARIOS)} (default: all)")
    args = ap.parse_args(argv[1:])
    unknown = set(args.cells) - set(SCENARIOS)
    if unknown:
        ap.error(f"unknown cells: {sorted(unknown)}")
    logging.basicConfig(level=logging.WARNING)
    results = run_matrix(set(args.cells) or None, device=args.device)
    print(json.dumps({"fault_matrix": "ok", "device": args.device,
                      "scenarios": results}, default=repr))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
