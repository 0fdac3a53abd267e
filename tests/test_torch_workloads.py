"""The port's stock workloads (jepsen_tpu_torch/workloads/) against the
JAX package's, on the CPU: the workload cases of tests/test_cycle_workload.py,
tests/test_probe_workloads.py, tests/test_elle.py and tests/test_core.py
through the port; each workload's seeded generator run through both
packages' generator simulation (generator/testkit) against its in-memory
client, with equal ops and equal checker results; and every workload
through the port's CLI, then `cli analyze` of the stored run, and with
no card."""

import importlib

import pytest
import torch

import jepsen_tpu.checker as rchk
import jepsen_tpu.generator as rgen
import jepsen_tpu.generator.testkit as rtk
import jepsen_tpu.history as rh
import jepsen_tpu.workloads as rwl
import jepsen_tpu_torch.checker as pchk
import jepsen_tpu_torch.generator as pgen
import jepsen_tpu_torch.generator.testkit as ptk
import jepsen_tpu_torch.history as ph
from jepsen_tpu_torch import cli, store
from jepsen_tpu_torch import workloads as pwl
from jepsen_tpu_torch.device import DeviceUnavailable
import torch_ported


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: Cases of the JAX test files that test modules the port does not have
#: yet, by the ROADMAP.md Queue A item that will port them: none.
NOT_PORTED: set = set()

CYCLE = torch_ported.load("test_cycle_workload")
PROBE = torch_ported.load("test_probe_workloads")
ELLE = torch_ported.load("test_elle")
CORE = torch_ported.load("test_core")

#: The workload cases of tests/test_elle.py and tests/test_core.py (the
#: rest of test_elle.py is tests/test_torch_elle.py's).
ELLE_CASES = ["test_wr_workload_end_to_end", "test_bank_workload_end_to_end",
              "test_bank_checker_catches_bad_total", "test_long_fork_checker",
              "test_long_fork_workload_end_to_end",
              "test_set_workload_end_to_end"]
CORE_CASES = ["test_final_generator_phased_in"]


@pytest.mark.parametrize(
    "mod, case",
    [(CYCLE, c) for c in torch_ported.cases(CYCLE, NOT_PORTED)]
    + [(PROBE, c) for c in torch_ported.cases(PROBE, NOT_PORTED)]
    + [(ELLE, c) for c in torch_ported.cases(ELLE) if c in ELLE_CASES]
    + [(CORE, c) for c in torch_ported.cases(CORE) if c in CORE_CASES],
    ids=lambda x: x if isinstance(x, str) else x.__name__[len("ported_"):])
def test_workload_cases_through_the_port(mod, case, request):
    torch_ported.run(mod, case, request)


def test_every_excluded_case_exists():
    """NOT_PORTED names real cases: nothing else is left out."""
    names = set(torch_ported.cases(CYCLE)) | set(torch_ported.cases(PROBE))
    assert NOT_PORTED <= names
    assert len(set(torch_ported.cases(CYCLE)) - NOT_PORTED) == 13
    assert len(set(torch_ported.cases(PROBE)) - NOT_PORTED) == 12
    assert "test_k8s_remote_requires_kubectl" in torch_ported.cases(PROBE)


# -- seeded simulations through both packages -----------------------------

#: Workload name -> (options, ops the main generator gives, threads).
SIM = {
    "bank": ({"seed": 7}, 120, 4),
    "long-fork": ({"seed": 3}, 120, 4),
    "set": ({}, 80, 4),
    "rw-register": ({"seed": 7}, 120, 4),
    "adya-g2": ({}, 60, 4),
    "causal": ({}, 60, 4),
    "causal-reverse": ({"nodes": ["n1"], "per-key-limit": 30}, 120, 4),
    "total-queue": ({"drain-ops": 120}, 120, 4),
    "kafka": ({"seed": 9, "key-count": 3, "faults": {"duplicate"},
               "fault-rate": 0.05, "final-polls": 4}, 120, 3),
}


def simulate(wl_mod, gen, tk, opts, n_ops, threads):
    """(workload map, history) of `wl_mod`'s workload: its generator,
    limited to `n_ops`, then its final generator, through `tk.simulate`
    on `threads` client threads, each op completed by the workload's
    in-memory client (one per process; the JAX package's queue workload
    names none, so it takes the port's FIFO, whose ops it completes as
    they are)."""
    wl = wl_mod.workload(dict(opts))
    client = wl.get("client") or pwl.queue.InMemoryQueueClient()
    clients = {}

    def complete(ctx, inv):
        c = clients.get(inv.process)
        if c is None:
            c = clients[inv.process] = client.open(wl, "n1")
        return c.invoke(wl, inv).replace(time=inv.time + 10)

    g = gen.limit(n_ops, wl["generator"])
    if wl.get("final-generator") is not None:
        g = gen.phases(g, wl["final-generator"])
    ops = tk.simulate(gen.clients(g), complete,
                      ctx=tk.n_plus_nemesis_context(threads))
    return wl, ops


def _norm(x):
    """A value or result as comparable plain data: keys by repr, tuples
    (a KV, a position) as lists, sets sorted by repr."""
    if isinstance(x, dict):
        return {repr(k): _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted((_norm(v) for v in x), key=repr)
    return x


@pytest.mark.parametrize("name", sorted(SIM))
def test_seeded_run_equals_the_reference(name, tmp_path):
    """The same seeded workload through both packages' simulation gives
    equal ops, and both packages' checkers (the port's on the CPU) give
    equal results on them."""
    opts, n_ops, threads = SIM[name]
    mod = pwl.WORKLOADS[name]
    ref_mod = importlib.import_module(
        "jepsen_tpu" + mod.__name__[len("jepsen_tpu_torch"):])
    rwlm, rops = simulate(ref_mod, rgen, rtk, opts, n_ops, threads)
    pwlm, pops = simulate(mod, pgen, ptk, {**opts, "device": "cpu"}, n_ops,
                          threads)
    assert len(pops) > n_ops
    assert [_norm(o.to_dict()) for o in pops] == \
        [_norm(o.to_dict()) for o in rops]
    rhist, phist = rh.history(rops), ph.history(pops)
    want = rchk.check_safe(rwlm["checker"], rwlm, rhist,
                           {"dir": str(tmp_path)})
    got = pchk.check_safe(pwlm["checker"], pwlm, phist,
                          {"dir": str(tmp_path)})
    # The port's IndependentChecker adds the keys each tier settled.
    assert got.pop("tiers", {}) == {}
    assert _norm(got) == _norm(want)
    assert got["valid"] is (name != "kafka")


# -- the CLI --------------------------------------------------------------

#: Per workload: CLI options past the common ones.  Kafka runs one
#: worker (the logd suite's default on its one node): the in-memory log
#: appends a transaction's sends one at a time, so concurrent
#: transactions can interleave into a real G0.
CLI_ARGS = {
    "adya-g2": [],
    "bank": [],
    "causal": [],
    "causal-reverse": [],
    "kafka": ["--concurrency", "1", "--max-writes-per-key", "32",
              "--final-polls", "6"],
    "linearizable-register": ["--key-count", "4", "--per-key-limit", "20",
                              "--threads-per-key", "2"],
    "list-append": [],
    "long-fork": [],
    "rw-register": [],
    "set": [],
    "total-queue": ["--rate", "300", "--drain-ops", "400"],
}


def test_every_workload_is_registered():
    assert sorted(CLI_ARGS) == sorted(pwl.WORKLOADS)
    named = {m.__name__.rsplit(".", 1)[1] for m in pwl.WORKLOADS.values()}
    # The JAX package's __init__ leaves out queue.py; the port's runner
    # needs it imported.
    assert named | {"cycle"} == set(rwl.__all__) | {"queue"}
    for name, mod in pwl.WORKLOADS.items():
        assert mod.workload({"device": "cpu"})["name"] == name


@pytest.mark.parametrize("name", sorted(CLI_ARGS))
def test_cli_run_is_valid(name, tmp_path):
    """`cli test --workload <name> --device cpu` exits EXIT_VALID, and
    `cli analyze` of the stored run (its values revived where the
    workload names a reviver) gives the same results."""
    argv = ["--workload", name, "--dummy-ssh", "--device", "cpu",
            "--node", "n1", "--concurrency", "4", "--time-limit", "0.6",
            "--seed", "5", *CLI_ARGS[name],
            "--store-dir", str(tmp_path / "s")]
    assert pwl.main(["test", *argv]) == cli.EXIT_VALID
    tf = store.load(store.latest(str(tmp_path / "s")))
    try:
        ran = tf.results
        assert len(list(tf.iter_ops())) > 10
    finally:
        tf.close()
    assert pwl.main(["analyze", *argv]) == cli.EXIT_VALID
    tf = store.load(store.latest(str(tmp_path / "s")))
    try:
        again = tf.results
    finally:
        tf.close()
    assert again.get("valid") == ran.get("valid") is True


@pytest.mark.parametrize("name", sorted(CLI_ARGS))
def test_no_card_fails_before_the_first_op(name, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = tmp_path / "s"
    assert pwl.main(["test", "--workload", name, "--dummy-ssh",
                     "--store-dir", str(root)]) == cli.EXIT_ERROR
    assert not root.exists()


@pytest.mark.parametrize("name", ["adya-g2", "causal", "causal-reverse",
                                  "kafka", "rw-register"])
def test_device_checkers_raise_without_a_card(name, monkeypatch):
    """A workload whose checker runs on the device raises
    DeviceUnavailable at its first check without a card; the cycle
    checker does so when it asks for the card."""
    import torch

    from jepsen_tpu_torch.checker.elle import DepGraph
    from jepsen_tpu_torch.workloads import cycle

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        pwl.WORKLOADS[name].workload({})["checker"].check(
            {}, ph.History([]), {})
    with pytest.raises(DeviceUnavailable):
        cycle.checker(lambda h: DepGraph(), device="on").check(
            {}, ph.History([]), {})
    assert cycle.checker(lambda h: DepGraph()).check(
        {}, ph.History([]), {})["valid"] is True
