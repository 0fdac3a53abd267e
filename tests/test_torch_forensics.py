"""Anomaly forensics, the counterexample chart, `jepsen search` and the
fault and history layers they use, through the port on the CPU.

The JAX package's own tests (tests/test_forensics.py, test_linviz.py,
test_nemesis_search.py, test_env_layers.py, test_history_fold.py) run
through `jepsen_tpu_torch` (tests/torch_ported.py rewrites their
imports); then the port's functions against the JAX package's on the
same inputs, made from seeds: `forensics.minimize` / `assemble`
(the same kept ops, byte-identical counterexample.json),
`linviz.render_analysis` (byte-identical SVG), the schedule genome
(`seed_schedule`, `mutate`, `crossover`, `evolve`, `materialize`,
`compile_schedule`) over seeds 0-31, `signature` / `reasons`, and
`greedy_shrink` on a planted predicate.  Last, the port's one change
to the reference's fail-open: a device fault inside forensics raises
out of `core.analyze`; any other error is logged and the verdict
kept.
"""

import dataclasses
import json
import os
import random

import pytest
import torch

import torch_ported

import jepsen_tpu.checker.linviz as r_linviz
import jepsen_tpu.forensics as r_forensics
import jepsen_tpu.history.core as r_hist
import jepsen_tpu.history.packed as r_packed
import jepsen_tpu.models as r_models
import jepsen_tpu.nemesis.search as r_search
from jepsen_tpu.checker.wgl_cpu import check_wgl_cpu as r_check_wgl_cpu
from jepsen_tpu.utils.histgen import \
    random_register_history as r_random_register_history
from jepsen_tpu_torch import core, forensics, store
from jepsen_tpu_torch.checker import linviz
from jepsen_tpu_torch.checker.linearizable import Linearizable
from jepsen_tpu_torch.checker.wgl_cpu import check_wgl_cpu
from jepsen_tpu_torch.device import DeviceUnavailable
from jepsen_tpu_torch.history.core import History, Op
from jepsen_tpu_torch.history.packed import pack_history
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.models.registers import Register
from jepsen_tpu_torch.nemesis import search
from jepsen_tpu_torch.parallel.independent import KV, IndependentChecker
from jepsen_tpu_torch.utils.histgen import random_register_history

FORENSICS = torch_ported.load("test_forensics")
LINVIZ = torch_ported.load("test_linviz")
SEARCH = torch_ported.load("test_nemesis_search")
ENV = torch_ported.load("test_env_layers")
FOLD = torch_ported.load("test_history_fold")

MODULES = (FORENSICS, LINVIZ, SEARCH, ENV, FOLD)


@pytest.fixture(autouse=True)
def _one_thread():
    """The forensics oracle and the search's iterations run the exact
    CPU engine under a budget: one torch thread, so six test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def telem():
    """test_nemesis_search.py's fixture, on the port's telemetry."""
    from jepsen_tpu_torch import telemetry

    old = telemetry.enabled()
    telemetry.enable(True)
    telemetry.reset()
    yield
    telemetry.reset()
    telemetry.enable(old)


@pytest.mark.parametrize(
    "mod, case", [(m, c) for m in MODULES for c in torch_ported.cases(m)],
    ids=lambda x: x if isinstance(x, str) else x.__name__[len("ported_"):])
def test_reference_cases_through_the_port(mod, case, request):
    torch_ported.run(mod, case, request)


def test_every_reference_case_is_run():
    """Each file's non-slow cases, all of them."""
    assert {m.__name__: len(torch_ported.cases(m)) for m in MODULES} == {
        "ported_test_forensics": 13, "ported_test_linviz": 3,
        "ported_test_nemesis_search": 18, "ported_test_env_layers": 12,
        "ported_test_history_fold": 7}


# ---------------------------------------------------------------------
# Parity with the JAX package, on inputs made from seeds

NODES = ["n1", "n2", "n3"]
BAD_VALUE = 99


def _bad_register_dicts(seed: int, n_ops: int = 40, procs: int = 3,
                        info_rate: float = 0.1) -> list:
    """A seeded cas-register history's ops as dicts, with one ok read
    about two thirds in returning a value no write wrote: refuted."""
    h = r_random_register_history(n_ops, procs=procs, info_rate=info_rate,
                                  seed=seed)
    dicts = [o.to_dict() for o in h]
    reads = [i for i, d in enumerate(dicts)
             if d["type"] == "ok" and d["f"] == "read"]
    dicts[reads[2 * len(reads) // 3]]["value"] = BAD_VALUE
    return dicts


def _both_histories(dicts):
    return (History([Op.from_dict(dict(d)) for d in dicts]),
            r_hist.History([r_hist.Op.from_dict(dict(d)) for d in dicts]))


@pytest.mark.parametrize("seed", range(8))
def test_minimize_keeps_the_references_ops(seed):
    """The shrinker, its oracle and its budget are the reference's: the
    same kept ops, op count, attempts and engine."""
    ours_h, ref_h = _both_histories(_bad_register_dicts(seed))
    ours = forensics.minimize(ours_h, cas_register())
    ref = r_forensics.minimize(ref_h, r_models.cas_register())
    assert ref is not None and ours is not None
    assert [o.to_dict() for o in ours["history"]] == [
        o.to_dict() for o in ref["history"]]
    for k in ("original-op-count", "op-count", "attempts", "algorithm"):
        assert ours[k] == ref[k], k
    assert ours["result"].valid is False
    assert ours["result"].crashed_at == ref["result"].crashed_at
    assert int(ours["result"].configs_explored) == int(
        ref["result"].configs_explored)


@pytest.mark.parametrize("seed", range(8))
def test_render_analysis_draws_the_references_svg(seed, tmp_path):
    """The counterexample chart of the same refutation, byte for
    byte."""
    ours_h, ref_h = _both_histories(
        _bad_register_dicts(seed, n_ops=60, procs=4, info_rate=0.0))
    pm, rpm = cas_register().packed(), r_models.cas_register().packed()
    packed = pack_history(ours_h, pm.encode)
    rpacked = r_packed.pack_history(ref_h, rpm.encode)
    res = check_wgl_cpu(packed, pm)
    rres = r_check_wgl_cpu(rpacked, rpm)
    assert res.valid is False and rres.valid is False
    ours = linviz.render_analysis(packed, pm, res,
                                  str(tmp_path / "ours.svg"))
    ref = r_linviz.render_analysis(rpacked, rpm, rres,
                                   str(tmp_path / "ref.svg"))
    with open(ours, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()


def _keyed(KV_, seeds_bad):
    """Six keys of a seeded register history each, the bad ones with
    one impossible read, interleaved by key (index order)."""
    ops = []
    for key, (seed, bad) in enumerate(seeds_bad):
        dicts = (_bad_register_dicts(seed) if bad else [
            o.to_dict() for o in r_random_register_history(
                40, procs=3, info_rate=0.1, seed=seed)])
        for d in dicts:
            d["process"] = d["process"] + 3 * key
            d["value"] = KV_(key, d["value"])
            ops.append(d)
    return ops


def test_assemble_writes_the_references_dossiers(tmp_path):
    """`core.analyze`'s forensics over the same keyed history: the same
    anomalies, and per dossier a byte-identical counterexample.json
    and linear.svg."""
    import jepsen_tpu.parallel.independent as r_ind
    from jepsen_tpu.checker.linearizable import Linearizable as RLin

    seeds_bad = [(10 + k, k in (1, 4)) for k in range(6)]
    ours_h = History(_keyed(KV, seeds_bad))
    ref_h = r_hist.History(_keyed(r_ind.KV, seeds_bad))
    chk = IndependentChecker(Linearizable(cas_register(), device="cpu"),
                             device="cpu")
    rchk = r_ind.IndependentChecker(RLin(r_models.cas_register()))
    ours = chk.check({}, ours_h, {"history-key": None})
    ref = rchk.check({}, ref_h, {"history-key": None})
    assert ours["valid"] is False and ref["valid"] is False
    fo = forensics.assemble({"name": "t"}, ours, ours_h,
                            str(tmp_path / "ours"), checker=chk)
    fr = r_forensics.assemble({"name": "t"}, ref, ref_h,
                              str(tmp_path / "ref"), checker=rchk)
    assert fo["anomaly-count"] == fr["anomaly-count"] == 2
    assert fo["skipped"] == fr["skipped"] == 0
    assert [d["key"] for d in fo["dossiers"]] == [
        d["key"] for d in fr["dossiers"]]
    for do, dr in zip(fo["dossiers"], fr["dossiers"]):
        assert do["signature"] == dr["signature"]
        for name in ("counterexample.json", "linear.svg"):
            with open(os.path.join(do["dir"], name), "rb") as f, \
                    open(os.path.join(dr["dir"], name), "rb") as g:
                assert f.read() == g.read(), name


def _both_rngs(seed):
    return random.Random(seed), random.Random(seed)


def _same_schedule(ours, ref):
    assert ours.to_json() == ref.to_json()
    assert search.materialize(ours, NODES) == r_search.materialize(
        ref, NODES)


@pytest.mark.parametrize("seed", range(32))
def test_schedule_genome_equals_the_references(seed):
    """`seed_schedule`, `mutate`, `crossover` and `evolve` draw the same
    schedules from the same `random.Random` stream, and `materialize`
    and `compile_schedule` make the same ops from them."""
    fams = search.DEFAULT_FAMILIES
    rng, rrng = _both_rngs(seed)
    pool = [search.seed_schedule(f, seed=seed + i)
            for i, f in enumerate(fams)]
    rpool = [r_search.seed_schedule(f, seed=seed + i)
             for i, f in enumerate(fams)]
    for s, r in zip(pool, rpool):
        _same_schedule(s, r)
    n, floor = 3 + seed % 3, 1 + seed % 2
    for _ in range(12):
        if rng.random() < 0.3:
            assert rrng.random() < 0.3
            i, j = rng.randrange(len(pool)), rng.randrange(len(pool))
            assert (i, j) == (rrng.randrange(len(rpool)),
                              rrng.randrange(len(rpool)))
            child = search.crossover(pool[i], pool[j], n, floor, rng)
            rchild = r_search.crossover(rpool[i], rpool[j], n, floor, rrng)
        else:
            rrng.random()
            i = rng.randrange(len(pool))
            assert i == rrng.randrange(len(rpool))
            child = search.mutate(pool[i], fams, n, floor, rng)
            rchild = r_search.mutate(rpool[i], fams, n, floor, rrng)
        _same_schedule(child, rchild)
        pool.append(child)
        rpool.append(rchild)
    for w in range(len(fams) + 4):
        _same_schedule(
            search.evolve(pool, fams, n, floor, rng, window=w,
                          seed_duration=0.6),
            r_search.evolve(rpool, fams, n, floor, rrng, window=w,
                            seed_duration=0.6))
    sched = pool[-1]
    pkg = search.compile_schedule(sched, {}, nodes=NODES)
    rpkg = r_search.compile_schedule(r_search.Schedule.from_json(
        sched.to_json()), {}, nodes=NODES)
    assert pkg["generator"] == rpkg["generator"]
    assert pkg["timeline"] == rpkg["timeline"]
    assert pkg["horizon"] == rpkg["horizon"]
    assert (pkg["nemesis"] is None) == (rpkg["nemesis"] is None)
    if pkg["nemesis"] is not None:
        assert pkg["nemesis"].fs() == rpkg["nemesis"].fs()


def _outcome(seed: int) -> dict:
    """A runner's outcome drawn from a seed: counters, a composed
    checker's results (with forensics signatures), ledger records, and
    the hang and error flags."""
    rng = random.Random(seed)
    counters = {f"{p}.{rng.choice(['a', 'b', 'c'])}": rng.choice(
        [0, 1, 3, 17, 1000, 2.5, True])
        for p in ("node", "net", "nemesis.residue", "nemesis.partition",
                  "wgl.degrade", "client.open")}
    valid = rng.choice([True, False, "unknown", None])
    results = {"valid": valid,
               "linear": {"valid": valid, "anomaly-types": rng.sample(
                   ["G0", "G1c", "lost-write"], rng.randrange(3))},
               "stats": {"valid": True, "error": rng.random() < 0.2}}
    if valid is False:
        results["forensics"] = {"dossiers": [
            {"signature": f"{rng.getrandbits(48):012x}"}]}
    ledger = []
    for i in range(rng.randrange(4)):
        ledger.append({"rec": "intent", "id": i,
                       "fault": rng.choice(["partition", "process"])})
        if rng.random() < 0.6:
            ledger.append({"rec": "healed", "id": i,
                           "by": rng.choice(["run", "teardown"])})
    return {"resilience": counters, "results": results, "ledger": ledger,
            "hang": rng.random() < 0.2,
            "error": "JepsenTimeout: x" if rng.random() < 0.2 else None}


@pytest.mark.parametrize("seed", range(16))
def test_signature_and_reasons_equal_the_references(seed):
    out = _outcome(seed)
    assert search.signature(out) == r_search.signature(out)
    assert search.reasons(out) == r_search.reasons(out)


def test_signature_of_a_recorded_iteration(tmp_path):
    """A real iteration's outcome from the port's `CoreRunner` (a
    partition over an in-memory register, checked on the CPU) scores
    the same features and reasons under both packages."""
    factory = SEARCH._factory(str(tmp_path / "ignored"))

    def make():
        return {**factory(), "device": "cpu"}

    runner = search.CoreRunner(make, str(tmp_path / "search"),
                               {"iteration-deadline": 30.0})
    out = runner(search.Schedule(seed=5, events=(search.Event(
        "partition", 0.05, 0.2, params={"kind": "one"}, salt=1),)), "rec")
    assert not out["hang"] and not out["error"], out
    assert out["ledger"]
    assert search.signature(out) == r_search.signature(out)
    assert search.reasons(out) == r_search.reasons(out) == []


@pytest.mark.parametrize("seed", range(8))
def test_greedy_shrink_equals_the_reference(seed):
    """A planted predicate (each of three planted items is kept, as it
    is or simplified to one less): the same minimum in the same number
    of attempts."""
    rng = random.Random(seed)
    items = rng.sample(range(100), 20)
    planted = set(rng.sample(items, 3))

    def interesting(kept):
        return all(p in kept or p - 1 in kept for p in planted)

    def simplify(x):
        return x - 1 if x % 2 else None

    for budget in (6, 24, 64):
        assert search.greedy_shrink(
            items, tuple, interesting, simplify=simplify,
            max_attempts=budget) == r_search.greedy_shrink(
            items, tuple, interesting, simplify=simplify,
            max_attempts=budget)


# ---------------------------------------------------------------------
# The narrowed fail-open


def _analyze_bad(tmp_path):
    dicts = _bad_register_dicts(3)
    test = {"name": "f", "start-time": store.time_str(),
            "checker": Linearizable(cas_register(), device="cpu")}
    return core.analyze(test, History([Op.from_dict(d) for d in dicts]),
                        dir=str(tmp_path))


def test_linearizable_draws_its_counterexample(tmp_path):
    """An invalid verdict with a store directory: linear.svg there,
    named by "counterexample-file" (the reference's artifact)."""
    res = _analyze_bad(tmp_path)
    assert res["valid"] is False
    assert res["counterexample-file"] == str(tmp_path / "linear.svg")
    assert os.path.getsize(res["counterexample-file"]) > 0
    assert res["forensics"]["anomaly-count"] == 1


def test_device_fault_in_forensics_raises(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise DeviceUnavailable("CUDA asked for and missing")

    monkeypatch.setattr(forensics, "assemble", broken)
    with pytest.raises(DeviceUnavailable):
        _analyze_bad(tmp_path)


def test_other_forensics_errors_keep_the_verdict(tmp_path, monkeypatch,
                                                  caplog):
    def broken(*a, **kw):
        raise ValueError("a dossier bug")

    monkeypatch.setattr(forensics, "assemble", broken)
    with caplog.at_level("WARNING", logger="jepsen_tpu_torch.core"):
        res = _analyze_bad(tmp_path)
    assert res["valid"] is False and "forensics" not in res
    assert "forensics assembly failed" in caplog.text


def test_device_fault_inside_a_dossier_raises(tmp_path, monkeypatch):
    """The per-dossier catch re-raises a device fault too; a failing
    chart is logged and the dossier still written."""
    from jepsen_tpu_torch.ops.kernels import KernelLaunchError

    def launch_fails(*a, **kw):
        raise KernelLaunchError("witness_sweep: launch failed")

    monkeypatch.setattr(forensics, "minimize", launch_fails)
    with pytest.raises(KernelLaunchError):
        _analyze_bad(tmp_path / "a")
    monkeypatch.undo()
    monkeypatch.setattr(linviz, "render_analysis", lambda *a, **kw: (
        _ for _ in ()).throw(OSError("disk full")))
    res = _analyze_bad(tmp_path / "b")
    d = res["forensics"]["dossiers"][0]
    assert os.path.isfile(os.path.join(d["dir"], "counterexample.json"))
