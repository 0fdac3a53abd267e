"""The plan layer of the port (`jepsen_tpu_torch.plan`) against the JAX
package's (`jepsen_tpu.plan`), on the CPU.

Every case of tests/test_plan.py runs against the port (IR shapes and
validation, memo-key misses, the journal's round trip, torn tail,
oversize and duplicate puts, the untrained choosers, fit / predict /
support clamping, the model file, the cohort plan's order).  Across
the packages: equal inputs give byte-equal plan fingerprints, memo
keys and compiled cohort plans; a cost model the reference fitted and
saved loads in the port and predicts and chooses the same (within
1e-12); a memo journal either package wrote replays in the other; the
wire-packed plan decides as the reference's does.  One model pair for
the file: the JAX side compiles per model."""

import json
import math
import os

import numpy as np
import pytest
import torch

import jepsen_tpu.plan.cache as ref_cache
import jepsen_tpu.plan.compiler as ref_compiler
import jepsen_tpu.plan.costmodel as ref_costmodel
import jepsen_tpu.plan.ir as ref_ir
from jepsen_tpu.checker.linearizable import Linearizable as RefLinearizable
from jepsen_tpu.history.packed import pack_history as ref_pack
from jepsen_tpu.models.registers import CASRegister as RefCASRegister
from jepsen_tpu.models.registers import Register as RefRegister
from jepsen_tpu.utils.histgen import random_register_history as ref_gen
from jepsen_tpu_torch.checker import Linearizable
from jepsen_tpu_torch.checker.elle.graph import DepGraph, check_cycles
from jepsen_tpu_torch.history.packed import pack_history
from jepsen_tpu_torch.models.registers import CASRegister, Register
from jepsen_tpu_torch.plan import cache as plan_cache
from jepsen_tpu_torch.plan import costmodel, enabled
from jepsen_tpu_torch.plan.compiler import (_identity, compile_cohort_plan,
                                            compile_packs_plan, plan_cycle_fn,
                                            run_packs)
from jepsen_tpu_torch.plan.ir import PassFamily, PassNode, Plan, known_families
from jepsen_tpu_torch.utils.histgen import random_register_history

from chip_smoke import random_dep_graphs


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU work in these tests runs on one torch thread: the
    suite runs several test processes at once, and the checkers' worker
    threads, each with torch's parallel regions, would oversubscribe
    the cores and stall the other processes' budgeted tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_cache_state():
    for c in (plan_cache, ref_cache):
        c.reset_for_tests()
    for m in (costmodel, ref_costmodel):
        m.set_model_path(None)
    yield
    for c in (plan_cache, ref_cache):
        c.reset_for_tests()
    for m in (costmodel, ref_costmodel):
        m.set_model_path(None)


class _FakeChecker:
    streaming = True
    bound = None


# ---------------------------------------------------------------------
# IR (tests/test_plan.py's cases against the port)


def test_plan_ir_shapes_and_fingerprint():
    a = PassNode("a", "stream-witness", knobs={"segment": 4},
                 edges={"unknown": "b"})
    b = PassNode("b", "settle-exact", group=True)
    p = Plan([a, b], meta={"kind": "test"})
    assert list(p.nodes) == ["a", "b"]
    assert a.target("unknown") == "b"
    # Unlabelled edges fall back to the unknown edge.
    assert a.target("refuted") == "b"
    f1 = p.fingerprint()
    p2 = Plan([PassNode("a", "stream-witness", knobs={"segment": 8},
                        edges={"unknown": "b"}),
               PassNode("b", "settle-exact", group=True)])
    assert f1 != p2.fingerprint()  # knobs are part of the identity
    assert f1 == Plan([a, b], meta={"kind": "test"}).fingerprint()


def test_plan_rejects_backward_and_dangling_edges():
    with pytest.raises(ValueError):
        Plan([PassNode("a", "stream-witness",
                       edges={"unknown": "missing"})])
    b = PassNode("b", "settle-exact", edges={"unknown": "a"})
    with pytest.raises(ValueError):
        Plan([PassNode("a", "stream-witness"), b])  # backward edge


def test_builtin_families_registered():
    fams = known_families()
    for name in ("stream-witness", "refute-screen", "batched-bfs",
                 "settle-exact", "persistent-memo", "device-ladder",
                 "packs-exact", "elle-cycles"):
        assert name in fams, name
    # The same twelve families as the reference, in the same order.
    assert fams == ref_ir.known_families()


def test_pass_family_validation():
    with pytest.raises(ValueError):
        PassFamily("x", "sometimes-right", "device", lambda *a: None)
    with pytest.raises(ValueError):
        PassFamily("x", "exact", "quantum", lambda *a: None)


# ---------------------------------------------------------------------
# Persistent memo: invalidation semantics


def _lin(**kw):
    return Linearizable(Register(), device="cpu", **kw)


def _ident(lin, model=None):
    return _identity(lin, (model or Register()).packed(), "cohort")


def test_memo_key_misses_on_any_identity_change():
    lin = _lin()
    digest = "d" * 64
    base = plan_cache.memo_key(digest, _ident(lin))
    assert plan_cache.memo_key(digest, _ident(_lin())) == base
    assert plan_cache.memo_key(
        digest, _identity(lin, CASRegister().packed(), "cohort")) != base
    assert plan_cache.memo_key(
        digest, _ident(_lin(time_limit_s=5.0))) != base
    assert plan_cache.memo_key(
        digest, _ident(_lin(algorithm="linear"))) != base
    assert plan_cache.memo_key("e" * 64, _ident(lin)) != base
    assert plan_cache.memo_key(
        digest, _identity(lin, Register().packed(), "packs")) != base


def test_plan_memo_journal_roundtrip_and_warm_load(tmp_path):
    path = str(tmp_path / "plan-memo.jtpu")
    m1 = plan_cache.PlanMemo(path)
    assert m1.get("k1") is None  # miss
    m1.put("k1", {"valid": True, "algorithm": "wgl-tpu-stream"})
    m1.put("k2", {"valid": False, "algorithm": "settle"})
    got = m1.get("k1")
    assert got == {"valid": True, "algorithm": "wgl-tpu-stream"}
    got["valid"] = "mutated"  # caller-owned copy, store unaffected
    assert m1.get("k1")["valid"] is True
    m1.close()

    m2 = plan_cache.PlanMemo(path)  # fresh process stand-in
    assert m2.loaded == 2
    assert m2.get("k2") == {"valid": False, "algorithm": "settle"}
    m2.close()


def test_plan_memo_survives_torn_tail(tmp_path):
    path = str(tmp_path / "plan-memo.jtpu")
    m1 = plan_cache.PlanMemo(path)
    m1.put("k1", {"valid": True, "algorithm": "a"})
    m1.put("k2", {"valid": True, "algorithm": "b"})
    m1.close()
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 3)  # tear the last block
    m2 = plan_cache.PlanMemo(path)
    assert m2.get("k1") == {"valid": True, "algorithm": "a"}
    assert m2.get("k2") is None  # torn entry dropped, not corrupted
    m2.put("k3", {"valid": False, "algorithm": "c"})
    m2.close()
    m3 = plan_cache.PlanMemo(path)
    assert m3.get("k3") == {"valid": False, "algorithm": "c"}
    m3.close()


def test_memo_skips_oversize_and_duplicate_puts(tmp_path):
    m = plan_cache.PlanMemo(str(tmp_path / "m.jtpu"))
    m.put("k", {"valid": True, "blob": "x" * (plan_cache.MAX_ENTRY_BYTES + 1)})
    assert m.get("k") is None
    m.put("k", {"valid": True})
    m.put("k", {"valid": False})  # first write wins; no overwrite
    assert m.get("k") == {"valid": True}
    assert m.puts == 1
    m.close()


def test_cache_stats_report_no_compile_cache(tmp_path):
    assert plan_cache.stats() == {"dir": None, "memo": None,
                                  "xla_files": 0, "xla_enabled": False}
    plan_cache.configure(str(tmp_path))
    st = plan_cache.stats()
    assert st["dir"] == str(tmp_path) and st["memo"]["entries"] == 0
    assert (st["xla_files"], st["xla_enabled"]) == (0, False)
    assert not os.path.exists(tmp_path / "xla")


# ---------------------------------------------------------------------
# Cost model


def test_untrained_choosers_equal_legacy_formulas():
    for k in (1, 7, 8, 60, 2000):
        knobs, src = costmodel.choose_stream_knobs(k, 100 * k, model=None)
        assert src == "heuristic"
        assert knobs == {"segment": max(8, -(-k // 8)),
                         "max_restarts": max(8, k // 2)}
    knobs, src = costmodel.choose_batched_knobs(10, 1000, 48, model=None)
    assert (knobs, src) == ({"beam": 32}, "heuristic")
    assert costmodel.choose_tier_order(10, 1000, knobs, model=None) \
        == "stream-first"
    assert costmodel.choose_witness_block_knobs(1000, 900, model=None) == (
        {"bars_per_block": 2048, "blocks_per_call": 32}, "heuristic")
    for hwm in (0, 100, 384, 5000):
        assert costmodel.choose_finalize_chunk_rows(
            10, 1000, hwm, model=None) == (max(192, hwm // 2), "heuristic")


def _stream_rows():
    rows = []
    for seg, cost in ((2, 0.14), (4, 0.08), (8, 0.12), (16, 0.12)):
        for jitter in (0.0, 0.002, -0.002):
            rows.append({
                "pass": "stream",
                "features": {"keys": 60, "ops": 14000},
                "plan": {"segment": seg, "max_restarts": 30},
                "timing": {"execute_s": cost + jitter},
            })
    return rows


def test_fit_predict_and_support_clamping():
    model = costmodel.fit(_stream_rows(), min_samples=4)
    assert model.has("stream")
    sup = model.passes["stream"]["support"]
    assert sup["segment"] == [2.0, 16.0]
    knobs, src = costmodel.choose_stream_knobs(60, 14000, model=model)
    assert src == "model"
    assert 2 <= knobs["segment"] <= 16
    assert knobs["max_restarts"] == 30
    knobs, src = costmodel.choose_stream_knobs(4000, 9e6, model=model)
    assert src == "heuristic"


def test_model_file_roundtrip_and_graceful_failure(tmp_path):
    rows = [{"pass": "stream", "features": {"keys": 10, "ops": 100},
             "plan": {"segment": s, "max_restarts": 8},
             "timing": {"total_s": 0.01 * s}} for s in (2, 4, 8, 16)]
    model = costmodel.fit(rows, min_samples=4)
    path = str(tmp_path / "m.json")
    model.save(path)
    loaded = costmodel.CostModel.load(path)
    assert loaded is not None and loaded.has("stream")
    assert costmodel.CostModel.load(str(tmp_path / "nope.json")) is None
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert costmodel.CostModel.load(str(bad)) is None
    vbad = tmp_path / "vbad.json"
    vbad.write_text(json.dumps({"v": 999, "passes": {}}))
    assert costmodel.CostModel.load(str(vbad)) is None


def test_model_path_from_the_environment(tmp_path, monkeypatch):
    path = str(tmp_path / "m.json")
    costmodel.fit(_stream_rows(), min_samples=4).save(path)
    monkeypatch.setenv(costmodel.MODEL_ENV, path)
    costmodel.set_model_path(None)  # re-read the environment
    assert costmodel.model_info()["loaded"] is True
    assert costmodel.choose_stream_knobs(60, 14000)[1] == "model"


# ---------------------------------------------------------------------
# Compiler shape


def test_cohort_plan_mirrors_legacy_ladder_order():
    lin = _lin()
    plan, entry = compile_cohort_plan(
        _FakeChecker(), {}, lin, Register().packed(), 60, 6000,
        has_unpackable=True)
    ids = list(plan.nodes)
    assert ids[0] == "fallback"
    assert entry == "router"
    assert ids[-3:] == ["screen", "batched", "detail"]
    assert plan.nodes["screen"].target("refuted") == "detail"
    assert plan.nodes["screen"].target("unknown") == "batched"
    assert plan.nodes["batched"].target("unknown") == "detail"
    assert plan.nodes["stream"].knobs == {"segment": 8, "max_restarts": 30}
    assert plan.nodes["batched"].knobs == {"beam": 32}
    assert plan.meta["knobs"] == "heuristic"


# ---------------------------------------------------------------------
# Across the packages


def _plans(P, N):
    a = N("a", "stream-witness", knobs={"segment": 4, "max_restarts": 9},
          features={"keys": 3, "ops": 70}, edges={"unknown": "b"})
    b = N("b", "refute-screen", knobs={"mode": "classify"},
          edges={"refuted": "c", "unknown": "c"}, group=True)
    c = N("c", "settle-exact", group=True)
    return [P([a, b, c], meta={"kind": "cohort", "budget-s": None}),
            P([N("x", "device-ladder", knobs={"beam": 1024, "block": 256},
                 features={"ops": 10, "ok": 9})],
              meta={"kind": "single", "model": "cas-register"})]


def test_plan_fingerprints_are_byte_equal_across_packages():
    for mine, ref in zip(_plans(Plan, PassNode),
                         _plans(ref_ir.Plan, ref_ir.PassNode)):
        assert mine.to_dict() == ref.to_dict()
        assert mine.fingerprint() == ref.fingerprint()
        assert mine.describe() == ref.describe()


@pytest.mark.parametrize("kind", ["cohort", "packs", "single"])
@pytest.mark.parametrize("cas", [False, True])
@pytest.mark.parametrize("limit", [None, 7.5])
def test_memo_keys_are_equal_across_packages(kind, cas, limit):
    pm = (CASRegister() if cas else Register()).packed()
    ref_pm = (RefCASRegister() if cas else RefRegister()).packed()
    mine = _identity(_lin(time_limit_s=limit), pm, kind)
    ref = ref_compiler._identity(RefLinearizable(RefRegister(),
                                                 time_limit_s=limit),
                                 ref_pm, kind)
    assert mine == ref
    assert plan_cache.memo_key("ab" * 32, mine) == \
        ref_cache.memo_key("ab" * 32, ref)


@pytest.mark.parametrize("n_keys,n_ops,unpackable,session,cache_on", [
    (60, 6000, True, False, False),
    (1, 40, False, True, False),
    (500, 51000, False, False, True),
    (9, 900, True, True, True),
])
def test_cohort_plans_are_equal_across_packages(
        n_keys, n_ops, unpackable, session, cache_on, tmp_path):
    if cache_on:
        plan_cache.configure(str(tmp_path / "port"))
        ref_cache.configure(str(tmp_path / "ref"))
    test = {"streaming-session": object()} if session else {}
    mine, e1 = compile_cohort_plan(
        _FakeChecker(), test, _lin(time_limit_s=30.0),
        CASRegister().packed(), n_keys, n_ops, has_unpackable=unpackable)
    ref, e2 = ref_compiler.compile_cohort_plan(
        _FakeChecker(), test, RefLinearizable(RefRegister(),
                                              time_limit_s=30.0),
        RefCASRegister().packed(), n_keys, n_ops,
        has_unpackable=unpackable)
    assert e1 == e2
    assert mine.to_dict() == ref.to_dict()
    assert mine.fingerprint() == ref.fingerprint()
    pm1, _ = compile_packs_plan(_lin(), CASRegister().packed(), n_keys, n_ops)
    pm2, _ = ref_compiler.compile_packs_plan(
        RefLinearizable(RefRegister()), RefCASRegister().packed(), n_keys,
        n_ops)
    assert pm1.fingerprint() == pm2.fingerprint()


def _trained_rows():
    """Profile records of every pass the choosers read, spread over
    their knob grids and shapes."""
    rng = np.random.default_rng(7)
    rows = []
    for i in range(40):
        keys = int(rng.integers(1, 400))
        ops = keys * int(rng.integers(20, 200))
        seg = [2, 8, 16, 32, 64][i % 5]
        rows.append({"pass": "stream",
                     "features": {"keys": keys, "ops": ops},
                     "plan": {"segment": seg,
                              "max_restarts": max(8, keys // 2)},
                     "timing": {"execute_s": float(rng.uniform(0.01, 2))}})
        rows.append({"pass": "batched",
                     "features": {"keys": keys, "ops": ops},
                     "plan": {"beam": [32, 64, 128][i % 3]},
                     "timing": {"total_s": float(rng.uniform(0.01, 2))}})
        bars, nb = [(512, 32), (1024, 32), (2048, 32), (4096, 16)][i % 4]
        rows.append({"pass": "witness",
                     "features": {"ops": ops * 10, "ok": ops * 9},
                     "plan": {"bars_per_block": bars, "blocks_per_call": nb},
                     "timing": {"execute_s": float(rng.uniform(0.01, 2))},
                     "cost": {"flops": float(ops), "bytes_accessed": 1e6}})
    return rows


def test_reference_fitted_model_predicts_and_chooses_alike(tmp_path):
    path = str(tmp_path / "model.json")
    ref_model = ref_costmodel.fit(_trained_rows())
    ref_model.save(path)
    mine = costmodel.CostModel.load(path)
    ref = ref_costmodel.CostModel.load(path)
    assert mine is not None and sorted(mine.passes) == sorted(ref.passes)
    # The port's own fit of the same records equals the reference's.
    assert costmodel.fit(_trained_rows()).to_dict() == ref_model.to_dict()
    rng = np.random.default_rng(3)
    for _ in range(30):
        keys = int(rng.integers(1, 500))
        ops = keys * int(rng.integers(10, 300))
        feats = {"keys": keys, "ops": ops, "ok": ops // 2}
        for name, plan in (("stream", {"segment": 8, "max_restarts": 30}),
                           ("batched", {"beam": 64}),
                           ("witness", {"bars_per_block": 1024,
                                        "blocks_per_call": 32})):
            a = mine.predict_s(name, feats, plan)
            b = ref.predict_s(name, feats, plan)
            assert math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-12)
        assert costmodel.choose_stream_knobs(keys, ops, model=mine) == \
            ref_costmodel.choose_stream_knobs(keys, ops, model=ref)
        assert costmodel.choose_batched_knobs(keys, ops, 1024,
                                              model=mine) == \
            ref_costmodel.choose_batched_knobs(keys, ops, 1024, model=ref)
        assert costmodel.choose_witness_block_knobs(ops, ops // 2,
                                                    model=mine) == \
            ref_costmodel.choose_witness_block_knobs(ops, ops // 2,
                                                     model=ref)
        assert costmodel.choose_finalize_chunk_rows(keys, ops, ops // 3,
                                                    model=mine) == \
            ref_costmodel.choose_finalize_chunk_rows(keys, ops, ops // 3,
                                                     model=ref)
        sk = costmodel.choose_stream_knobs(keys, ops, model=mine)[0]
        assert costmodel.choose_tier_order(keys, ops, sk, model=mine) == \
            ref_costmodel.choose_tier_order(keys, ops, sk, model=ref)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_memo_journal_replays_in_the_other_package(writer, tmp_path):
    path = str(tmp_path / plan_cache.MEMO_FILE)
    W, R = ((ref_cache, plan_cache) if writer == "reference"
            else (plan_cache, ref_cache))
    entries = {f"k{i}": {"valid": i % 2 == 0, "algorithm": "wgl-tpu",
                         "configs-explored": i, "set": [i, "x"]}
               for i in range(6)}
    m = W.PlanMemo(path)
    for k, v in entries.items():
        m.put(k, v)
    m.close()
    r = R.PlanMemo(path)
    assert r.loaded == len(entries)
    for k, v in entries.items():
        assert r.get(k) == v
    r.put("extra", {"valid": True})  # appends after the other's blocks
    r.close()
    again = W.PlanMemo(path)
    assert again.loaded == len(entries) + 1
    again.close()


def test_packs_plan_decides_like_the_reference():
    """run_packs (the wire-packed route) on a few keys, valid and bad,
    through the stream, the decide-mode screen and the exact engine."""
    ref_model, model = RefCASRegister(), CASRegister()
    ref_pm, pm = ref_model.packed(), model.packed()
    packs, ref_packs = {}, {}
    for i in range(6):
        kw = dict(procs=3, info_rate=0.05, seed=100 + i, bad=i in (1, 4))
        ref_packs[f"k{i}"] = ref_pack(ref_gen(60, **kw), ref_pm.encode)
        packs[f"k{i}"] = pack_history(random_register_history(60, **kw),
                                      pm.encode)
    got = run_packs(packs, model, Linearizable(model, device="cpu"), None,
                    device="cpu")
    want = ref_compiler.run_packs(ref_packs, ref_model,
                                  RefLinearizable(ref_model), None)
    for k in packs:
        assert (got[k]["valid"], got[k]["algorithm"]) == \
            (want[k]["valid"], want[k]["algorithm"]), k
    assert [k for k in packs if got[k]["valid"] is False] == ["k1", "k4"]


def test_plan_cycle_fn_routes_through_one_node_plan():
    assert plan_cycle_fn("off") is None
    run = plan_cycle_fn("cpu")
    graphs = random_dep_graphs(12, seed=5, DepGraph=DepGraph)
    assert any(check_cycles(g) for g in graphs)
    for g in graphs:
        assert run(g) == check_cycles(g)


def test_plan_routing_flag(monkeypatch):
    monkeypatch.delenv("JEPSEN_PLAN", raising=False)
    assert enabled()
    for off in ("0", "false", "off", "OFF"):
        monkeypatch.setenv("JEPSEN_PLAN", off)
        assert not enabled()
    monkeypatch.setenv("JEPSEN_PLAN", "1")
    assert enabled()


def test_plan_off_drops_the_model_and_the_memo(tmp_path, monkeypatch):
    """`JEPSEN_PLAN=0` sends the reference to its hand-wired ladder; the
    port's checks execute the same plan, with the hand formulas for
    every knob and no persistent memo."""
    path = str(tmp_path / "m.json")
    costmodel.fit(_stream_rows(), min_samples=4).save(path)
    monkeypatch.setenv(costmodel.MODEL_ENV, path)
    costmodel.set_model_path(None)
    plan_cache.configure(str(tmp_path / "cache"))
    try:
        monkeypatch.setenv("JEPSEN_PLAN", "0")
        assert costmodel.active_model() is None
        assert costmodel.choose_stream_knobs(60, 14000)[1] == "heuristic"
        assert plan_cache.cache_dir() is None
        assert plan_cache.active_memo() is None
        monkeypatch.delenv("JEPSEN_PLAN")
        assert costmodel.choose_stream_knobs(60, 14000)[1] == "model"
        assert plan_cache.cache_dir() == str(tmp_path / "cache")
        assert plan_cache.active_memo() is not None
    finally:
        plan_cache.reset_for_tests()
        costmodel.set_model_path(None)
