"""The port's Elle checkers (jepsen_tpu_torch/checker/elle, txn.py and
the history pairing they need) against the JAX package's on the CPU.

Every literal history of tests/test_elle.py, the histories of
chip_smoke.py's phase 8 generators at 300 transactions (valid and with
injected anomalies) and two interpreter runs of the reference workloads
go through both packages: analyze_append / analyze_wr on the host and
device-screened (the port on device="cpu", the JAX package on
JAX_PLATFORMS=cpu) under every consistency model, and AppendChecker /
WrChecker with the artifacts they write.  The results (valid,
anomaly-types, anomalies, edges) must be equal exactly."""

import os
import random

import pytest
import torch

import jepsen_tpu.checker.elle as ref_elle
import jepsen_tpu.history.core as ref_hc
import jepsen_tpu.txn as ref_txn
from chip_smoke import (ELLE_ANOMALIES, ELLE_CHAIN, elle_ops,
                        random_dep_graphs)
from jepsen_tpu_torch import device as D
from jepsen_tpu_torch import txn
from jepsen_tpu_torch.checker import elle
from jepsen_tpu_torch.checker.elle import graph as port_graph
from jepsen_tpu_torch.history import core as hc

MODELS = ("read-uncommitted", "read-committed", "repeatable-read",
          "serializable", "strict-serializable",
          "strong-session-serializable")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU work in these tests runs on one thread: the suite
    runs several test processes at once, and on oversubscribed cores
    torch's parallel regions in the extraction's per-level loop stall
    and take the other processes' cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(rows, reindex=None):
    """(reference History, port History) of the same op dicts."""
    return (ref_hc.History([ref_hc.Op(**r) for r in rows], reindex=reindex),
            hc.History([hc.Op(**r) for r in rows], reindex=reindex))


def t(index, typ, value, process=0):
    """tests/test_elle.py's `t`: a txn op with its index and time."""
    return {"type": typ, "f": "txn", "value": value, "process": process,
            "index": index, "time": index}


def o(typ, value, process):
    return {"type": typ, "f": "txn", "value": value, "process": process}


#: (kind, rows, reindex) of every literal history in tests/test_elle.py
#: and tests/test_scc_device.py's checker case.
LITERAL = {
    "append-valid": ("append", [
        t(0, "ok", [["append", "x", 0]]), t(1, "ok", [["append", "x", 1]]),
        t(2, "ok", [["r", "x", [0, 1]]])], False),
    "append-g1a": ("append", [
        t(0, "fail", [["append", "x", 0]]), t(1, "ok", [["r", "x", [0]]])],
        False),
    "append-g1b": ("append", [
        t(0, "ok", [["append", "x", 0], ["append", "x", 1]]),
        t(1, "ok", [["r", "x", [0]]])], False),
    "append-incompatible-order": ("append", [
        t(0, "ok", [["r", "x", [0, 1]]]), t(1, "ok", [["r", "x", [1, 0]]])],
        False),
    "append-g0": ("append", [
        t(0, "ok", [["append", "x", 0], ["append", "y", 1]]),
        t(1, "ok", [["append", "y", 0], ["append", "x", 1]]),
        t(2, "ok", [["r", "x", [0, 1]], ["r", "y", [0, 1]]])], False),
    "append-g1c": ("append", [
        t(0, "ok", [["append", "x", 0], ["r", "y", [0]]]),
        t(1, "ok", [["append", "y", 0], ["r", "x", [0]]])], False),
    "append-g-single": ("append", [
        t(0, "ok", [["r", "x", []], ["r", "y", [0]]]),
        t(1, "ok", [["append", "x", 0], ["append", "y", 0]]),
        t(2, "ok", [["r", "x", [0]]])], False),
    "append-internal": ("append", [
        t(0, "ok", [["append", "x", 5], ["r", "x", [1, 2]]])], False),
    "append-info-tolerated": ("append", [
        t(0, "info", [["append", "x", 0]]), t(1, "ok", [["r", "x", [0]]])],
        False),
    "append-unobserved-writer": ("append", [
        t(0, "ok", [["r", "x", [99]]])], False),
    "append-session-lost-own-append": ("append", [
        o("invoke", [["append", "x", 1]], 0),
        o("ok", [["append", "x", 1]], 0),
        o("invoke", [["r", "x", None]], 1), o("ok", [["r", "x", [1]]], 1),
        o("invoke", [["r", "x", None]], 0), o("ok", [["r", "x", []]], 0)],
        None),
    "append-checker-g0": ("append", [
        o("invoke", [("append", "x", 1), ("append", "y", 1)], 0),
        o("invoke", [("append", "y", 2), ("append", "x", 2)], 1),
        o("ok", [("append", "x", 1), ("append", "y", 1)], 0),
        o("ok", [("append", "y", 2), ("append", "x", 2)], 1),
        o("invoke", [("r", "x", None), ("r", "y", None)], 2),
        o("ok", [("r", "x", [2, 1]), ("r", "y", [1, 2])], 2)], None),
    "append-checker-good": ("append", [
        o("invoke", [("append", "x", 1)], 0),
        o("ok", [("append", "x", 1)], 0),
        o("invoke", [("r", "x", None)], 1), o("ok", [("r", "x", [1])], 1)],
        None),
    "wr-valid": ("wr", [
        t(0, "ok", [["w", "x", 1]]), t(1, "ok", [["r", "x", 1]])], False),
    "wr-g1a": ("wr", [
        t(0, "fail", [["w", "x", 1]]), t(1, "ok", [["r", "x", 1]])], False),
    "wr-g1b": ("wr", [
        t(0, "ok", [["w", "x", 1], ["w", "x", 2]]),
        t(1, "ok", [["r", "x", 1]])], False),
    "wr-unwritten-read": ("wr", [t(0, "ok", [["r", "x", 99]])], False),
    "wr-g1c": ("wr", [
        t(0, "ok", [["w", "x", 1], ["r", "y", 1]]),
        t(1, "ok", [["w", "y", 1], ["r", "x", 1]])], False),
    "wr-ww-cycle-intra-txn": ("wr", [
        t(0, "ok", [["w", "x", 1], ["w", "y", 1]]),
        t(1, "ok", [["r", "x", 1], ["w", "x", 2], ["r", "y", 2],
                    ["w", "y", 3]]),
        t(2, "ok", [["r", "y", 1], ["w", "y", 2], ["r", "x", 2],
                    ["w", "x", 3]])], False),
    "wr-realtime-stale-initial-read": ("wr", [
        o("invoke", [["w", "x", 1]], 0), o("ok", [["w", "x", 1]], 0),
        o("invoke", [["r", "x", None]], 1), o("ok", [["r", "x", None]], 1)],
        None),
    "wr-session-read-your-writes": ("wr", [
        o("invoke", [["w", "x", 1]], 0), o("ok", [["w", "x", 1]], 0),
        o("invoke", [["r", "x", None]], 0), o("ok", [["r", "x", None]], 0)],
        None),
    "wr-sequential-keys-stale-read": ("wr", [
        o("invoke", [["w", "x", 1]], 0), o("ok", [["w", "x", 1]], 0),
        o("invoke", [["w", "x", 2]], 0), o("ok", [["w", "x", 2]], 0),
        o("invoke", [["r", "x", None], ["w", "y", 1]], 1),
        o("ok", [["r", "x", 2], ["w", "y", 1]], 1),
        o("invoke", [["r", "y", None], ["r", "x", None]], 2),
        o("ok", [["r", "y", 1], ["r", "x", 1]], 2)], None),
    "wr-sequential-keys-overlapping": ("wr", [
        o("invoke", [["w", "x", 1]], 0), o("invoke", [["w", "x", 2]], 1),
        o("ok", [["w", "x", 1]], 0), o("ok", [["w", "x", 2]], 1),
        o("invoke", [["r", "x", None]], 2), o("ok", [["r", "x", 1]], 2)],
        None),
    "wr-internal-own-write": ("wr", [
        o("ok", [["w", "x", 1], ["r", "x", 2], ["w", "y", 2]], 0),
        o("ok", [["w", "x", 2]], 1)], None),
    "wr-nonrepeatable-read": ("wr", [
        o("ok", [["w", "x", 1]], 0), o("ok", [["w", "x", 2]], 1),
        o("ok", [["r", "x", 1], ["r", "x", 2]], 2)], None),
    "wr-self-consistent": ("wr", [
        o("ok", [["w", "x", 1], ["r", "x", 1], ["r", "x", 1]], 0),
        o("ok", [["r", "x", 1], ["w", "x", 2], ["r", "x", 2]], 1)], None),
}


def analyses(kind, ref_h, port_h, model, seq=False):
    """[(reference result, port result)] host and device-screened."""
    kw = {"consistency_model": model}
    if kind == "wr":
        kw["sequential_keys"] = seq
    ref_an = ref_elle.analyze_append if kind == "append" else ref_elle.analyze_wr
    port_an = elle.analyze_append if kind == "append" else elle.analyze_wr
    return [
        (ref_an(ref_h, **kw), port_an(port_h, **kw)),
        (ref_an(ref_h, cycle_fn=ref_elle._device_cycle_fn("on"), **kw),
         port_an(port_h, cycle_fn=elle._device_cycle_fn("cpu"), **kw)),
    ]


@pytest.mark.parametrize("name", sorted(LITERAL))
def test_literal_analysis_equals_reference(name):
    kind, rows, reindex = LITERAL[name]
    ref_h, port_h = both(rows, reindex)
    for model in MODELS:
        for seq in ((False, True) if kind == "wr" else (False,)):
            for want, got in analyses(kind, ref_h, port_h, model, seq):
                assert got == want, (name, model, seq)


#: Verdicts tests/test_elle.py asserts, held on the port's results.
EXPECTED = [
    ("append-valid", "serializable", False, True, None),
    ("append-g1a", "serializable", False, False, "G1a"),
    ("append-g1b", "serializable", False, False, "G1b"),
    ("append-incompatible-order", "serializable", False, False,
     "incompatible-order"),
    ("append-g0", "serializable", False, False, "G0"),
    ("append-g1c", "serializable", False, False, "G1c"),
    ("append-g-single", "serializable", False, False, "G-single"),
    ("append-internal", "serializable", False, False, "internal"),
    ("append-info-tolerated", "serializable", False, True, None),
    ("append-unobserved-writer", "serializable", False, False,
     "unobserved-writer"),
    ("append-session-lost-own-append", "serializable", False, True, None),
    ("append-session-lost-own-append", "strong-session-serializable",
     False, False, "G-single"),
    ("wr-valid", "serializable", False, True, None),
    ("wr-g1a", "serializable", False, False, "G1a"),
    ("wr-g1b", "serializable", False, False, "G1b"),
    ("wr-unwritten-read", "serializable", False, False, "unwritten-read"),
    ("wr-g1c", "serializable", False, False, "G1c"),
    ("wr-realtime-stale-initial-read", "serializable", False, True, None),
    ("wr-realtime-stale-initial-read", "strict-serializable", False,
     False, "G-single"),
    ("wr-session-read-your-writes", "serializable", False, True, None),
    ("wr-session-read-your-writes", "strong-session-serializable", False,
     False, "G-single"),
    ("wr-sequential-keys-stale-read", "serializable", False, True, None),
    ("wr-sequential-keys-overlapping", "serializable", True, True, None),
    ("wr-internal-own-write", "serializable", False, False, "internal"),
    ("wr-nonrepeatable-read", "serializable", False, False,
     "nonrepeatable-read"),
    ("wr-self-consistent", "serializable", False, True, None),
]


@pytest.mark.parametrize("name,model,seq,valid,anomaly", EXPECTED)
def test_literal_verdicts(name, model, seq, valid, anomaly):
    kind, rows, reindex = LITERAL[name]
    _, port_h = both(rows, reindex)
    for res in port_results(kind, port_h, model, seq):
        assert res["valid"] is valid, res
        if anomaly:
            assert anomaly in res["anomaly-types"]


def port_results(kind, h, model, seq):
    kw = {"consistency_model": model}
    if kind == "wr":
        kw["sequential_keys"] = seq
    an = elle.analyze_append if kind == "append" else elle.analyze_wr
    return [an(h, **kw),
            an(h, cycle_fn=elle._device_cycle_fn("cpu"), **kw)]


def test_sequential_keys_convicts_stale_read():
    _, port_h = both(LITERAL["wr-sequential-keys-stale-read"][1])
    for res in port_results("wr", port_h, "serializable", True):
        assert res["valid"] is False
        assert {"G-single", "G2-item"} & set(res["anomaly-types"])


def test_realtime_needs_a_paired_history():
    rows = LITERAL["wr-realtime-stale-initial-read"][1]
    ops = [hc.Op(**r) for r in rows]
    with pytest.raises(ValueError, match="paired History"):
        elle.analyze_wr(ops, consistency_model="strict-serializable")
    with pytest.raises(ValueError, match="paired History"):
        elle.analyze_wr(ops, sequential_keys=True)


# -- the checkers and their artifacts ----------------------------------------


def read_tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p) as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("name", sorted(LITERAL))
def test_literal_checkers_and_artifacts_equal_reference(name, tmp_path):
    kind, rows, reindex = LITERAL[name]
    rows = rows + [{"type": "info", "f": "start", "value": None,
                    "process": "nemesis"}]  # client_ops drops it
    ref_h, port_h = both(rows, reindex)
    ref_c = ref_elle.AppendChecker if kind == "append" else ref_elle.WrChecker
    port_c = elle.AppendChecker if kind == "append" else elle.WrChecker
    for model in ("serializable", "strict-serializable"):
        for ref_dev, port_dev in (("off", "off"), ("on", "cpu")):
            a, b = tmp_path / f"ref-{model}-{ref_dev}", tmp_path / \
                f"port-{model}-{port_dev}"
            want = ref_c(model, device=ref_dev).check({}, ref_h,
                                                      {"dir": str(a)})
            got = port_c(model, device=port_dev).check({}, port_h,
                                                       {"dir": str(b)})
            assert got == want
            assert read_tree(b) == read_tree(a)
            assert bool(read_tree(b)) == (got["valid"] is not True)


def test_write_artifacts_survives_unwritable_dir(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    bad = {"valid": False, "anomaly-types": ["G0"],
           "anomalies": {"G0": [{"type": "G0", "cycle": [1, 2, 1],
                                 "steps": []}]}}
    elle.write_artifacts(bad, {"dir": str(blocker)}, "elle-append")
    elle.write_artifacts({"valid": True}, {"dir": str(tmp_path / "ok")})
    assert not (tmp_path / "ok").exists()


@pytest.mark.parametrize("make", [
    lambda: elle.AppendChecker(),
    lambda: elle.WrChecker(),
    lambda: elle.AppendChecker(device="auto"),
    lambda: elle.AppendChecker(device="on"),
    lambda: elle.WrChecker("strict-serializable", device="cuda"),
])
def test_checkers_raise_without_cuda(monkeypatch, make):
    """With no card, a checker not told "cpu" or "off" raises before it
    analyzes anything: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, h = both(LITERAL["append-checker-g0"][1])
    calls = []
    monkeypatch.setattr(elle, "analyze_append",
                        lambda *a, **k: calls.append(1))
    monkeypatch.setattr(elle, "analyze_wr", lambda *a, **k: calls.append(1))
    D.counters.clear()
    with pytest.raises(D.DeviceUnavailable):
        make().check({}, h, {})
    assert calls == [] and D.counters["scc_screens"] == 0


def test_checkers_off_and_cpu_need_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, h = both(LITERAL["append-checker-g0"][1])
    for dev in ("off", "cpu"):
        assert elle.AppendChecker(device=dev).check({}, h, {})["valid"] \
            is False


# -- the graph machinery ------------------------------------------------------


GRAPHS = {
    "three-cycle-plus-tail": [(1, 2, "ww"), (2, 3, "ww"), (3, 1, "ww"),
                              (3, 4, "ww")],
    "g1c": [(1, 2, "wr"), (2, 1, "ww")],
    "g-single": [(1, 2, "rw"), (2, 1, "ww")],
    "g2-item": [(1, 2, "rw"), (2, 1, "rw")],
    "no-masking": [(1, 2, "wr"), (2, 1, "ww"), (1, 3, "rw"), (3, 1, "ww")],
    "untyped": [(0, 1, "realtime"), (1, 0, "process")],
    "two-sccs": [(0, 1, "ww"), (1, 0, "wr"), (5, 6, "rw"), (6, 7, "ww"),
                 (7, 5, "rw"), (1, 5, "ww")],
}


def graph_pair(edges):
    out = []
    for G in (ref_elle.DepGraph, port_graph.DepGraph):
        g = G()
        for a, b, ty in edges:
            g.add_edge(a, b, ty)
        out.append(g)
    return out


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_machinery_equals_reference(name):
    r, p = graph_pair(GRAPHS[name])
    assert p.sccs() == r.sccs()
    assert port_graph.check_cycles(p) == ref_elle.check_cycles(r)
    for comp in r.sccs():
        assert p.find_cycle_in(comp) == r.find_cycle_in(comp)
        for src in comp:
            for dst in r.out_edges(src):
                assert (port_graph.find_cycle_with_edge(p, src, dst, comp)
                        == ref_elle.graph.find_cycle_with_edge(r, src, dst,
                                                               comp))
    assert p.n_edges() == r.n_edges()
    assert p.restricted(["ww"]).adj == r.restricted(["ww"]).adj


def test_graph_classification():
    for name, want in (("g1c", "G1c"), ("g-single", "G-single"),
                       ("g2-item", "G2-item"),
                       ("three-cycle-plus-tail", "G0")):
        _, p = graph_pair(GRAPHS[name])
        assert port_graph.check_cycles(p)[0]["type"] == want
    _, p = graph_pair(GRAPHS["no-masking"])
    types = {c["type"] for c in port_graph.check_cycles(p)}
    assert "G1c" in types and types & {"G-single", "G2-item"}


# -- txn helpers and history pairing ------------------------------------------


def random_txns(seed, n=200):
    rng = random.Random(seed)
    return [[[rng.choice(("r", "w", "append")), rng.randrange(4),
              rng.randrange(5)] for _ in range(rng.randint(0, 6))]
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_txn_helpers_equal_reference(seed):
    assert txn.ext_reads([["r", "x", 1], ["w", "x", 2], ["r", "x", 2],
                          ["r", "y", 9]]) == {"x": 1, "y": 9}
    for t_ in random_txns(seed):
        assert txn.ext_reads(t_) == ref_txn.ext_reads(t_)
        assert txn.ext_writes(t_) == ref_txn.ext_writes(t_)
        assert txn.int_reads(t_) == ref_txn.int_reads(t_)
        assert txn.writes(t_) == ref_txn.writes(t_)
        assert (txn.reduce_mops(lambda a, m: a + [m[1]], [], t_)
                == ref_txn.reduce_mops(lambda a, m: a + [m[1]], [], t_))


@pytest.mark.parametrize("kind,bad", [("append", False), ("wr", True)])
def test_history_pairing_equals_reference(kind, bad):
    rows = elle_ops(kind, 300, 11, inject=("G-single",) if bad else ())
    rows.insert(7, {"type": "invoke", "f": "start", "value": None,
                    "process": "nemesis"})
    rows.insert(40, {"type": "info", "f": "start", "value": None,
                     "process": "nemesis"})
    rows.insert(50, {"type": "invoke", "f": "txn", "value": [],
                     "process": 999})  # never completes
    ref_h, port_h = both(rows)
    for view_r, view_p in ((ref_h, port_h),
                           (ref_h.client_ops(), port_h.client_ops())):
        assert [x.index for x in view_p] == [x.index for x in view_r]
        for x in view_r:
            assert view_p.pair_index(x.index) == view_r.pair_index(x.index)
            for f in ("completion", "invocation"):
                want, got = getattr(view_r, f)(x), getattr(view_p, f)(x.index)
                assert (got and got.index) == (want and want.index)
    assert port_h.completion(50) is None


# -- phase 8's generators at 300 transactions ---------------------------------


INJECT = {"append": ("G0", "G1c", "G-single"), "wr": ("G1c", "G-single")}


@pytest.mark.parametrize("kind,bad", [("append", False), ("append", True),
                                      ("wr", False), ("wr", True)])
def test_generated_histories_equal_reference(kind, bad):
    """300 committed transactions (with :info writers, about 304
    vertices: the injected ones extract on the device path, V = 512),
    every consistency model, host and device-screened."""
    rows = elle_ops(kind, 300, 5, inject=INJECT[kind] if bad else ())
    ref_h, port_h = both(rows)
    for model in MODELS:
        results = analyses(kind, ref_h, port_h, model)
        for want, got in results:
            assert got == want, model
        host, dev = (r[1] for r in results)
        if not bad:
            assert host["valid"] is True and dev["valid"] is True
        else:
            assert dev["valid"] is not True and dev["valid"] == host["valid"]
            assert set(INJECT[kind]) <= set(dev["anomaly-types"])
            assert dev["anomaly-types"] == host["anomaly-types"]


def test_generated_injection_extracts_on_device():
    rows = elle_ops("append", 300, 5, inject=INJECT["append"])
    _, h = both(rows)
    D.counters.clear()
    res = elle.AppendChecker(device="cpu").check({}, h, {})
    assert D.counters["scc_extractions"] == 1
    assert {"G0", "G1c", "G-single"} <= set(res["anomaly-types"])
    for recs in res["anomalies"].values():
        for r in recs:
            if "cycle" in r:
                assert r["scc-size"] >= len(r["cycle"]) - 1


@pytest.mark.parametrize("model", ["serializable", "strict-serializable"])
def test_generated_long_cycle_equals_reference(model):
    """phase 8b-chain's anomaly at 300 transactions (about 400 vertices:
    the device extraction, V = 512): a G-single whose cycle runs
    through its 100-transaction ww chain, so the extraction's BFS walks
    99 levels; equal to the JAX package host and device-screened."""
    rows = elle_ops("append", 300, 5, inject=("G-single-chain",))
    ref_h, port_h = both(rows)
    for want, got in analyses("append", ref_h, port_h, model):
        assert got == want
    D.counters.clear()
    res = elle.AppendChecker(model, device="cpu").check({}, port_h, {})
    assert res["valid"] is False and res["anomaly-types"] == ["G-single"]
    assert D.counters["scc_extractions"] == 1
    assert D.counters["scc_bfs_levels"] == ELLE_CHAIN - 1
    (rec,) = res["anomalies"]["G-single"]
    assert len(rec["cycle"]) == ELLE_CHAIN + 1
    assert rec["scc-size"] == ELLE_CHAIN


def test_generator_shape():
    rows = elle_ops("append", 300, 3)
    oks = [r for r in rows if r["type"] == "ok"]
    infos = [r for r in rows if r["type"] == "info"]
    invokes = [r for r in rows if r["type"] == "invoke"]
    assert len(oks) == 300 and len(invokes) == len(oks) + len(infos)
    assert 0 < len(infos) < 40
    # a worker goes on under a fresh process after each :info
    assert 10 < len({r["process"] for r in rows}) <= 10 + len(infos)
    assert elle_ops("append", 300, 3) == rows  # seeded
    bad = elle_ops("wr", 300, 3, inject=("G1c", "G-single"))
    keys = {m[1] for r in bad if r["type"] == "ok" for m in r["value"]}
    assert {"g1c-x", "g1c-y", "gs-x", "gs-y"} <= keys
    assert len([r for r in bad if r["type"] == "ok"]) == 300 + sum(
        len(ELLE_ANOMALIES["wr"][a]) for a in ("G1c", "G-single"))


def test_random_dep_graphs_half_cyclic():
    graphs = random_dep_graphs(64, 9, port_graph.DepGraph)
    cyclic = sum(bool(g.sccs()) for g in graphs)
    assert 16 < cyclic < 48
    assert all(16 <= len(g.vertices) <= 128 for g in graphs)


# -- interpreter runs of the reference workloads ------------------------------


@pytest.mark.parametrize("kind", ["append", "wr"])
def test_workload_run_equals_reference(kind):
    """A history from the JAX package's interpreter running its
    list-append / rw-register workload, checked by both packages."""
    from jepsen_tpu import generator as gen
    from jepsen_tpu import interpreter
    from jepsen_tpu import nemesis as nem
    from jepsen_tpu.workloads import append as wa
    from jepsen_tpu.workloads import wr as ww

    wl = (wa if kind == "append" else ww).workload({"seed": 7})
    test = {"concurrency": 6, "nodes": ["n1"], "client": wl["client"],
            "nemesis": nem.noop,
            "generator": gen.time_limit(
                0.4, gen.clients(gen.stagger(0.002, wl["generator"])))}
    ref_h = interpreter.run(test)
    rows = [{"type": x.type, "f": x.f, "value": x.value,
             "process": x.process, "time": x.time, "index": x.index}
            for x in ref_h]
    _, port_h = both(rows)
    ref_c = ref_elle.AppendChecker if kind == "append" else ref_elle.WrChecker
    port_c = elle.AppendChecker if kind == "append" else elle.WrChecker
    for model in ("serializable", "strict-serializable"):
        want = ref_c(model, device="on").check({}, ref_h, {})
        got = port_c(model, device="cpu").check({}, port_h, {})
        assert got == want
        assert got["valid"] in (True, "unknown")
