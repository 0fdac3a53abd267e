"""The port's roofline accounting (jepsen_tpu_torch/telemetry/roofline.py).

* `annotate`, `summarize` and `export_gauges` equal the reference's on
  the same records, TPU kinds included;
* the H100 SXM peaks, and the calibration probe (cached on disk) for a
  CUDA device the registry does not know;
* each cost function equal to a count by brute force on a tiny input;
* profile records carry non-null `cost` and `roofline` blocks for the
  passes that noted a cost (witness, bfs, stream, batched, elle), and
  explicit nulls where none was noted.
"""

import itertools

import numpy as np
import pytest
import torch

import jepsen_tpu.telemetry as ref_telemetry
from jepsen_tpu.telemetry import profile as ref_profile
from jepsen_tpu.telemetry import roofline as ref_roofline
from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.telemetry import profile, roofline

H100 = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3"}


@pytest.fixture(autouse=True)
def _scope(monkeypatch, tmp_path):
    """Telemetry on with a clean registry, calibration caches in a temp
    dir, one torch thread; everything restored after."""
    monkeypatch.setenv(roofline.CACHE_ENV, str(tmp_path / "peaks"))
    monkeypatch.setenv(ref_roofline.CACHE_ENV,
                       str(tmp_path / "ref-cpu-peaks.json"))
    monkeypatch.setattr(ref_roofline, "_cpu_peaks", None)
    monkeypatch.setattr(roofline, "_calibrated", {})
    prior, ref_prior = telemetry.enabled(), ref_telemetry.enabled()
    telemetry.enable(True)
    ref_telemetry.enable(True)
    telemetry.reset()
    ref_telemetry.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    profile.set_store(None)
    telemetry.reset()
    ref_telemetry.reset()
    telemetry.enable(prior)
    ref_telemetry.enable(ref_prior)


#: (timing, cost, device) triples: TPU kinds (the reference's registry),
#: an unknown TPU, no device, missing cost or timing.
ANNOTATE_CASES = [
    ({"execute_s": 2.0}, {"flops": 100.0, "bytes_accessed": 50.0},
     {"platform": "tpu", "device_kind": "TPU v4"}),
    ({"execute_s": 1.0}, {"flops": 1e9, "bytes_accessed": 1.0},
     {"platform": "tpu", "device_kind": "TPU v5 lite"}),
    ({"execute_s": 0.25}, {"flops": 3e12, "bytes_accessed": 4e9},
     {"platform": "tpu", "device_kind": "TPU v6e"}),
    ({"execute_s": 0.5}, {"flops": 7.0, "bytes_accessed": 0.0},
     {"platform": "tpu", "device_kind": "TPU v5p"}),
    ({"execute_s": 1.0}, {"flops": 1.0, "bytes_accessed": 2.0},
     {"platform": "tpu", "device_kind": "TPU v99"}),
    (None, None, None),
    ({"execute_s": 1.0}, None, {"platform": "tpu",
                                "device_kind": "TPU v3"}),
    (None, {"flops": 1.0}, {"platform": "tpu", "device_kind": "TPU v2"}),
    ({"execute_s": 0.0}, {"flops": 5.0, "bytes_accessed": 5.0}, None),
]


@pytest.mark.parametrize("timing,cost,device", ANNOTATE_CASES)
def test_annotate_equals_the_reference(timing, cost, device):
    assert roofline.annotate(timing, cost, device) == \
        ref_roofline.annotate(timing, cost, device)


def _records():
    """Records of three passes, as the profile store holds them."""
    recs = []
    for i, (name, f, b) in enumerate(itertools.product(
            ("witness", "stream", "bfs"), (10.0, 20.0, 30.0), (5.0, 50.0))):
        timing = {"execute_s": 0.1 * (i + 1)}
        cost = {"flops": f * (i + 1), "bytes_accessed": b,
                "transcendentals": 0.0, "device_calls": 1}
        dev = {"platform": "tpu", "device_kind": "TPU v4"}
        recs.append({"pass": name, "timing": timing, "cost": cost,
                     "roofline": ref_roofline.annotate(timing, cost, dev)})
    recs.append({"pass": "settle", "timing": {"execute_s": 1.0},
                 "cost": dict(profile.COST_NULL),
                 "roofline": dict(profile.ROOFLINE_NULL)})
    return recs


def test_summarize_equals_the_reference():
    recs = _records()
    got = roofline.summarize(recs)
    assert got == ref_roofline.summarize(recs)
    assert got["witness"]["n"] == 6 and got["witness"]["with_cost"] == 6
    assert got["settle"]["with_cost"] == 0 and got["settle"]["bound"] is None


def test_export_gauges_equal_the_reference():
    for rec in _records():
        roofline.export_gauges(rec)
        ref_roofline.export_gauges(rec)
    port = {k: v for k, v in telemetry.summary()["gauges"].items()
            if k.startswith("wgl.roofline.")}
    ref = {k: v for k, v in ref_telemetry.summary()["gauges"].items()
           if k.startswith("wgl.roofline.")}
    assert port == ref and port


def test_h100_peaks():
    got = roofline.peaks_for_device(H100)
    assert got == {"peak_flops_per_s": 989e12, "peak_bytes_per_s": 3.35e12,
                   "source": "gpu-registry:h100 80gb hbm3"}
    rl = roofline.annotate({"execute_s": 1e-3},
                           {"flops": 1e9, "bytes_accessed": 1e6}, H100)
    assert rl["knee_intensity"] == pytest.approx(989e12 / 3.35e12, rel=1e-6)
    assert rl["bound"] == "compute"
    assert rl["flops_ratio"] == pytest.approx(1e12 / 989e12, rel=1e-5)
    # The reference's registry has no GPU: a null there.
    assert ref_roofline.peaks_for_device(H100)["peak_flops_per_s"] is None
    assert roofline.bound(989e9, 0.0) == (pytest.approx(1.0), "operations")
    assert roofline.bound(0.0, 3.35e9) == (pytest.approx(1.0), "bytes")


def test_unknown_cuda_device_is_calibrated_and_cached(monkeypatch):
    """An unknown CUDA device gets the calibration probe once; the
    result is cached on disk, so a later process (memo cleared) reads it
    without probing."""
    probes = []

    def fake_probe(kind):
        probes.append(kind)
        return {"peak_flops_per_s": 1e14, "peak_bytes_per_s": 1e12,
                "source": "gpu-calibrated", "device_kind": kind}

    monkeypatch.setattr(roofline, "_calibrate_cuda_probe", fake_probe)
    dev = {"platform": "gpu", "device_kind": "NVIDIA Mystery GPU"}
    got = roofline.peaks_for_device(dev)
    assert got == {"peak_flops_per_s": 1e14, "peak_bytes_per_s": 1e12,
                   "source": "gpu-calibrated"}
    roofline._calibrated.clear()
    assert roofline.peaks_for_device(dev) == got
    assert probes == ["nvidia mystery gpu"]
    assert roofline.peaks_for_device({"platform": "gpu"})[
        "peak_flops_per_s"] is None


def test_cpu_calibration_cache_env_empty_disables_disk(monkeypatch, tmp_path):
    monkeypatch.setenv(roofline.CACHE_ENV, "")
    got = roofline.calibrate_cpu()
    assert got["peak_flops_per_s"] > 0 and got["peak_bytes_per_s"] > 0
    assert not (tmp_path / "peaks").exists()


# ------------------------------------------------- costs, by brute force


class _Rows:
    """A member window that records which rows a sweep reads."""

    def __init__(self, member):
        self.member = member
        self.rows = set()

    def __getitem__(self, i):
        self.rows.add(int(i))
        return self.member[i]


@pytest.mark.parametrize("B,SW,start,kind", [(1, 1, 0, "clean"),
                                             (4, 1, 3, "death"),
                                             (8, 5, 0, "death"),
                                             (3, 2, 10, "clean")])
def test_sweep_cost_by_brute_force(B, SW, start, kind):
    """Runs the plain sweep with instrumented inputs: the barriers it
    visits, the member rows it reads, the lane steps it takes."""
    from jepsen_tpu_torch.models import cas_register, multi_register
    from jepsen_tpu_torch.ops.wgl_witness import sweep_plain

    pm = (cas_register() if SW == 1 else
          multi_register({f"r{i}": 0 for i in range(SW)})).packed()
    rng = np.random.default_rng(B * 10 + SW)
    K, W = 24, 6
    bars = np.zeros((6, K), dtype=np.int32)
    bars[0] = rng.integers(0, W - 1, K)
    bars[2] = 1
    bars[3] = rng.integers(0, 2, K)
    bars[4] = rng.integers(0, SW, K)
    member = torch.from_numpy(rng.random((W, B)) < 0.5)
    member[:, 0] = True
    if kind == "death":
        bars[0, 17] = W - 1
        bars[3:, 17] = (0, 77, 77) if SW == 1 else (0, 0, 77)
        member[W - 1] = False
    states = torch.zeros((B, SW), dtype=torch.int32)
    alive = torch.ones(B, dtype=torch.bool)
    steps = []

    def counting(st, f, a0, a1):
        steps.append(st.numel() + st.shape[1])  # a select per word, a test
        return pm.torch_step_rows(st, f, a0, a1)

    rows = _Rows(member)
    *_, death = sweep_plain(start, torch.from_numpy(bars), rows, states,
                            alive, counting)
    visited = len(steps)
    brute_bytes = (5 * 4 * visited + B * len(rows.rows)
                   + 2 * (4 * B * SW + B) + 4)
    got = roofline.sweep_cost(start, death, K, bars[0].tolist(), B, SW)
    assert got == {"flops": float(sum(steps)),
                   "bytes_accessed": float(brute_bytes),
                   "transcendentals": 0.0}
    stream = roofline.sweep_cost(start, death, K, bars[0].tolist(), B, SW,
                                 stream=True)
    assert stream["bytes_accessed"] == brute_bytes + 4 * SW


def _tensor_bytes(*shapes_dtypes):
    return sum(int(np.prod(s)) * np.dtype(d).itemsize
               for s, d in shapes_dtypes)


@pytest.mark.parametrize("W,R,B,SW", [(4, 2, 3, 1), (6, 6, 2, 3),
                                      (5, 0, 4, 2)])
def test_chain_round_cost_by_brute_force(W, R, B, SW):
    ops = 0
    for _lane in range(B):  # the direct step
        ops += 1 + SW
    for _h, _lane in itertools.product(range(R), range(B)):
        ops += 2 * (1 + SW)  # the helper step and the barrier step
        ops += 2 * SW  # the child's hash: a multiply-add per word
    ins = _tensor_bytes(((W, B), np.bool_), ((B, SW), np.int32),
                        ((B,), np.bool_), ((3, R), np.int32))
    outs = _tensor_bytes(((W, B), np.bool_), ((B, SW), np.int32),
                         ((B,), np.bool_))
    assert roofline.chain_round_cost(W, R, B, SW) == {
        "flops": float(ops), "bytes_accessed": float(ins + outs),
        "transcendentals": 0.0}


@pytest.mark.parametrize("W,B,SW,slots", [(4, 2, 1, 3), (7, 3, 2, 5)])
def test_bfs_level_costs_by_brute_force(W, B, SW, slots):
    ops = 0
    for _b, _slot in itertools.product(range(B), range(slots)):
        ops += 1 + SW  # the child's model step
        ops += 2 * 2 * (W + SW)  # two hashes over bits and words
    frontier = _tensor_bytes(((W, B), np.bool_), ((B, SW), np.int32),
                             ((B,), np.bool_))
    window = _tensor_bytes(((5, W), np.int32))
    want = {"flops": float(ops),
            "bytes_accessed": float(2 * frontier + window),
            "transcendentals": 0.0}
    assert roofline.bfs_level_cost(W, B, SW, slots) == want
    K = 3
    assert roofline.batched_level_cost(K, W, B, SW, slots) == {
        "flops": K * want["flops"],
        "bytes_accessed": K * want["bytes_accessed"],
        "transcendentals": 0.0}


@pytest.mark.parametrize("K,V,levels", [(1, 2, 0), (2, 3, 3), (3, 5, 4)])
def test_closure_and_extraction_costs_by_brute_force(K, V, levels):
    """Counts the multiply-adds of the closure's squarings (as
    ops/scc.py runs them: ceil(log2 V) products per graph) and of the
    extraction's BFS graph-levels (a vector-matrix step each)."""
    from jepsen_tpu_torch.ops import scc

    macs = 0
    for _step in range(roofline.closure_steps(V)):
        for _k, _i, _j, _m in itertools.product(range(K), range(V),
                                                range(V), range(V)):
            macs += 1
    adjacency = _tensor_bytes(((K, V, V), np.bool_))
    assert roofline.closure_cost(K, V) == {
        "flops": 2.0 * macs, "bytes_accessed": float(adjacency + K),
        "transcendentals": 0.0}
    assert roofline.closure_ops(K, V) == 2.0 * macs
    bfs = sum(1 for _ in itertools.product(range(levels), range(V),
                                           range(V)))
    assert roofline.extract_cost(K, V, levels) == {
        "flops": 2.0 * (macs + bfs),
        "bytes_accessed": float(2 * adjacency + _tensor_bytes(
            ((K, 4), np.int32), ((K, V), np.int32))),
        "transcendentals": 0.0}


def test_bench_sweep_bytes():
    """The 786-barrier bench sweep of PERF.md: 22,092 bytes."""
    assert roofline.sweep_bytes(0, 785, 2048, list(range(786)) + [0] * 1262,
                                8, 1) == 20 * 786 + 8 * 786 + 2 * (32 + 8) + 4


# ------------------------------------------------- records on the paths


def test_profile_records_carry_costs_where_noted(tmp_path, monkeypatch):
    """The checking paths on the CPU with a profile store: the passes
    that noted device-call costs carry non-null cost and roofline
    blocks (against the CPU's calibrated peaks); a pass that noted none
    keeps the explicit nulls."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.checker.elle import AppendChecker
    from jepsen_tpu_torch.history.core import Op, history
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.parallel import IndependentChecker, \
        clear_settle_memo, kv
    from jepsen_tpu_torch.plan import cache as plan_cache
    from jepsen_tpu_torch.utils.histgen import random_register_history

    profile.set_store(str(tmp_path))
    plan_cache.reset_for_tests()
    clear_settle_memo()
    m = cas_register()
    Linearizable(m, device="cpu").check(
        {}, random_register_history(400, procs=4, info_rate=0.05,
                                    seed=3), {})
    # The frontier BFS runs where the host refutation screen is off.
    import importlib

    lin_mod = importlib.import_module("jepsen_tpu_torch.checker.linearizable")
    with monkeypatch.context() as mp:
        mp.setattr(lin_mod, "check_refute", lambda *a, **k: None)
        Linearizable(m, device="cpu").check(
            {}, random_register_history(300, procs=3, info_rate=0.0,
                                        seed=4, bad=True), {})
    keyed = history([o.replace(value=kv(f"k{i}", o.value)) for i in range(6)
                     for o in random_register_history(
                         40, procs=3, info_rate=0.0, seed=i, bad=i == 1)])
    IndependentChecker(Linearizable(m, device="cpu"),
                       device="cpu").check({}, keyed, {})
    # With the stream witness out, the batched BFS takes the keys.
    clear_settle_memo()
    with monkeypatch.context() as mp:
        mp.setenv("JEPSEN_WGL_FAULT", "stream")
        IndependentChecker(Linearizable(m, device="cpu"),
                           device="cpu").check({}, keyed, {})
    txns = [Op(type=t, f="txn", value=v, process=p) for t, v, p in (
        ("invoke", [["append", 1, 1]], 0), ("ok", [["append", 1, 1]], 0),
        ("invoke", [["append", 2, 1]], 1), ("ok", [["append", 2, 1]], 1),
        ("invoke", [["r", 1, None], ["r", 2, None]], 0),
        ("ok", [["r", 1, [1]], ["r", 2, []]], 0),
        ("invoke", [["r", 1, None], ["r", 2, None]], 1),
        ("ok", [["r", 1, []], ["r", 2, [1]]], 1))]
    AppendChecker("serializable", device="cpu").check({}, history(txns), {})
    recs = profile.read(profile.store_path())
    by = {}
    for r in recs:
        by.setdefault(r["pass"], []).append(r)
    for name in ("witness", "bfs", "stream", "batched", "elle"):
        assert name in by, sorted(by)
        costed = [r for r in by[name] if r["cost"]["flops"] is not None]
        assert costed, name
        r = costed[0]
        assert r["cost"]["bytes_accessed"] > 0 and r["cost"]["flops"] > 0
        assert r["cost"]["device_calls"] > 0
        assert r["roofline"]["peak_source"] == "cpu-calibrated"
        assert r["roofline"]["arithmetic_intensity"] > 0
    for r in recs:
        if r["cost"]["device_calls"] == 0:
            assert r["cost"] == profile.COST_NULL
            assert r["roofline"] == profile.ROOFLINE_NULL
    assert ref_profile.COST_NULL.keys() == profile.COST_NULL.keys()
