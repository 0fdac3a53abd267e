"""tools/port_fault_matrix.py against tools/fault_matrix.py on the CPU:
each of the seven cells run through both packages, and its summary (the
verdicts, the algorithm, the degraded tiers, the resilience counters a
run leaves) equal, but for wgl-fault's deliberate divergence: under
JEPSEN_WGL_FAULT=all the reference settles on its exact CPU engine
("wgl-tpu+cpu-fallback"), while the port never moves a device check to
the CPU and raises `CardExhausted` with the card probe's result.  The
port's "witness" run is held against the reference's under the same
fault.  The jax-blocked import guard in test_torch_linearizable.py
loads the port's matrix too."""

import os
import sys

import pytest
import torch

import jepsen_tpu.telemetry as r_telemetry
import jepsen_tpu_torch.telemetry as p_telemetry

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)

import fault_matrix as R  # noqa: E402
import port_fault_matrix as P  # noqa: E402

CELLS = list(R.SCENARIOS)


@pytest.fixture(autouse=True)
def _one_thread():
    """wgl-fault runs the CPU device search under a checker budget: one
    torch thread, as the other such files do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def telem():
    """Both packages' counters on, reset before and after."""
    old = r_telemetry.enabled(), p_telemetry.enabled()
    for t in (r_telemetry, p_telemetry):
        t.enable(True)
        t.reset()
    yield
    for t, was in zip((r_telemetry, p_telemetry), old):
        t.reset()
        t.enable(was)


def _counters(tel) -> list:
    """The resilience counters the last run left set."""
    return sorted(k for k, v in tel.resilience_counters().items() if v)


def _summary(name: str, d: dict) -> dict:
    """The parts of a cell's detail that do not hang on timing (op
    counts do)."""
    if name == "hanging-client":
        return {"valid": d["valid"], "op_timeouts": d["op_timeouts"] >= 1}
    if name == "node-death":
        return {"fast_fails": d["fast_fails"] > 0,
                "timeline": d["timeline"]}
    if name == "composed-faults":
        return {k: d[k] for k in ("timeline", "ledger_families", "valid")}
    return {k: v for k, v in d.items() if k != "all"}


def test_the_matrices_have_the_same_cells():
    assert list(P.SCENARIOS) == CELLS and len(CELLS) == 7


@pytest.mark.parametrize("name", [c for c in CELLS if c != "wgl-fault"])
def test_cell_equals_the_references(name, tmp_path, telem):
    ref = R.SCENARIOS[name](str(tmp_path / "ref" / "store"))
    ref_counters = _counters(r_telemetry)
    got = P.SCENARIOS[name](str(tmp_path / "port" / "store"), "cpu")
    assert _summary(name, got) == _summary(name, ref)
    assert _counters(p_telemetry) == ref_counters


def _witness_fault_run(mod, store_dir: str, **kw) -> dict:
    """One run of the wgl-tpu checker under JEPSEN_WGL_FAULT=witness,
    through `mod`'s test map and deadline."""
    if mod is P:
        test = P._wgl_test(store_dir, "cpu")
    else:
        from jepsen_tpu import checker as chk
        from jepsen_tpu.checker.linearizable import linearizable

        test = R._register_test(store_dir, checker=chk.compose({
            "stats": chk.Stats(),
            "linear": linearizable(algorithm="wgl-tpu", time_limit_s=60.0),
        }))
    with P._env("JEPSEN_WGL_FAULT", "witness"):
        test = mod._run_with_deadline(test)
    lin = test["results"]["linear"]
    return {"valid": test["results"]["valid"], "linear": lin["valid"],
            "algorithm": lin["algorithm"],
            "tiers": sorted({s["tier"] for s in lin["degradations"]})}


def test_wgl_fault_witness_run_equals_the_references(tmp_path, telem):
    ref = _witness_fault_run(R, str(tmp_path / "ref"))
    ref_counters = _counters(r_telemetry)
    got = _witness_fault_run(P, str(tmp_path / "port"))
    assert got == ref == {"valid": True, "linear": True,
                          "algorithm": "wgl-tpu", "tiers": ["witness"]}
    assert _counters(p_telemetry) == ref_counters


def test_wgl_fault_cell_diverges_only_where_it_must(tmp_path, telem):
    """The reference's cell settles "all" on the CPU; the port's ends
    it in `CardExhausted` with a probe and the history stored, and
    its counters add only the checker's halved retry of the dispatch."""
    ref = R.scenario_wgl_fault(str(tmp_path / "ref" / "store"))
    ref_counters = _counters(r_telemetry)
    assert ref["valid"] is True
    assert ref["algorithm"] == "wgl-tpu+cpu-fallback"
    assert "device" in ref["degraded_tiers"]
    got = P.scenario_wgl_fault(str(tmp_path / "port" / "store"), "cpu")
    assert {k: got[k] for k in ("valid", "algorithm", "degraded_tiers")} \
        == {"valid": True, "algorithm": "wgl-tpu",
            "degraded_tiers": ["witness"]}
    assert got["all"]["raised"] == "CardExhausted"
    assert got["all"]["probe_ok"] is None  # a CPU search has no card
    assert got["all"]["stored_ops"] > 0
    assert _counters(p_telemetry) == sorted(
        ref_counters + ["wgl.degrade.dispatch.retry-halved"])


def test_main_prints_one_line_and_refuses_unknown_cells(capsys):
    assert P.main(["port_fault_matrix", "--device", "cpu",
                   "crashing-checker"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    import json

    doc = json.loads(out[-1])
    assert doc["fault_matrix"] == "ok" and doc["device"] == "cpu"
    assert list(doc["scenarios"]) == ["crashing-checker"]
    with pytest.raises(SystemExit):
        P.main(["port_fault_matrix", "no-such-cell"])
