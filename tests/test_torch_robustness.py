"""The robustness layer through the port on the CPU: every case of
tests/test_robustness.py through `jepsen_tpu_torch` (tests/torch_ported.py;
its `fault_matrix` cells run tools/port_fault_matrix.py, the port's
matrix), then what the port must hold on its own:

* `telemetry.RESILIENCE_COUNTER_PREFIXES` is the reference's tuple, so a
  run's resilience record keeps daemon start retries and the remote
  checker's fallbacks and blown budgets;
* `parallel.tuple_gen` is the reference's `independent/tuple` alias;
* the frontier BFS stops at the level where its time limit runs out:
  the reference's block is one jitted loop that can stop only at its
  end, the port's reads each level on the host, so a check on a slow
  device no longer runs on for the rest of a block.

Left out of tests/test_robustness.py, both marked slow there:
- `test_linearizable_settles_despite_all_faults`: with every tier
  faulting the reference settles on its CPU engine; the port raises
  `CardExhausted` (no CPU fallback), held by
  tests/test_torch_packing.py::test_linearizable_faults_raise_after_shedding_packing;
- `test_fault_matrix_all_cells`: it expects six cells and the reference's
  "device" tier in wgl-fault; tests/test_torch_fault_matrix.py holds all
  seven of the port's cells against the reference's.
"""

import time

import pytest
import torch

import jepsen_tpu.parallel as r_parallel
import jepsen_tpu.telemetry as r_telemetry
import jepsen_tpu_torch.parallel as p_parallel
import jepsen_tpu_torch.telemetry as p_telemetry
import torch_ported
from jepsen_tpu_torch.history.packed import pack_history
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops.wgl import check_wgl_device
from jepsen_tpu_torch.utils.histgen import random_register_history

ROBUSTNESS = torch_ported.load(
    "test_robustness", imports={"fault_matrix": "port_fault_matrix"})
LEFT_OUT = ("test_linearizable_settles_despite_all_faults",
            "test_fault_matrix_all_cells")


@pytest.fixture(autouse=True)
def _one_thread():
    """The ladder cases run the CPU device search under a checker
    budget: one torch thread, as the other such files do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def telem():
    """test_robustness.py's fixture, on the port's telemetry."""
    old = p_telemetry.enabled()
    p_telemetry.enable(True)
    p_telemetry.reset()
    yield
    p_telemetry.reset()
    p_telemetry.enable(old)


@pytest.mark.parametrize("case", torch_ported.cases(ROBUSTNESS))
def test_robustness_cases_through_the_port(case, request):
    torch_ported.run(ROBUSTNESS, case, request)


def test_every_reference_case_is_run():
    """Every case of the file: 29 run in tier-1, the two slow ones are
    left out above."""
    assert len(torch_ported.cases(ROBUSTNESS)) == 29
    assert sorted(torch_ported.cases(ROBUSTNESS, slow=True)) == \
        sorted(LEFT_OUT)


def test_resilience_prefixes_are_the_references():
    assert (p_telemetry.RESILIENCE_COUNTER_PREFIXES
            == r_telemetry.RESILIENCE_COUNTER_PREFIXES)


@pytest.mark.parametrize("name", [
    "daemon.start-retries", "checkerd.fallback", "checkerd.budget-exceeded",
    "interpreter.op-timeouts", "wgl.degrade.device.retry-halved",
    "wgl.h2d_bytes", "checkerd.requests"])
def test_resilience_counters_keep_what_the_reference_keeps(name, telem):
    """One counter at a time through both packages' filters."""
    r_old = r_telemetry.enabled()
    r_telemetry.enable(True)
    r_telemetry.reset()
    try:
        p_telemetry.count(name, 3)
        r_telemetry.count(name, 3)
        assert (p_telemetry.resilience_counters()
                == r_telemetry.resilience_counters())
    finally:
        r_telemetry.reset()
        r_telemetry.enable(r_old)


@pytest.mark.parametrize("key,value", [
    (0, 1), ("k", None), (3, (1, 2)), ("x", [1, "a"])])
def test_tuple_gen_is_the_references(key, value):
    got = p_parallel.tuple_gen(key, value)
    want = r_parallel.tuple_gen(key, value)
    assert isinstance(got, p_parallel.KV)
    assert (got.key, got.value) == (want.key, want.value)
    assert repr(got) == repr(want)
    assert got == p_parallel.kv(key, value)
    assert "tuple_gen" in p_parallel.__all__


def test_bfs_time_limit_binds_within_a_level():
    """test_wgl_witness.py's ladder history (2,048 ops, 90% info) with
    the BFS alone and a 5 s limit: unknown with reason time-limit,
    back within a level of the limit.  A block of this history runs
    about 40 s on this CPU, so a limit read only between blocks ends
    there."""
    pm = cas_register().packed()
    h = random_register_history(2048, procs=16, info_rate=0.9, seed=5)
    p = pack_history(h, pm.encode)
    t0 = time.monotonic()
    res = check_wgl_device(p, pm, time_limit_s=5, witness=False,
                           device="cpu")
    elapsed = time.monotonic() - t0
    assert res.valid == "unknown" and res.reason == "time-limit"
    assert res.configs_explored > 0
    assert elapsed < 10, elapsed
