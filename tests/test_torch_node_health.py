"""Node health, the fault ledger and the small host modules through the
port on the CPU: every case of tests/test_node_health.py,
tests/test_nemesis_ledger.py and tests/test_small_parity.py through
`jepsen_tpu_torch` (tests/torch_ported.py), with their `telem` fixture
on the port's telemetry.  test_nemesis_ledger.py's slow
`fault_matrix` cell runs tools/port_fault_matrix.py's nemesis-crash
cell under `-m slow`."""

import pytest

import torch_ported

HEALTH = torch_ported.load("test_node_health")
LEDGER = torch_ported.load(
    "test_nemesis_ledger", imports={"fault_matrix": "port_fault_matrix"})
SMALL = torch_ported.load("test_small_parity")

MODULES = (HEALTH, LEDGER, SMALL)


@pytest.fixture
def telem():
    """The files' own fixture, on the port's telemetry."""
    from jepsen_tpu_torch import telemetry

    old = telemetry.enabled()
    telemetry.enable(True)
    telemetry.reset()
    yield
    telemetry.reset()
    telemetry.enable(old)


def _ids(x):
    return x if isinstance(x, str) else x.__name__[len("ported_"):]


@pytest.mark.parametrize(
    "mod, case", [(m, c) for m in MODULES for c in torch_ported.cases(m)],
    ids=_ids)
def test_reference_cases_through_the_port(mod, case, request):
    torch_ported.run(mod, case, request)


@pytest.mark.slow
@pytest.mark.parametrize(
    "mod, case",
    [(m, c) for m in MODULES for c in torch_ported.cases(m, slow=True)],
    ids=_ids)
def test_slow_reference_cases_through_the_port(mod, case, request):
    torch_ported.run(mod, case, request)


def test_every_reference_case_is_run():
    assert {m.__name__: (len(torch_ported.cases(m)),
                         len(torch_ported.cases(m, slow=True)))
            for m in MODULES} == {
        "ported_test_node_health": (20, 0),
        "ported_test_nemesis_ledger": (17, 1),
        "ported_test_small_parity": (4, 0)}
