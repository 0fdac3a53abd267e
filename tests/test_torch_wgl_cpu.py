"""The exact CPU engines and the device ladder's literal and random
corpora through the port on the CPU: every case of tests/test_wgl_cpu.py,
tests/test_wgl_device.py (its `gen_history` from the ported
test_wgl_cpu.py) and tests/test_wgl_event.py through `jepsen_tpu_torch`
(tests/torch_ported.py), with test_wgl_event.py's `pm` fixture on the
port's model.  test_wgl_event.py's DFS-oracle parity case runs about
100 s in either package; the ladder's long case lives in
tests/test_torch_wgl_witness.py, so the two land on different test
workers."""

import pytest
import torch

import torch_ported
from jepsen_tpu_torch.models import cas_register

WGL_CPU = torch_ported.load("test_wgl_cpu")
WGL_DEVICE = torch_ported.load(
    "test_wgl_device", imports={"test_wgl_cpu": "ported_test_wgl_cpu"})
WGL_EVENT = torch_ported.load("test_wgl_event")

MODULES = (WGL_CPU, WGL_DEVICE, WGL_EVENT)


@pytest.fixture(autouse=True)
def _one_thread():
    """The device-ladder cases run the CPU device search under a checker
    budget: one torch thread, as the other such files do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pm():
    """test_wgl_event.py's fixture, on the port's model."""
    return cas_register().packed()


@pytest.mark.parametrize(
    "mod, case", [(m, c) for m in MODULES for c in torch_ported.cases(m)],
    ids=lambda x: x if isinstance(x, str) else x.__name__[len("ported_"):])
def test_reference_cases_through_the_port(mod, case, request):
    torch_ported.run(mod, case, request)


def test_every_reference_case_is_run():
    assert {m.__name__: (len(torch_ported.cases(m)),
                         len(torch_ported.cases(m, slow=True)))
            for m in MODULES} == {
        "ported_test_wgl_cpu": (15, 0), "ported_test_wgl_device": (10, 0),
        "ported_test_wgl_event": (5, 0)}


def test_device_cases_use_the_ported_generator():
    """test_wgl_device.py takes `gen_history` from the ported
    test_wgl_cpu.py, and packs its rows with the port."""
    assert WGL_DEVICE.gen_history is WGL_CPU.gen_history
    assert WGL_DEVICE.pack_history.__module__.startswith("jepsen_tpu_torch.")
    assert WGL_DEVICE.check_wgl_device.__module__ == "jepsen_tpu_torch.ops.wgl"
