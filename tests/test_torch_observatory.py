"""The port's observatory on the CPU: trace propagation through a
checkerd daemon, the trace_merge tool on the port's traces, the per-pass
profile store, the flight recorder and the Prometheus scrape surface.

tests/test_observatory.py runs through `jepsen_tpu_torch`
(tests/torch_ported.py); its two fixtures are rewritten below, the
daemon on the CPU (`device="cpu"`), since a ported file's fixtures are
not collected.
"""

import threading

import pytest
import torch

import torch_ported

from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.checkerd.server import make_server
from jepsen_tpu_torch.telemetry import flight, profile

OBS = torch_ported.load("test_observatory")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def scope():
    """test_observatory.py's fixture on the port's registry."""
    prior = telemetry.enabled()
    telemetry.enable(True)
    telemetry.reset()
    try:
        yield
    finally:
        profile.set_store(None)
        flight.set_dir(None)
        telemetry.reset()
        telemetry.enable(prior)


@pytest.fixture()
def daemon():
    """test_observatory.py's fixture on the port: one CPU daemon."""
    srv = make_server("127.0.0.1", 0, batch_window_s=0.0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv, f"127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        srv.scheduler.stop()
        t.join(timeout=5)


@pytest.mark.parametrize("case", torch_ported.cases(OBS))
def test_observatory_cases_through_the_port(case, request):
    torch_ported.run(OBS, case, request)


def test_observatory_case_list():
    assert len(torch_ported.cases(OBS)) == 14
