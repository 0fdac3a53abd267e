"""The port's network-namespace micro-cluster (control/netns.py) on the
CPU: tests/test_netns_cluster.py's non-slow cases run through
`jepsen_tpu_torch` (tests/torch_ported.py), on a `NetnsCluster` of the
port's, under the reference's own skip condition (`netns_available()`,
which needs the `ip` binary and CAP_NET_ADMIN), decided in the fixture.
Its slow cases (the repkv and electd kernel partitions) run with
`-m slow`."""

import time

import pytest

import torch_ported

NETNS = torch_ported.load("test_netns_cluster")


@pytest.fixture
def cluster():
    from jepsen_tpu_torch.control.netns import NetnsCluster, netns_available

    if not netns_available():
        pytest.skip("network namespaces unavailable (needs root + ip "
                    "binary)")
    c = NetnsCluster(n_nodes=3, tag="jtt%05d" % (time.time_ns() % 90000))
    with c:
        yield c


@pytest.mark.parametrize("case", torch_ported.cases(NETNS))
def test_netns_cases_through_the_port(case, request):
    torch_ported.run(NETNS, case, request)


@pytest.mark.slow
@pytest.mark.parametrize("case", torch_ported.cases(NETNS, slow=True))
def test_netns_slow_cases_through_the_port(case, request):
    from jepsen_tpu_torch.control.netns import netns_available

    if not netns_available():
        pytest.skip("network namespaces unavailable")
    torch_ported.run(NETNS, case, request)


def test_netns_case_lists():
    """Four fast cases and five slow ones, as in the reference."""
    assert len(torch_ported.cases(NETNS)) == 4
    assert len(torch_ported.cases(NETNS, slow=True)) == 5


def test_netns_ssh_cluster_names_the_ports_server():
    """NetnsSshCluster starts the port's minissh daemon in each
    namespace, never the reference's."""
    import inspect

    from jepsen_tpu_torch.control import netns

    src = inspect.getsource(netns.NetnsSshCluster.create)
    assert "jepsen_tpu_torch.control.minissh.server" in src
