"""tests/test_integration_ssh.py through the port: SshCliRemote against
SSH nodes with their own network identities, on the CPU.  As in the
reference, the cluster is either real nodes named by
JEPSEN_TPU_SSH_NODES / JEPSEN_TPU_SSH_KEY / JEPSEN_TPU_SSH_USER, or a
`NetnsSshCluster` of the port's (a port minissh daemon in each network
namespace, the port's shims on PATH when no OpenSSH client is
installed); the cases skip when neither exists, decided in the
fixture."""

import os
import shutil
import time

import pytest

import torch_ported

INTEGRATION = torch_ported.load("test_integration_ssh")


@pytest.fixture(scope="module")
def cluster():
    nodes = INTEGRATION._env_nodes()
    if nodes:
        if not INTEGRATION._reachable(nodes[0]):
            pytest.skip(f"{nodes[0]} unreachable")
        yield {"kind": "env", "nodes": nodes, "ssh": {
            "username": os.environ.get("JEPSEN_TPU_SSH_USER", "root"),
            "private-key-path": os.environ.get("JEPSEN_TPU_SSH_KEY")}}
        return
    from jepsen_tpu_torch.control import minissh
    from jepsen_tpu_torch.control.netns import (NetnsSshCluster,
                                                netns_available)

    if not netns_available():
        pytest.skip("no JEPSEN_TPU_SSH_NODES and no netns capability")
    old_path = os.environ["PATH"]
    if shutil.which("ssh") is None:
        os.environ["PATH"] = minissh.BIN_DIR + os.pathsep + old_path
    c = NetnsSshCluster(3, tag="jts%05d" % (time.time_ns() % 90000))
    try:
        with c:
            yield {"kind": "netns", "nodes": c.ssh_nodes,
                   "ssh": {"username": "root", "private-key-path":
                           c.key_path, "no-sudo": True},
                   "_cluster": c}
    finally:
        os.environ["PATH"] = old_path


@pytest.mark.parametrize("case", torch_ported.cases(INTEGRATION))
def test_integration_ssh_through_the_port(case, request):
    torch_ported.run(INTEGRATION, case, request)


def test_integration_case_list():
    assert len(torch_ported.cases(INTEGRATION)) == 5
