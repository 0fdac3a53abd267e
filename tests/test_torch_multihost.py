"""`multihost_init` run for real (jepsen_tpu_torch/parallel/mesh.py),
the port's counterpart of tests/test_multihost.py: two fresh processes
join one gloo process group over localhost, build the mesh across both
(one CPU device each), all-reduce a tensor across the process boundary,
and split a 20-key `check_wgl_batched` over the two ranks, whose
verdicts and explored counts must be the one-process run's."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

from jepsen_tpu_torch.history.packed import pack_history
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops.wgl_batched import check_wgl_batched
from jepsen_tpu_torch.utils.histgen import random_register_history

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Both ranks and the test build the same 20 keys from these seeds.
KEYS = textwrap.dedent(
    """
    def keys(pack_history, random_register_history, pm):
        return [pack_history(random_register_history(
                    20 + (s % 4) * 6, procs=4, info_rate=0.05,
                    seed=900 + s, bad=(s % 5 == 3)), pm.encode)
                for s in range(20)]
    """
)

WORKER = KEYS + textwrap.dedent(
    """
    import json
    import sys

    import torch

    torch.set_num_threads(1)
    import jepsen_tpu_torch.device as device

    # One CPU device a process, as the reference's test gives each of
    # its processes one.
    device.local_devices = lambda: [torch.device("cpu")]
    from jepsen_tpu_torch.history.packed import pack_history
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops.wgl_batched import check_wgl_batched
    from jepsen_tpu_torch.parallel.mesh import default_mesh, multihost_init
    from jepsen_tpu_torch.utils.histgen import random_register_history

    coord, pid = sys.argv[1], int(sys.argv[2])
    multihost_init(coord, num_processes=2, process_id=pid)
    dist = torch.distributed
    assert dist.get_world_size() == 2
    mesh = default_mesh()
    assert mesh.devices.size == 2, mesh
    assert mesh.ranks == (0, 1), mesh.ranks
    t = torch.tensor([float(pid + 1)])
    dist.all_reduce(t)
    assert t.item() == 3.0, t
    pm = cas_register().packed()
    res = check_wgl_batched(keys(pack_history, random_register_history, pm),
                            pm, beam=32, mesh=mesh, device="cpu")
    print("RESULT " + json.dumps({"psum": t.item(), "valid": res.valid,
                                  "explored": res.explored.tolist()}),
          flush=True)
    dist.destroy_process_group()
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_mesh_allreduce_and_batched_split():
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ,
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, coord, str(pid)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out.decode(errors="replace"),
                         err.decode(errors="replace")))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("the two ranks did not finish in 120 s")
    results = []
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {pid} rc={rc}\n{out}\n{err[-3000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out
        results.append(json.loads(line[-1][len("RESULT "):]))

    ns: dict = {}
    exec(KEYS, ns)
    pm = cas_register().packed()
    alone = check_wgl_batched(
        ns["keys"](pack_history, random_register_history, pm), pm,
        beam=32, device="cpu")
    for r in results:
        assert r["psum"] == 3.0
        assert r["valid"] == alone.valid
        assert r["explored"] == alone.explored.tolist()
    assert alone.valid.count(False) == 4
