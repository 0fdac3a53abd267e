"""The mesh (jepsen_tpu_torch/parallel/mesh.py) and its users on the
CPU, against the JAX package on its 8 virtual CPU devices
(tests/conftest.py): `device.local_devices` is replaced by a list of 8
CPU devices, as the reference's suite gets its 8 devices.

Through the port: every case of tests/test_wgl_sharded.py (the
frontier-sharded BFS, B5, the `mesh size 3` rejection and
`multihost_init`'s argument checks), TestBatchedWGL.test_on_mesh of
tests/test_independent.py, the mesh and padding cases of
tests/test_scc_device.py, and the `default_mesh(8)` cases of
tests/test_independent_mixed.py.  Beside them, on the same seeded
inputs: the port's verdicts on the mesh against the reference's on its
mesh, and against the port's own without one."""

import numpy as np
import pytest
import torch

import jepsen_tpu.parallel.mesh as rmesh
import jepsen_tpu_torch.device as pdevice
import jepsen_tpu_torch.parallel.mesh as pmesh
from jepsen_tpu.checker.elle.graph import DepGraph as RGraph
from jepsen_tpu.checker.linearizable import Linearizable as RLin
from jepsen_tpu.history.core import history as rhistory
from jepsen_tpu.history.packed import pack_history as rpack
from jepsen_tpu.models import cas_register as rcas
from jepsen_tpu.ops.scc import screen_cycles as rscreen
from jepsen_tpu.ops.wgl import check_wgl_device as rdevice
from jepsen_tpu.ops.wgl_batched import check_wgl_batched as rbatched
from jepsen_tpu.parallel.independent import (IndependentChecker as RInd,
                                             clear_settle_memo as rclear,
                                             kv as rkv)
from jepsen_tpu.utils.histgen import random_register_history as rgen
from jepsen_tpu_torch.checker.elle.graph import DepGraph as PGraph
from jepsen_tpu_torch.checker.linearizable import Linearizable as PLin
from jepsen_tpu_torch.history.core import history as phistory
from jepsen_tpu_torch.history.packed import pack_history as ppack
from jepsen_tpu_torch.models import cas_register as pcas
from jepsen_tpu_torch.ops.scc import screen_cycles as pscreen
from jepsen_tpu_torch.ops.wgl import check_wgl_device as pdevice_check
from jepsen_tpu_torch.ops.wgl_batched import check_wgl_batched as pbatched
from jepsen_tpu_torch.parallel.independent import (IndependentChecker as PInd,
                                                   clear_settle_memo as pclear,
                                                   kv as pkv)
from jepsen_tpu_torch.utils.histgen import random_register_history as pgen
import torch_ported

SHARDED = torch_ported.load("test_wgl_sharded")
INDEPENDENT = torch_ported.load("test_independent")
SCC = torch_ported.load("test_scc_device")
MIXED = torch_ported.load("test_independent_mixed")

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def cpu8(monkeypatch):
    """8 CPU devices for the mesh, and no mesh memoized across cases."""
    monkeypatch.setattr(pdevice, "local_devices", lambda: list(CPU8))
    pmesh._mesh_cache.clear()
    yield
    pmesh._mesh_cache.clear()


@pytest.fixture(autouse=True)
def _one_thread():
    """Searches under a checker budget: one torch thread, as the other
    such files do, since xdist's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mesh():
    """test_wgl_sharded's own `mesh` fixture, which pytest does not
    collect from the ported file."""
    return pmesh.default_mesh(8, axis="beam")


@pytest.mark.parametrize("case", torch_ported.cases(SHARDED))
def test_wgl_sharded_scenarios_through_the_port(case, request):
    torch_ported.run(SHARDED, case, request)


@pytest.mark.parametrize("case", ["TestBatchedWGL.test_on_mesh"])
def test_batched_on_mesh_through_the_port(case, request):
    torch_ported.run(INDEPENDENT, case, request)


@pytest.mark.parametrize("case", ["test_check_cycles_device_mesh",
                                  "test_pack_adjacency_padding"])
def test_scc_mesh_cases_through_the_port(case, request):
    torch_ported.run(SCC, case, request)


@pytest.mark.parametrize("case", [
    "test_mixed_verdict_parity_small",
    "test_settle_memo_shares_verdicts_across_identical_keys",
    "test_settle_memo_never_shares_positional_certificates",
])
def test_mixed_mesh_cases_through_the_port(case, request):
    torch_ported.run(MIXED, case, request)


# -- the mesh itself ---------------------------------------------------------


def test_default_mesh_shape_and_memo():
    m = pmesh.default_mesh()
    assert m.devices.size == 8 and m.devices.shape == (8,)
    assert m.axis_names == ("keys",)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert pmesh.default_mesh() is m
    assert pmesh.default_mesh(8) is not m
    assert pmesh.default_mesh(3, axis="beam").devices.size == 3
    assert m.ranks == (0,) * 8 and not m.spans_ranks


def test_checker_mesh_choices(monkeypatch):
    explicit = pmesh.Mesh(["cpu", "cpu"], ("keys",))
    assert pmesh.checker_mesh({"mesh": explicit}) is explicit
    assert pmesh.checker_mesh({"mesh": explicit}, "cpu") is explicit
    assert pmesh.checker_mesh({}) is pmesh.default_mesh()
    assert pmesh.checker_mesh(None, "cuda") is pmesh.default_mesh()
    # A CPU checker never takes the card list.
    assert pmesh.checker_mesh({}, "cpu") is None
    # One card (the driver's machine): no mesh, today's path.
    monkeypatch.setattr(pdevice, "local_devices",
                        lambda: [torch.device("cuda", 0)])
    assert pmesh.checker_mesh({}) is None
    monkeypatch.setattr(pdevice, "local_devices", lambda: [])
    assert pmesh.checker_mesh({}) is None


def test_empty_mesh_refused(monkeypatch):
    monkeypatch.setattr(pdevice, "local_devices", lambda: [])
    with pytest.raises(ValueError, match="no devices"):
        pmesh.default_mesh()
    with pytest.raises(ValueError, match="at least one"):
        pmesh.Mesh([])


def test_cuda_entries_raise_without_a_card():
    m = pmesh.Mesh(["cuda:0", "cuda:0"])
    with pytest.raises(pdevice.DeviceUnavailable):
        m.shard_devices()


@pytest.mark.parametrize("args,match", [
    (("nocolon", 2, 0), "host:port"),
    (("", 2, 0), "host:port"),
    (("h:1234", 2, 5), "outside"),
    (("h:1234", 2, -1), "outside"),
])
def test_multihost_init_messages_equal_the_reference(args, match):
    msgs = []
    for mod in (pmesh, rmesh):
        with pytest.raises(ValueError, match=match) as e:
            mod.multihost_init(*args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- B5: the frontier-sharded BFS against the reference ----------------------


@pytest.fixture(scope="module")
def rbeam():
    return rmesh.default_mesh(8, axis="beam")


B5_CASES = [(96, 0.0, 4, 1, False), (96, 0.0, 4, 13, True),
            (256, 0.1, 8, 2, False), (128, 0.0, 4, 7, False),
            (160, 0.05, 6, 21, True)]


@pytest.mark.parametrize("n,info,procs,seed,bad", B5_CASES)
def test_sharded_bfs_verdicts_equal_the_reference(rbeam, n, info, procs,
                                                  seed, bad):
    kw = dict(procs=procs, info_rate=info, seed=seed, bad=bad)
    p = ppack(pgen(n, **kw), pcas().packed().encode)
    r = rpack(rgen(n, **kw), rcas().packed().encode)
    port = pdevice_check(p, pcas().packed(), witness=False,
                         time_limit_s=120, mesh=pmesh.default_mesh(
                             8, axis="beam"), device="cpu")
    alone = pdevice_check(p, pcas().packed(), witness=False,
                          time_limit_s=120, device="cpu")
    ref = rdevice(r, rcas().packed(), witness=False, time_limit_s=120,
                  mesh=rbeam)
    # The reference's own sharded search, level for level; per-shard
    # candidate overflow may leave it "unknown" where one device
    # decides (seed 21), never a different decisive verdict.
    assert port.valid == ref.valid
    assert port.configs_explored == ref.configs_explored > 0
    assert port.valid in (alone.valid, "unknown")


def test_sharded_bfs_on_a_two_entry_mesh_of_one_device():
    """The chip script's shape: one device named twice."""
    pm = pcas().packed()
    two = pmesh.Mesh(["cpu", "cpu"], ("beam",))
    for seed, bad in ((13, True), (7, False)):
        p = ppack(pgen(128, procs=4, info_rate=0.0, seed=seed, bad=bad),
                  pm.encode)
        got = pdevice_check(p, pm, witness=False, mesh=two, device="cpu")
        want = pdevice_check(p, pm, witness=False, device="cpu")
        assert got.valid == want.valid == (not bad)
        assert got.configs_explored == want.configs_explored


def test_mesh_size_three_is_the_reference_error():
    pm = pcas().packed()
    p = ppack(pgen(64, procs=4, info_rate=0.0, seed=1), pm.encode)
    with pytest.raises(ValueError) as port:
        pdevice_check(p, pm, mesh=pmesh.default_mesh(3, axis="beam"),
                      device="cpu")
    rp = rpack(rgen(64, procs=4, info_rate=0.0, seed=1),
               rcas().packed().encode)
    with pytest.raises(ValueError) as ref:
        rdevice(rp, rcas().packed(), mesh=rmesh.default_mesh(3, axis="beam"))
    assert str(port.value) == str(ref.value)


# -- keys split over the mesh: the batched BFS -------------------------------


def _packs(pack, gen, pm, n_keys, seed0):
    return [pack(gen(24 + (s % 5) * 4, procs=4, info_rate=0.05,
                     seed=seed0 + s, bad=(s % 4 == 1)), pm.encode)
            for s in range(n_keys)]


@pytest.mark.parametrize("n_keys", [3, 8, 13, 20])
def test_batched_split_equals_the_reference_and_the_unsplit_run(n_keys):
    pm, rpm = pcas().packed(), rcas().packed()
    packs = _packs(ppack, pgen, pm, n_keys, 300)
    split = pbatched(packs, pm, beam=32, mesh=pmesh.default_mesh(),
                     device="cpu")
    alone = pbatched(packs, pm, beam=32, device="cpu")
    ref = rbatched(_packs(rpack, rgen, rpm, n_keys, 300), rpm, beam=32,
                   mesh=rmesh.default_mesh())
    assert split.valid == alone.valid == ref.valid
    assert split.explored.tolist() == alone.explored.tolist()
    assert split.explored.tolist() == ref.explored.tolist()
    assert len(split.valid) == n_keys


def test_batched_split_over_one_device_named_twice():
    pm = pcas().packed()
    packs = _packs(ppack, pgen, pm, 9, 500)
    two = pmesh.Mesh(["cpu", "cpu"])
    split = pbatched(packs, pm, beam=32, mesh=two, device="cpu")
    alone = pbatched(packs, pm, beam=32, device="cpu")
    assert split.valid == alone.valid
    assert split.explored.tolist() == alone.explored.tolist()


# -- keys split over the mesh: the Elle screen -------------------------------


def _graphs(G, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = G()
        v = int(rng.integers(2, 12))
        for a in range(v):
            g.add_vertex(a)
        for _ in range(int(rng.integers(1, 2 * v))):
            a, b = (int(x) for x in rng.integers(0, v, size=2))
            if a < b or (i % 3 == 0 and a != b):
                g.add_edge(a, b, "ww")
        out.append(g)
    return out


@pytest.mark.parametrize("n,seed", [(11, 1), (8, 2), (3, 3), (29, 4)])
def test_screen_split_equals_the_reference_and_the_unsplit_run(n, seed):
    port = pscreen(_graphs(PGraph, n, seed), mesh=pmesh.default_mesh(),
                   device="cpu")
    alone = pscreen(_graphs(PGraph, n, seed), device="cpu")
    ref = rscreen(_graphs(RGraph, n, seed), mesh=rmesh.default_mesh())
    assert port.tolist() == alone.tolist() == ref.tolist()
    assert len(port) == n


# -- IndependentChecker with the test map's "mesh" ---------------------------


def _mixed(history, kv, gen, n_keys, bad):
    ops = []
    for i in range(n_keys):
        h = gen(50, procs=4, info_rate=0.05, seed=700 + i, bad=(i in bad))
        ops += [o.replace(value=kv(f"k{i}", o.value)) for o in h]
    return history(ops)


def test_independent_checker_on_a_mesh_equals_the_reference():
    bad = {2, 9, 15}
    pclear()
    port = PInd(PLin(pcas(), time_limit_s=600.0, device="cpu"),
                device="cpu").check(
        {"mesh": pmesh.default_mesh(8)},
        _mixed(phistory, pkv, pgen, 18, bad), {})
    pclear()
    alone = PInd(PLin(pcas(), time_limit_s=600.0, device="cpu"),
                 device="cpu").check({}, _mixed(phistory, pkv, pgen, 18,
                                                bad), {})
    rclear()
    ref = RInd(RLin(rcas(), time_limit_s=600.0)).check(
        {"mesh": rmesh.default_mesh(8)}, _mixed(rhistory, rkv, rgen, 18, bad),
        {})
    assert port["valid"] is alone["valid"] is ref["valid"] is False
    assert sorted(port["failures"]) == sorted(ref["failures"]) == \
        sorted(f"k{i}" for i in bad)
    for k, r in ref["results"].items():
        assert port["results"][k]["valid"] == r["valid"] == \
            alone["results"][k]["valid"], k
