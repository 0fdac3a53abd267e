"""The port's Elle cycle screen (jepsen_tpu_torch/ops/scc.py) against
the JAX package's (jepsen_tpu/ops/scc.py) on the CPU: the same graphs go
through both, and everything must be equal exactly — screen flags, the
raw extraction outputs (found, u, v, parent, scc_size), the layered
records and the routes of check_cycles_device.  The port runs with
device="cpu" (float32 products; a test holds bfloat16 equal), the JAX
package on JAX_PLATFORMS=cpu.  The mesh case of tests/test_scc_device.py
is not ported (one card)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jepsen_tpu.checker.elle import graph as ref_graph
from jepsen_tpu.ops import scc as ref_scc
from jepsen_tpu_torch import device as D
from jepsen_tpu_torch.checker.elle import graph as port_graph
from jepsen_tpu_torch.ops import scc

CPU = "cpu"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU work in these tests runs on one thread: the suite
    runs several test processes at once, and on oversubscribed cores
    torch's parallel regions in the extraction's per-level loop stall
    and take the other processes' cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(edges, vertices=()):
    """(reference DepGraph, port DepGraph) built from the same edge list
    in the same order."""
    out = []
    for G in (ref_graph.DepGraph, port_graph.DepGraph):
        g = G()
        for v in vertices:
            g.add_vertex(v)
        for a, b, t in edges:
            g.add_edge(a, b, t)
        out.append(g)
    return tuple(out)


def chain(n=5):
    return [(i, i + 1, "ww") for i in range(n - 1)]


def two_cycle():
    return [(0, 1, "ww"), (1, 0, "ww")]


def long_cycle(n=9):
    return [(i, (i + 1) % n, "wr" if i % 2 else "ww") for i in range(n)]


def diamond():
    return [(0, 1, "ww"), (0, 2, "wr"), (1, 3, "rw"), (2, 3, "ww")]


def rw_cycle():
    return [(0, 1, "ww"), (1, 2, "wr"), (2, 0, "rw")]


def ring_with_noise(n=1000, noise=2000, seed=7):
    """tests/test_scc_device.py's 1,000-vertex ww ring with forward
    wr/rw noise edges (one SCC spanning every vertex)."""
    rng = np.random.default_rng(seed)
    edges = [(i, (i + 1) % n, "ww") for i in range(n)]
    for _ in range(noise):
        a, b = sorted(rng.integers(0, n, size=2))
        if a != b:
            edges.append((int(a), int(b),
                          "wr" if rng.random() < 0.5 else "rw"))
    return edges


def random_edges(rng, n, m, types=("ww", "wr", "rw")):
    edges = []
    for _ in range(m):
        a, b = rng.integers(0, n, size=2)
        if a != b:
            edges.append((int(a), int(b), str(rng.choice(types))))
    return edges


def assert_cycle_valid(g, cycle, required=None):
    """Closed, every step a real edge, and (when a layer demands it) at
    least one step carrying a required type."""
    assert len(cycle) >= 2 and cycle[0] == cycle[-1]
    carried = set()
    for a, b in zip(cycle, cycle[1:]):
        ts = g.edge_types(a, b)
        assert ts, f"cycle uses nonexistent edge {a}->{b}"
        carried |= ts
    if required:
        assert carried & set(required), (carried, required)


REQUIRED = {"G1c": {"wr"}, "G-single": {"rw"}, "G2-item": {"rw"}}


# -- sizes and packing ------------------------------------------------------


def test_steps_and_bucket_match_reference():
    for V in list(range(1, 70)) + [127, 128, 129, 1023, 1024, 1025, 4096]:
        assert scc._steps(V) == max(1, int(np.ceil(np.log2(max(V, 2)))))
        assert scc._bucket(V, 8) == ref_scc._bucket(V, 8)


def test_pack_adjacency_equals_reference():
    graphs = [both(two_cycle()), both(chain(5)), both(diamond()),
              both([(30, 10, "ww"), (10, 20, "rw")], vertices=[5])]
    want, wmaps = ref_scc.pack_adjacency([g[0] for g in graphs])
    got, gmaps = scc.pack_adjacency([g[1] for g in graphs])
    assert np.array_equal(got, want) and gmaps == wmaps
    assert got.shape[0] == 4
    assert got.shape[1] >= 5 and (got.shape[1] & (got.shape[1] - 1)) == 0
    assert gmaps[0] == [0, 1]


# -- the closure screen (B7) -------------------------------------------------


def test_screen_exact_on_mixed_batch():
    graphs = [both(e) for e in (chain(), two_cycle(), long_cycle(),
                                diamond(), rw_cycle(), [])]
    want = ref_scc.screen_cycles([g[0] for g in graphs])
    got = scc.screen_cycles([g[1] for g in graphs], device=CPU)
    assert got.tolist() == want.tolist() == [False, True, True, False, True,
                                             False]
    assert scc.screen_cycles([], device=CPU).shape == (0,)


@pytest.mark.parametrize("seed", [7, 11])
def test_screen_random_parity(seed):
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(40):
        n = int(rng.integers(2, 12))
        graphs.append(both(random_edges(rng, n, int(rng.integers(1, 3 * n)),
                                        types=("ww",))))
    want = ref_scc.screen_cycles([g[0] for g in graphs])
    got = scc.screen_cycles([g[1] for g in graphs], device=CPU)
    assert got.tolist() == want.tolist()
    for (_, g), f in zip(graphs, got):
        assert bool(f) == bool(g.sccs())


def test_closure_float32_equals_bfloat16():
    """The CPU runs the closure in float32, the card in bfloat16: both
    are exact on 0/1 entries, so the reachability and the extraction
    outputs must be equal."""
    rng = np.random.default_rng(3)
    adj = rng.random((6, 64, 64)) < 0.03
    adj[0] = np.roll(np.eye(64, dtype=bool), 1, axis=1)  # a 64-ring
    a = torch.from_numpy(adj)
    f32 = scc.closure(a, torch.float32)
    bf16 = scc.closure(a, torch.bfloat16)
    assert torch.equal(f32, bf16)
    assert bool(f32[0].all())
    req = torch.from_numpy(rng.random((6, 64, 64)) < 0.5) & a
    for x, y in zip(scc.extract_batch(a, req, torch.float32),
                    scc.extract_batch(a, req, torch.bfloat16)):
        assert torch.equal(x, y)


def test_closure_dtype_per_device():
    assert scc.closure_dtype(torch.device("cpu")) == torch.float32
    assert scc.closure_dtype(torch.device("cuda")) == torch.bfloat16


# -- the raw extraction (B8) against the reference's vmapped kernel ----------


def ref_extract(adj_all, adj_req):
    K, V, _ = adj_all.shape
    fn = ref_scc._get_extract_kernel(K, V)
    return [np.asarray(x) for x in fn(jnp.asarray(adj_all),
                                      jnp.asarray(adj_req))]


def port_extract(adj_all, adj_req):
    return [x.numpy() for x in scc.extract_batch(
        torch.from_numpy(adj_all), torch.from_numpy(adj_req),
        torch.float32)]


def tie_batch(seed, V=32):
    """A batch whose rows and columns hold several candidates (dense
    random graphs), rings of different lengths (their BFS ends at
    different levels), a self-loop in adj_all (u == v: no BFS), an
    empty graph and an adj_req with nothing on a cycle (not found)."""
    rng = np.random.default_rng(seed)
    K = 10
    adj = np.zeros((K, V, V), dtype=bool)
    adj[0] = rng.random((V, V)) < 0.25
    adj[1] = rng.random((V, V)) < 0.08
    for k, n in ((2, 5), (3, 17), (4, V)):
        for i in range(n):
            adj[k, i, (i + 1) % n] = True
        adj[k, 0, rng.integers(1, n, size=3)] = True  # ties from 0
    adj[5, 3, 3] = True                 # a self-loop, the first candidate
    adj[5, 4, 5] = adj[5, 5, 4] = True
    # graph 6 is empty
    for i in range(V - 1):              # a DAG with ties into every vertex
        adj[7, i, i + 1:] = rng.random(V - i - 1) < 0.2
    adj[8] = adj[7]
    adj[8, V - 1, 0] = True             # ... closed by one back edge
    adj[9] = rng.random((V, V)) < 0.1
    req = adj.copy()
    req[1] &= rng.random((V, V)) < 0.3  # a restricted layer
    req[7] = adj[7]                     # acyclic: not found
    req[9] = False                      # nothing required: not found
    return adj, req


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extract_batch_equals_reference_elementwise(seed):
    adj, req = tie_batch(seed)
    want = ref_extract(adj, req)
    got = port_extract(adj, req)
    for name, w, g in zip(("found", "u", "v", "parent", "scc_size"),
                          want, got):
        assert g.shape == w.shape, name
        assert np.array_equal(g, w.astype(g.dtype)), (name, g, w)
    found = got[0]
    assert not found[6] and not found[7] and not found[9]
    assert got[1][6] == got[2][6] == 0
    assert found[5] and got[1][5] == got[2][5] == 3  # u == v: no BFS
    assert (got[3][5] >= 0).sum() == 1


def test_extract_first_candidate_ties():
    """Several qualifying edges in one row and in one column: u->v is
    the first in row-major order, and a BFS vertex's parent is the
    lowest-numbered frontier vertex with an edge to it."""
    V = 8
    adj = np.zeros((1, V, V), dtype=bool)
    # 2 -> {3, 4, 5}, {3, 4, 5} -> 6, 6 -> 2: candidates (2,3) (2,4) ...
    for x in (3, 4, 5):
        adj[0, 2, x] = adj[0, x, 6] = True
    adj[0, 6, 2] = True
    got = port_extract(adj, adj.copy())
    want = ref_extract(adj, adj.copy())
    for g, w in zip(got, want):
        assert np.array_equal(g, w.astype(g.dtype))
    found, u, v, parent, size = got
    assert found[0] and (u[0], v[0]) == (2, 3) and size[0] == 5
    # BFS 3 -> 6 -> 2: 6's parent is 3, the only frontier vertex.
    assert parent[0][6] == 3 and parent[0][2] == 6


def test_extract_counts_levels_and_frozen_graphs():
    """One host loop for the batch: its levels are the longest graph's
    BFS; the graphs advanced per level are counted too."""
    adj, req = tie_batch(5)
    D.counters.clear()
    port_extract(adj, req)
    levels = D.counters["scc_bfs_levels"]
    assert levels >= 31  # the 32-ring's BFS from 1 back to 0
    assert D.counters["scc_bfs_graph_levels"] < levels * adj.shape[0]
    assert D.counters["host_syncs"] == 0  # CPU reads are not syncs


# -- extraction and layered records through the public functions -------------


def test_extract_plain_cycle_batch():
    pairs = [both(two_cycle()), both(long_cycle()), both(chain())]
    want = ref_scc.extract_cycles_device([p[0] for p in pairs])
    got = scc.extract_cycles_device([p[1] for p in pairs], device=CPU)
    assert got == [tuple(w) if w else None for w in want]
    (c0, s0), (c1, s1), none = got
    assert_cycle_valid(pairs[0][1], c0)
    assert_cycle_valid(pairs[1][1], c1)
    assert (s0, s1, none) == (2, 9, None)


def test_extract_requires_edge_type():
    r, p = both(two_cycle())
    want = ref_scc.extract_cycles_device([r, r], require=[{"rw"}, {"ww"}])
    got = scc.extract_cycles_device([p, p], require=[{"rw"}, {"ww"}],
                                    device=CPU)
    assert got[0] is None and want[0] is None
    assert got[1] == tuple(want[1])
    assert_cycle_valid(p, got[1][0], {"ww"})


def layered_case(name):
    return {
        "two-cycle": two_cycle,
        "long-cycle": long_cycle,
        "rw-cycle": rw_cycle,
        "diamond": diamond,
        "untyped-300": lambda: [(i, (i + 1) % 300,
                                 "realtime" if i % 2 else "process")
                                for i in range(300)],
        "no-masking": lambda: [(1, 2, "wr"), (2, 1, "ww"), (1, 3, "rw"),
                               (3, 1, "ww")],
        "random-60": lambda: random_edges(np.random.default_rng(60), 60, 90),
    }[name]()


@pytest.mark.parametrize("name", ["two-cycle", "long-cycle", "rw-cycle",
                                  "diamond", "untyped-300", "no-masking",
                                  "random-60"])
def test_layered_records_equal_reference(name):
    r, p = both(layered_case(name))
    want = ref_scc.check_cycles_layered_device(r)
    got = scc.check_cycles_layered_device(p, device=CPU)
    assert got == want
    assert {x["type"] for x in got} == {x["type"]
                                        for x in ref_graph.check_cycles(r)}
    for rec in got:
        assert_cycle_valid(p, rec["cycle"], REQUIRED.get(rec["type"]))


def test_layered_batch_record_order_equals_reference():
    """Several graphs in one batch: every layer of every graph rides one
    extraction, records come per graph in layer order, and a leftover
    sharing vertices with a reported cycle is skipped."""
    cases = ["two-cycle", "untyped-300", "diamond", "no-masking",
             "random-60", "rw-cycle"]
    pairs = [both(layered_case(c)) for c in cases] + [both([], [4])]
    D.counters.clear()
    got = scc.check_cycles_layered_device_batch([p[1] for p in pairs],
                                                device=CPU)
    assert D.counters["scc_extractions"] == 1
    want = ref_scc.check_cycles_layered_device_batch([p[0] for p in pairs])
    assert got == want


def test_thousand_vertex_ring_device_extraction():
    r, p = both(ring_with_noise())
    got = scc.check_cycles_layered_device(p, device=CPU)
    assert got == ref_scc.check_cycles_layered_device(r)
    assert {x["type"] for x in got} == {x["type"]
                                        for x in ref_graph.check_cycles(r)}
    for rec in got:
        assert_cycle_valid(p, rec["cycle"], REQUIRED.get(rec["type"]))
        assert rec["scc-size"] == 1000


def test_layer_entries_order():
    _, p = both(rw_cycle())
    layers = scc.layer_entries(p)
    assert [(req, t) for _, req, t in layers] == [
        (None, "G0"), ({"wr"}, "G1c"), ({"rw"}, None), (None, scc._LAYER4)]
    assert scc.layer_entries(port_graph.DepGraph()) == []


# -- check_cycles_device: verdicts and routes ---------------------------------


def test_check_cycles_device_equals_reference():
    pairs = [both(e) for e in (chain(), two_cycle(), long_cycle(),
                               rw_cycle(), diamond())]
    want = ref_scc.check_cycles_device([p[0] for p in pairs])
    got = scc.check_cycles_device([p[1] for p in pairs], device=CPU)
    assert got == want
    for (r, _), d in zip(pairs, got):
        assert [c["type"] for c in d] == [c["type"]
                                          for c in ref_graph.check_cycles(r)]


def ring(n, etype="ww"):
    return [(i, (i + 1) % n, etype) for i in range(n)]


def test_check_cycles_device_routes(monkeypatch):
    """Small flagged -> host check_cycles; flagged at >= 256 vertices ->
    one batched device extraction; above max_device_vertices -> host,
    unscreened; acyclic -> no records."""
    cases = [ring(300), chain(), ring(5), ring(40, "rw") + [(0, 1, "ww")],
             ring(1100), ring(260, "wr") + ring(2, "ww")]
    pairs = [both(e) for e in cases]
    calls = []
    orig = scc.check_cycles_layered_device_batch

    def spy(graphs, **kw):
        calls.append(len(graphs))
        return orig(graphs, **kw)

    monkeypatch.setattr(scc, "check_cycles_layered_device_batch", spy)
    D.counters.clear()
    got = scc.check_cycles_device([p[1] for p in pairs], device=CPU)
    assert calls == [2]  # the 300-ring and the 260-ring, one batch
    assert D.counters["scc_screens"] == 1
    assert D.counters["scc_extractions"] == 1
    want = ref_scc.check_cycles_device([p[0] for p in pairs])
    assert got == want
    assert {r["type"] for r in got[0]} == {"G0"}
    assert got[1] == []
    assert got[4] == ref_graph.check_cycles(pairs[4][0])  # host route


def test_check_cycles_device_all_big_makes_no_device_call():
    pairs = [both(ring(1030)), both(chain(1500))]
    D.counters.clear()
    got = scc.check_cycles_device([p[1] for p in pairs], device=CPU)
    assert D.counters["scc_screens"] == 0
    assert D.counters["scc_extractions"] == 0
    assert got == [ref_graph.check_cycles(pairs[0][0]), []]


def test_large_flagged_threshold_knob_equals_reference():
    pairs = [both(ring(300)), both(chain())]
    want = ref_scc.check_cycles_device([p[0] for p in pairs],
                                       device_extract_min_vertices=1000)
    got = scc.check_cycles_device([p[1] for p in pairs], device=CPU,
                                  device_extract_min_vertices=1000)
    assert got == want == [ref_graph.check_cycles(pairs[0][0]), []]


@pytest.mark.parametrize("fn", [
    lambda g: scc.screen_cycles([g]),
    lambda g: scc.extract_cycles_device([g]),
    lambda g: scc.check_cycles_layered_device(g),
    lambda g: scc.check_cycles_device([g]),
    lambda g: scc.check_cycles_device([port_graph.DepGraph()] * 0),
])
def test_entry_points_raise_without_cuda(monkeypatch, fn):
    """Every entry point defaults to the card and raises when it is
    missing, whatever the route; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, g = both(two_cycle())
    D.counters.clear()
    with pytest.raises(D.DeviceUnavailable):
        fn(g)
    assert D.counters["scc_screens"] == 0
