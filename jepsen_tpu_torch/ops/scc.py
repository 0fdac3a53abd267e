"""Batched cycle screening and witness-cycle extraction for dependency
graphs, on the card.

The port of `jepsen_tpu/ops/scc.py`, the device half of the
Elle-equivalent (checker/elle/graph.py).  Adya anomaly detection is
cycle detection over a dependency graph of transactions.  Each graph is
packed as a (V, V) boolean adjacency matrix, graphs are batched, and
the transitive closure comes from ceil(log2 V) batched matrix squarings
clamped to {0, 1}: a graph has a cycle iff its closure has a nonzero
diagonal.  On the card the squarings run in bfloat16 on the tensor
cores; on the CPU the same code runs in float32 (a bfloat16 product is
slow there).  Both are exact: the entries are 0 or 1 before every
product, so a product entry is a sum of nonnegative terms, which no
rounding takes to zero, and the clamp puts it back to 1.

Two device programs, each plain PyTorch (the JAX package's are
`jax.jit` programs, not Pallas kernels):

* the closure screen (`screen_cycles`; the reference's `has_cycle`);
* the extraction (`extract_batch`; the reference's vmapped `one`): per
  graph one required edge u->v whose head walks back to u, the size of
  u's strongly connected component, and parent pointers of a shortest
  v -> u path from a BFS over the whole graph.  The reference runs the
  BFS as a `lax.while_loop` under `vmap`; here one host loop advances
  every graph's frontier per level, with one device read per level
  (`device.counters["scc_bfs_levels"]` and `"host_syncs"`; the graphs
  advanced, summed over levels, in `"scc_bfs_graph_levels"`), and a
  graph whose search is over keeps its carry, as under `vmap`.

`device.counters["scc_screens"]` and `["scc_extractions"]` count the
calls of each program.  `check_cycles_device` is one "elle" profile
record (telemetry/profile.py), whose cost is the closures' and the
extraction levels' counts (telemetry/roofline.py).  The mesh sharding
of the screen is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import device as _device
from .. import telemetry
from ..telemetry import profile, roofline
from ..checker.elle.graph import (DepGraph, check_cycles, classify_cycle,
                                  cycle_explanation)

DeviceLike = Union[str, torch.device, None]


def _bucket(x: int, lo: int) -> int:
    w = lo
    while w < x:
        w *= 2
    return w


def closure_dtype(dev: torch.device) -> torch.dtype:
    """bfloat16 on the card (tensor cores), float32 on the CPU; the
    closure is exact in both."""
    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def pack_adjacency(
    graphs: Sequence[DepGraph],
) -> tuple[np.ndarray, list[list[int]]]:
    """Packs graphs into a (K, V, V) bool adjacency tensor (all edge
    types collapsed — the screen only needs reachability) plus each
    graph's dense-index -> vertex mapping (sorted vertices).  K is the
    number of graphs; V is the largest vertex count, bucketed from 8 by
    doubling."""
    V = _bucket(max((len(g.vertices) for g in graphs), default=1), 8)
    adj = np.zeros((len(graphs), V, V), dtype=bool)
    vertex_maps: list[list[int]] = []
    for k, g in enumerate(graphs):
        verts = sorted(g.vertices)
        idx = {v: i for i, v in enumerate(verts)}
        vertex_maps.append(verts)
        for src, dsts in g.adj.items():
            si = idx[src]
            for dst in dsts:
                adj[k, si, idx[dst]] = True
    return adj, vertex_maps


def closure(adj: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(K, V, V) bool adjacency -> (K, V, V) bool reachability by paths
    of length >= 1: `a = min(a + a @ a, 1)`, ceil(log2 V) times, in
    `dtype`."""
    a = adj.to(dtype)
    for _ in range(roofline.closure_steps(adj.shape[-1])):
        a = torch.clamp_max(a + torch.bmm(a, a), 1.0)
    return a > 0


def has_cycle(adj: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(K, V, V) bool -> (K,) bool: a nonzero diagonal of the closure."""
    return closure(adj, dtype).diagonal(dim1=1, dim2=2).any(dim=1)


def screen_cycles(graphs: Sequence[DepGraph], *,
                  device: DeviceLike = "cuda") -> np.ndarray:
    """(n_graphs,) bool: True where the graph contains a cycle.  Runs
    on `device` (the card by default; raises when CUDA is asked for
    and missing)."""
    dev = _device.resolve(device)
    if not graphs:
        return np.zeros(0, dtype=bool)
    adj, _ = pack_adjacency(graphs)
    _device.count("scc_screens")
    with telemetry.span("elle.screen.block"):
        flags = has_cycle(torch.from_numpy(adj).to(dev), closure_dtype(dev))
        out = np.asarray(_device.host(flags), dtype=bool)
    if profile.cost_hooked():
        profile.note_cost(roofline.closure_cost(adj.shape[0], adj.shape[1]))
    return out


def extract_batch(adj_all: torch.Tensor, adj_req: torch.Tensor,
                  dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    """(adj_all (K,V,V) bool, adj_req (K,V,V) bool) ->
    (found (K,) bool, u (K,) int32, v (K,) int32, parent (K,V) int32,
    scc_size (K,) int32), element for element the reference's vmapped
    extraction.

    Per graph: the first edge u->v of adj_req in row-major order whose
    head v reaches u in adj_all (or u == v), u's SCC size, and parent
    pointers of a BFS v -> u over adj_all, where a vertex's parent is
    the lowest-numbered frontier vertex with an edge to it.  With no
    such edge, found is False, u = v = 0 and the BFS does not run."""
    K, V, _ = adj_all.shape
    dev = adj_all.device
    reach = closure(adj_all, dtype)
    eye = torch.eye(V, dtype=torch.bool, device=dev)
    m = (adj_req & (reach | eye).transpose(1, 2)).reshape(K, V * V)
    found = m.any(dim=1)
    # torch.argmax refuses bool; on uint8 it returns the first maximum,
    # as jnp.argmax does (index 0 when nothing qualifies).
    flat = torch.argmax(m.to(torch.uint8), dim=1)
    u = (flat // V).to(torch.int32)
    v = (flat % V).to(torch.int32)
    ks = torch.arange(K, device=dev)
    ul = u.long()
    scc_size = torch.clamp_min(
        (reach[ks, ul, :] & reach[ks, :, ul]).sum(dim=1), 1).to(torch.int32)

    ids = torch.arange(V, device=dev, dtype=torch.int32)
    start = (ids[None, :] == v[:, None]) & found[:, None]
    # u == v (a self-loop) needs no BFS.
    frontier = start & (u != v)[:, None]
    visited = start.clone()
    parent = torch.where(start, v[:, None], -1).to(torch.int32)
    adj_u8 = adj_all.to(torch.uint8)
    graph_levels = 0
    while True:
        active = frontier.any(dim=1) & ~visited[ks, ul]
        act = _device.host(active)
        if not any(act):
            break
        # Only the graphs still searching advance: a finished graph
        # keeps its carry, as the reference's while_loop under vmap.
        searching = [k for k, a in enumerate(act) if a]
        _device.count("scc_bfs_levels")
        _device.count("scc_bfs_graph_levels", len(searching))
        graph_levels += len(searching)
        sel = torch.tensor(searching, device=dev)
        vis = visited[sel]
        hit = frontier[sel].to(torch.uint8)[:, :, None] & adj_u8[sel]
        # Like argmax, max over a dimension returns the first maximum's
        # index: the lowest-numbered frontier vertex with an edge.
        reached, pred = hit.max(dim=1)
        nxt = reached.bool() & ~vis
        parent[sel] = torch.where(nxt, pred.to(torch.int32), parent[sel])
        frontier[sel] = nxt
        visited[sel] = vis | nxt
    if profile.cost_hooked():
        profile.note_cost(roofline.extract_cost(K, V, graph_levels))
    return found, u, v, parent, scc_size


def pack_required(
    graphs: Sequence[DepGraph],
    require: Optional[Sequence[Optional[set]]] = None,
) -> tuple[np.ndarray, np.ndarray, list[list[int]]]:
    """(adj_all, adj_req, vertex_maps): pack_adjacency's tensor, and the
    same restricted per graph to the edges carrying a type of
    `require[k]` (all edges where `require` or its entry is None)."""
    adj_all, vertex_maps = pack_adjacency(graphs)
    V = adj_all.shape[1]
    adj_req = adj_all.copy()
    if require is not None:
        for k, (g, types) in enumerate(zip(graphs, require)):
            if types is None:
                continue
            idx = {x: i for i, x in enumerate(vertex_maps[k])}
            req = np.zeros((V, V), dtype=bool)
            for src, dsts in g.adj.items():
                for dst, ts in dsts.items():
                    if ts & set(types):
                        req[idx[src], idx[dst]] = True
            adj_req[k] = req
    return adj_all, adj_req, vertex_maps


def extract_cycles_device(
    graphs: Sequence[DepGraph],
    *,
    require: Optional[Sequence[Optional[set]]] = None,
    device: DeviceLike = "cuda",
) -> list[Optional[tuple[list[int], int]]]:
    """Per graph: (cycle as a closed vertex list [v0..v0], scc_size),
    or None when no qualifying cycle exists.  `require[i]` restricts
    graph i's cycle to pass through at least one edge carrying one of
    those types (the elle layer rule); None means any cycle.

    The closure and the BFS run on `device`; the host only backtracks
    parent pointers."""
    dev = _device.resolve(device)
    if not graphs:
        return []
    adj_all, adj_req, vertex_maps = pack_required(graphs, require)
    K, V, _ = adj_all.shape
    _device.count("scc_extractions")
    with telemetry.span("elle.extract.block"):
        found, u, v, parent, scc = extract_batch(
            torch.from_numpy(adj_all).to(dev),
            torch.from_numpy(adj_req).to(dev), closure_dtype(dev))
        # One device read for every output.
        rows = _device.host(torch.cat(
            [torch.stack([found.to(torch.int32), u, v, scc], dim=1),
             parent], dim=1))
    out: list[Optional[tuple[list[int], int]]] = []
    for k in range(K):
        fk, uu, vv, sk = rows[k][:4]
        par = rows[k][4:]
        if not fk:
            out.append(None)
            continue
        verts = vertex_maps[k]
        # Path vv -> .. -> uu via parents, then the uu -> vv edge
        # closes it.  Format matches graph.find_cycle_in: closed list.
        path = [uu]
        guard = 0
        while path[-1] != vv and guard <= V:
            path.append(par[path[-1]])
            guard += 1
        if guard > V:  # unreachable by construction; never loop forever
            out.append(None)
            continue
        path.reverse()                    # vv .. uu
        cycle_idx = [vv] if uu == vv else path
        cycle = [verts[i] for i in cycle_idx] + [verts[vv]]
        out.append((cycle, sk))
    return out


def _record(g: DepGraph, cycle: list[int], scc_size: int,
            forced: Optional[str]) -> dict:
    return {
        "type": forced or classify_cycle(g, cycle),
        "cycle": cycle,
        "steps": cycle_explanation(g, cycle),
        "scc-size": scc_size,
    }


#: sentinel forced-type for the leftovers layer (classification is
#: derived from the cycle itself, like graph.check_cycles layer 4)
_LAYER4 = "__leftover__"


def layer_entries(graph: DepGraph) -> list[tuple[DepGraph, Optional[set],
                                                   Optional[str]]]:
    """(subgraph, required edge types, forced type) of each non-empty
    layer of `graph`, in the order G0, G1c, rw, leftovers."""
    layers = [
        (graph.restricted(["ww", "realtime", "process"]), None, "G0"),
        (graph.restricted(["ww", "wr", "realtime", "process"]),
         {"wr"}, "G1c"),
        (graph, {"rw"}, None),
        (graph, None, _LAYER4),
    ]
    return [layer for layer in layers if layer[0].vertices]


def check_cycles_layered_device_batch(
    graphs: Sequence[DepGraph], *, device: DeviceLike = "cuda",
) -> list[list[dict]]:
    """graph.check_cycles' layer structure with the cycle search on
    `device`, batched over graphs: G0 over the ww subgraph, G1c through
    a wr edge over ww+wr, G-single/G2-item through an rw edge over
    everything, and a leftovers layer (any cycle at all — custom or
    realtime/process-only edge types must not pass as valid, exactly
    like the host's layer 4).  Every layer of every graph rides ONE
    extract_cycles_device call.

    One witness record per non-empty layer per graph — the host path
    emits one per SCC per layer; this path exists for graphs whose
    host Tarjan is the bottleneck, where one certificate per anomaly
    class is what the checker consumes, at the cost of possibly
    under-reporting extra SCCs."""
    entries = [(gi, g, req, t) for gi, graph in enumerate(graphs)
               for g, req, t in layer_entries(graph)]
    results = extract_cycles_device(
        [e[1] for e in entries], require=[e[2] for e in entries],
        device=device,
    )
    out: list[list[dict]] = [[] for _ in graphs]
    leftovers: list[tuple[int, DepGraph, tuple]] = []
    for (gi, g, _req, forced), res in zip(entries, results):
        if res is None:
            continue
        if forced == _LAYER4:
            leftovers.append((gi, g, res))
            continue
        cycle, scc_size = res
        out[gi].append(_record(g, cycle, scc_size, forced))
    for gi, g, (cycle, scc_size) in leftovers:
        # Report only what the typed layers left unexplained: a cycle
        # sharing vertices with an already-reported one is the same
        # SCC seen again through a looser lens.
        seen = [set(r["cycle"]) for r in out[gi]]
        if any(set(cycle) & s for s in seen):
            continue
        out[gi].append(_record(g, cycle, scc_size, None))
    return out


def check_cycles_layered_device(graph: DepGraph, *,
                                device: DeviceLike = "cuda") -> list[dict]:
    return check_cycles_layered_device_batch([graph], device=device)[0]


def check_cycles_device(
    graphs: Sequence[DepGraph], *,
    device: DeviceLike = "cuda",
    max_device_vertices: int = 1024,
    device_extract_min_vertices: int = 256,
) -> list[list[dict]]:
    """Anomaly cycles per graph, device-screened: acyclic graphs are
    settled by the closure screen on `device`; small flagged graphs get
    the exact host layered search (same records as graph.check_cycles);
    large flagged graphs extract their witness cycles on the device too
    (check_cycles_layered_device_batch), all in one batch.  Graphs too
    large for a dense (V, V) matrix go to the host entirely.  The
    device is resolved first, so a missing card raises whatever the
    route."""
    dev = _device.resolve(device)
    with profile.capture("elle", device=dev, graphs=len(graphs)) as cap:
        out = _check_cycles_device(graphs, dev, max_device_vertices,
                                   device_extract_min_vertices)
        cap.outcome = {"flagged": sum(1 for recs in out if recs)}
    return out


def _check_cycles_device(graphs: Sequence[DepGraph], dev: torch.device,
                         max_device_vertices: int,
                         device_extract_min_vertices: int
                         ) -> list[list[dict]]:
    big = {
        i for i, g in enumerate(graphs)
        if len(g.vertices) > max_device_vertices
    }
    small_idx = [i for i in range(len(graphs)) if i not in big]
    out: list[list[dict]] = [[] for _ in graphs]
    device_bound: list[int] = []
    if small_idx:
        flags = screen_cycles([graphs[i] for i in small_idx], device=dev)
        for i, flagged in zip(small_idx, flags):
            if not flagged:
                continue
            if len(graphs[i].vertices) >= device_extract_min_vertices:
                device_bound.append(i)
            else:
                out[i] = check_cycles(graphs[i])
    if device_bound:
        recs = check_cycles_layered_device_batch(
            [graphs[i] for i in device_bound], device=dev,
        )
        for i, r in zip(device_bound, recs):
            out[i] = r
    for i in sorted(big):
        out[i] = check_cycles(graphs[i])
    return out
