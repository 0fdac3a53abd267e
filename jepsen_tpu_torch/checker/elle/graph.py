"""Dependency graphs and cycle search for transactional anomaly checking.

The port's copy of `jepsen_tpu/checker/elle/graph.py`: the host half of
the Elle-equivalent, the exact oracle of the device screen and the
route for graphs too large for it.

A DepGraph has integer vertices (transaction indices into the history)
and typed directed edges: "ww" (write-write), "wr" (write-read), "rw"
(read-write anti-dependency), "realtime", "process".  Cycle search:
Tarjan SCC, then a shortest cycle inside each nontrivial SCC (BFS),
classified by the edge types it contains:

    G0        cycle of ww edges only
    G1c       cycle of ww/wr edges (at least one wr)
    G2-item   cycle containing an rw edge (exactly one -> G-single)

The device screen for batches of graphs lives in
jepsen_tpu_torch.ops.scc (check_cycles_device): a transitive-closure
screen settles acyclic graphs on the card, and this module's exact
search extracts and classifies cycles for the flagged ones.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Any, Iterable, Optional

EDGE_TYPES = ("ww", "wr", "rw", "realtime", "process")


class DepGraph:
    def __init__(self) -> None:
        #: {src: {dst: set(edge-types)}}
        self.adj: dict[int, dict[int, set]] = defaultdict(dict)
        self.vertices: set[int] = set()

    def add_vertex(self, v: int) -> None:
        self.vertices.add(v)

    def add_edge(self, src: int, dst: int, etype: str) -> None:
        if src == dst:
            return  # self-edges are internal anomalies, handled separately
        self.vertices.add(src)
        self.vertices.add(dst)
        self.adj[src].setdefault(dst, set()).add(etype)

    def edge_types(self, src: int, dst: int) -> set:
        return self.adj.get(src, {}).get(dst, set())

    def out_edges(self, v: int) -> Iterable[int]:
        return self.adj.get(v, {}).keys()

    def n_edges(self) -> int:
        return sum(len(d) for d in self.adj.values())

    def restricted(self, etypes: Iterable[str]) -> "DepGraph":
        """Subgraph keeping only edges of the given types."""
        keep = set(etypes)
        g = DepGraph()
        g.vertices |= self.vertices
        for src, dsts in self.adj.items():
            for dst, types in dsts.items():
                inter = types & keep
                for t in inter:
                    g.add_edge(src, dst, t)
        return g

    # -- SCC (Tarjan, iterative) ----------------------------------------

    def sccs(self) -> list[list[int]]:
        """Strongly-connected components, nontrivial ones only (size > 1;
        self-loops are excluded by construction)."""
        index_of: dict[int, int] = {}
        low: dict[int, int] = {}
        on_stack: set[int] = set()
        stack: list[int] = []
        out: list[list[int]] = []
        counter = [0]

        for root in self.vertices:
            if root in index_of:
                continue
            # Iterative Tarjan: (vertex, iterator over successors).
            work = [(root, iter(self.out_edges(root)))]
            index_of[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                v, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index_of:
                        index_of[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(self.out_edges(w))))
                        advanced = True
                        break
                    elif w in on_stack:
                        low[v] = min(low[v], index_of[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    pv = work[-1][0]
                    low[pv] = min(low[pv], low[v])
                if low[v] == index_of[v]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == v:
                            break
                    if len(comp) > 1:
                        out.append(comp)
        return out

    # -- cycle recovery --------------------------------------------------

    def find_cycle_in(self, component: Iterable[int]) -> Optional[list[int]]:
        """A shortest cycle within a component: BFS from each vertex back
        to itself, restricted to the component."""
        comp = set(component)
        best: Optional[list[int]] = None
        for start in comp:
            # BFS over comp edges from start; stop when we return.
            parent: dict[int, int] = {}
            q = deque([start])
            seen = {start}
            found = None
            while q and found is None:
                v = q.popleft()
                for w in self.out_edges(v):
                    if w == start:
                        found = v
                        break
                    if w in comp and w not in seen:
                        seen.add(w)
                        parent[w] = v
                        q.append(w)
            if found is not None:
                path = [found]
                while path[-1] != start:
                    path.append(parent[path[-1]])
                path.reverse()
                cycle = path + [start]  # start ... found, start
                if best is None or len(cycle) < len(best):
                    best = cycle
        return best

    def cycle_edge_types(self, cycle: list[int]) -> set:
        types: set = set()
        for a, b in zip(cycle, cycle[1:]):
            types |= self.edge_types(a, b)
        return types


def classify_cycle(graph: DepGraph, cycle: list[int]) -> str:
    """Adya-style classification by participating dependency types:
    G-single = exactly one anti-dependency edge, G2-item = several."""
    rw_edges = 0
    types: set = set()
    for a, b in zip(cycle, cycle[1:]):
        ts = graph.edge_types(a, b)
        types |= ts
        # Any edge carrying an anti-dependency counts: a cycle whose
        # single rw edge also happens to be ww/wr is still G-single
        # (Elle's minimal-explanation rule).
        if "rw" in ts:
            rw_edges += 1
    data = types & {"ww", "wr", "rw"}
    if "rw" in data:
        return "G-single" if rw_edges == 1 else "G2-item"
    if "wr" in data:
        return "G1c"
    if data == {"ww"}:
        return "G0"
    return "cycle"  # realtime/process-only: should not happen alone


def cycle_explanation(graph: DepGraph, cycle: list[int]) -> list[dict]:
    """[{from, to, types}] steps for reporting."""
    return [
        {"from": a, "to": b, "types": sorted(graph.edge_types(a, b))}
        for a, b in zip(cycle, cycle[1:])
    ]


def _cycle_record(graph: DepGraph, cycle: list[int], comp: Iterable[int],
                  forced_type: Optional[str] = None) -> dict:
    return {
        "type": forced_type or classify_cycle(graph, cycle),
        "cycle": cycle,
        "steps": cycle_explanation(graph, cycle),
        "scc-size": len(list(comp)),
    }


def find_cycle_with_edge(
    graph: DepGraph, src: int, dst: int, component: Iterable[int]
) -> Optional[list[int]]:
    """A cycle through the specific edge src->dst: shortest path
    dst ~> src inside the component, closed with the edge."""
    comp = set(component)
    if dst == src:
        return None
    parent: dict[int, int] = {}
    q = deque([dst])
    seen = {dst}
    while q:
        v = q.popleft()
        for w in graph.out_edges(v):
            if w not in comp or w in seen:
                continue
            parent[w] = v
            if w == src:
                path = [src]
                while path[-1] != dst:
                    path.append(parent[path[-1]])
                path.reverse()  # dst ... src
                return [src] + path  # src -> dst -> ... -> src
            seen.add(w)
            q.append(w)
    return None


def check_cycles(graph: DepGraph) -> list[dict]:
    """Anomaly cycles found the way elle finds them: layered searches
    over restricted subgraphs, so a strong-anomaly cycle can't mask a
    weaker one (G0 is searched in the ww-only subgraph, G1c in ww+wr,
    G-single/G2-item in the full graph through an rw edge).  One
    representative cycle per SCC per layer."""
    out = []

    # Layer 1: G0 — pure write cycles.
    g0 = graph.restricted(["ww", "realtime", "process"])
    for comp in g0.sccs():
        cycle = g0.find_cycle_in(comp)
        if cycle is not None:
            out.append(_cycle_record(g0, cycle, comp, "G0"))

    # Layer 2: G1c — cycles of ww+wr containing at least one wr.
    g1 = graph.restricted(["ww", "wr", "realtime", "process"])
    for comp in g1.sccs():
        comp_set = set(comp)
        found = None
        for src in comp_set:
            for dst, types in g1.adj.get(src, {}).items():
                if dst in comp_set and "wr" in types:
                    found = find_cycle_with_edge(g1, src, dst, comp_set)
                    if found is not None:
                        break
            if found is not None:
                break
        if found is not None:
            out.append(_cycle_record(g1, found, comp, "G1c"))

    # Layer 3: G-single / G2-item — cycles through an rw edge in the
    # full graph.
    full_comps = graph.sccs()
    for comp in full_comps:
        comp_set = set(comp)
        found = None
        for src in comp_set:
            for dst, types in graph.adj.get(src, {}).items():
                if dst in comp_set and "rw" in types:
                    found = find_cycle_with_edge(graph, src, dst, comp_set)
                    if found is not None:
                        break
            if found is not None:
                break
        if found is not None:
            out.append(_cycle_record(graph, found, comp))

    # Layer 4: leftovers — an SCC that none of the typed layers could
    # explain is still a cycle (e.g. custom edge types from a
    # user-supplied analyzer, workloads/cycle.py); report it rather
    # than silently passing it as valid, like elle.core/check.
    covered = [set(r["cycle"]) for r in out]
    for comp in full_comps:
        comp_set = set(comp)
        if any(c <= comp_set for c in covered):
            continue
        cycle = graph.find_cycle_in(comp)
        if cycle is not None:
            out.append(_cycle_record(graph, cycle, comp))
    return out
