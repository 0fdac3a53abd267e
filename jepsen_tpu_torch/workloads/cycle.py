"""Generic transactional-cycle workload: user-supplied dependency
analyzers.

The port's copy of `jepsen_tpu/workloads/cycle.py` (jepsen's
tests/cycle.clj:9-16, which wraps `elle.core/check` around a
caller-provided analyzer function).  Here an analyzer is any callable

    analyzer(history: History) -> DepGraph

building a typed dependency graph over operation indices; the checker
runs the layered cycle search of checker/elle/graph.py over it (or the
device screen of ops/scc.py when `device` asks for one) and reports
each cycle with its Adya classification.  Several analyzers may be combined — their edges
are unioned into one graph, like elle.core's `combine`.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Union

import torch

from ..checker.core import Checker
from ..checker.elle.graph import DepGraph, check_cycles
from ..history.core import History, Op

Analyzer = Callable[[History], DepGraph]


def combine(graphs: Iterable[DepGraph]) -> DepGraph:
    """Unions several dependency graphs into one (edge types merge)."""
    out = DepGraph()
    for g in graphs:
        out.vertices |= g.vertices
        for src, dsts in g.adj.items():
            for dst, types in dsts.items():
                for t in types:
                    out.add_edge(src, dst, t)
    return out


def realtime_graph(history: History) -> DepGraph:
    """Stock analyzer: op A happens-before op B when A's completion
    precedes B's invocation (elle.core's realtime analyzer).  Edges
    land on invocation indices.

    Sparse but reachability-preserving reduction over the interval
    order: sweep events in history order, keeping a frontier of
    completed ops that is always an antichain (mutually concurrent).
    Every invocation links from the whole frontier; when an op A
    completes, frontier members that finished before A *invoked* are
    retired — any later op C has inv(C) > comp(A), so the path
    X -> A -> C covers the direct X -> C edge.  Edge count is bounded
    by ops x max-concurrency instead of ops^2."""
    g = DepGraph()
    events: list[tuple[int, int, Op, int]] = []  # (t, kind, inv, comp-t)
    for o in history:
        if not o.is_invoke:
            continue
        comp = history.completion(o)
        # Only :ok ops are realtime-ordered: an :info op's effect may
        # land arbitrarily later than its info marker, and a :fail op
        # never took effect (elle.core's realtime analyzer).
        if comp is None or not comp.is_ok:
            continue
        events.append((o.index, 0, o, comp.index))
        events.append((comp.index, 1, o, comp.index))
    events.sort(key=lambda e: (e[0], e[1]))
    frontier: list[tuple[Op, int]] = []  # completed, pairwise concurrent
    for _, kind, inv, comp_t in events:
        if kind == 0:
            for done, _dt in frontier:
                g.add_edge(done.index, inv.index, "realtime")
        else:
            frontier = [
                (x, dt) for (x, dt) in frontier if dt >= inv.index
            ]
            frontier.append((inv, comp_t))
    return g


def process_graph(history: History) -> DepGraph:
    """Stock analyzer: successive invocations of the same process are
    ordered (elle.core's process analyzer)."""
    g = DepGraph()
    last: dict[Any, Op] = {}
    for o in history:
        if not o.is_invoke:
            continue
        prev = last.get(o.process)
        if prev is not None:
            g.add_edge(prev.index, o.index, "process")
        last[o.process] = o
    return g


class CycleChecker(Checker):
    """checker(analyze-fn) of tests/cycle.clj:9-16.  `device`: "off"
    (the default, as in the JAX package) is the host search alone, one
    record per SCC per layer; "auto" and "on" screen the graph on the
    card, and a torch device (or "cuda", "cpu") screens it there, one
    record per layer (checker/elle `_device_cycle_fn`)."""

    def __init__(self, *analyzers: Analyzer,
                 device: Union[str, torch.device] = "off"):
        if not analyzers:
            raise ValueError("need at least one analyzer")
        self.analyzers = analyzers
        self.device = device

    def check(self, test: dict, history: History, opts: dict) -> dict:
        from ..checker.elle import _device_cycle_fn

        h = history.client_ops()
        graph = combine(a(h) for a in self.analyzers)
        cycles = (_device_cycle_fn(self.device) or check_cycles)(graph)
        anomaly_types = sorted({c["type"] for c in cycles})
        res = {
            "valid": not cycles,
            "anomaly-types": anomaly_types,
            "anomalies": cycles,
            "vertices": len(graph.vertices),
            "edges": graph.n_edges(),
        }
        from ..checker.elle import write_artifacts

        write_artifacts(res, opts, "elle-cycle")
        return res


def checker(*analyzers: Analyzer,
            device: Union[str, torch.device] = "off") -> CycleChecker:
    return CycleChecker(*analyzers, device=device)
