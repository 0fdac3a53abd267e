"""Concurrency discipline: lock-order cycles, guarded-by contracts,
unsynced thread state.

~30 modules in this repo spawn threads: the interpreter's
worker-abandon protocol (lock + push-counter), the streaming front/back
buffer swap, the checkerd scheduler's condition queue, the health
monitor's probe loop, telemetry's registry lock with the span-exit hook
chained through profile captures.  This family machine-checks their
lock discipline over the shared interprocedural effect summaries
(analysis/effects.py).

``concurrency.lock-order-cycle`` (error) builds a **cross-module
lock-order graph**: every ``with lock:`` / ``lock.acquire()`` defines
an acquisition scope; acquiring M while holding L adds the edge L→M.
Calls made while holding a lock propagate through the program's
resolved call graph — including cross-module edges and the
unique-method dynamic-dispatch fallback — so the telemetry span-exit
hook chain contributes its edges without any annotation.  A cycle in
the graph is a deadlock that needs only the right interleaving;
reentrant self-edges (RLock / Condition) are exempt.

Lock identity is scoped to where the lock object lives: module-level
creations get ``module.NAME``, instance attributes
``module.Class.attr``, and function-local locks ``module.func.NAME`` —
so two unrelated local ``lock`` variables never alias into a false
cycle.

``concurrency.guarded-by`` (error) is the checked contract that ad-hoc
locking fixes graduate into.  Declare it where the state is
born::

    self._tickets = {}   # guarded-by: self._lock

and every read or write of ``self._tickets`` anywhere in the class must
then happen while ``self._lock`` is held — directly, or because every
resolved caller of the accessing method holds it at the call site (the
private-helper-under-lock idiom), checked as a fixpoint over the call
graph.  ``__init__`` is exempt (construction happens-before
publication), and so are helpers reachable only from ``__init__``.
The same contract is **inferred** for thread-spawning classes whose
attribute writes all happen under one common lock: the writes declare
the protocol, the reads are held to it.

``concurrency.unsynced-thread-attr`` (advice) remains the fallback for
attributes with *no* lock discipline to infer: written inside a
``threading.Thread(target=...)`` entry and read from other methods
with no common lock between write and read sites.  Attributes covered
by a guarded-by contract (annotated or inferred) are checked by the
contract instead, not double-reported here.
"""

from __future__ import annotations

import ast
from typing import Optional

from ..core import Finding, Module, walk
from .. import effects
from ..effects import Event, Key, LockScope, Program, import_map

# Older import sites (rules/device.py) use the leading-underscore
# names this module exported before the machinery moved to effects.py.
_Scope = LockScope
_import_map = import_map

RULES = {
    "concurrency.lock-order-cycle": (
        "error",
        "cycle in the cross-module lock-order graph (deadlock by "
        "interleaving)",
    ),
    "concurrency.guarded-by": (
        "error",
        "attribute with a guarded-by contract accessed without the "
        "declared lock held",
    ),
    "concurrency.unsynced-thread-attr": (
        "advice",
        "attribute written in a Thread entry point and read elsewhere "
        "with no common lock",
    ),
}


# ---------------------------------------------------------------------------
# lock-order-cycle
# ---------------------------------------------------------------------------


def _find_cycles(
    edges: dict[tuple[str, str], tuple[str, int, str]],
    reentrant: set[str],
) -> list[list[str]]:
    """Elementary cycles via DFS over the lock digraph, deduped by
    canonical rotation.  Self-loops on reentrant locks are fine."""
    graph: dict[str, set[str]] = {}
    for (a, b) in edges:
        if a == b and a in reentrant:
            continue
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    cycles: dict[tuple[str, ...], list[str]] = {}

    def dfs(start: str, node: str, path: list[str],
            on_path: set[str]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt == start:
                cyc = path[:]
                i = cyc.index(min(cyc))
                key = tuple(cyc[i:] + cyc[:i])
                cycles.setdefault(key, cyc)
            elif nxt not in on_path and nxt > start:
                # Only explore nodes > start: each cycle found once,
                # rooted at its smallest node.
                path.append(nxt)
                on_path.add(nxt)
                dfs(start, nxt, path, on_path)
                on_path.discard(nxt)
                path.pop()

    for start in sorted(graph):
        dfs(start, start, [start], {start})
    return list(cycles.values())


def _check_lock_order(prog: Program) -> list[Finding]:
    """Held×acquired edges straight off the effect summaries: direct
    acquisitions carry the held stack, and calls made under a lock
    contribute the callee's *transitive* acquisitions (the program
    fixpoint — cross-module, recursion-safe)."""
    edges: dict[tuple[str, str], tuple[str, int, str]] = {}
    for key, fi in prog.fns.items():
        for ev in fi.events:
            if ev.kind == "acquire":
                for h in ev.held:
                    edges.setdefault(
                        (h, ev.detail),
                        (fi.module.rel, ev.line, key[1]))
            elif ev.kind == "call" and ev.held:
                callee = prog.resolve(ev.detail, fi.module, fi.cls, fi)
                if callee is None:
                    continue
                for lock in prog.trans_acquires(callee):
                    for h in ev.held:
                        edges.setdefault(
                            (h, lock),
                            (fi.module.rel, ev.line, key[1]))

    out = []
    for cyc in _find_cycles(edges, prog.reentrant):
        ring = cyc + [cyc[0]]
        witnesses = []
        for a, b in zip(ring, ring[1:]):
            w = edges.get((a, b))
            if w:
                witnesses.append(f"{a} -> {b} at {w[0]}:{w[1]}")
        first = edges.get((ring[0], ring[1])) or ("<unknown>", 1, "?")
        out.append(Finding(
            rule="concurrency.lock-order-cycle", severity="error",
            path=first[0], line=first[1], symbol=first[2],
            message="lock-order cycle: " + "; ".join(witnesses)
                    + " — a timely interleaving deadlocks; impose one "
                    "global order or drop a lock before the call",
        ))
    return out


# ---------------------------------------------------------------------------
# guarded-by contracts
# ---------------------------------------------------------------------------


def _thread_entries(m: Module, cls: ast.ClassDef,
                    methods: dict[str, ast.FunctionDef]) -> set[str]:
    """Methods handed to ``threading.Thread(target=self.x)`` plus the
    intra-class closure of what they call — everything that runs ON
    the spawned thread."""
    entries: set[str] = set()
    for node in walk(cls):
        if not isinstance(node, ast.Call):
            continue
        seg = m.seg(node.func)
        if not seg.endswith("Thread"):
            continue
        for kw in node.keywords:
            if kw.arg != "target":
                continue
            t = kw.value
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                    and t.attr in methods):
                entries.add(t.attr)
    frontier = list(entries)
    while frontier:
        meth = methods[frontier.pop()]
        for node in walk(meth):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"
                    and node.func.attr in methods
                    and node.func.attr not in entries):
                entries.add(node.func.attr)
                frontier.append(node.func.attr)
    return entries


def _class_methods(m: Module, cls: ast.ClassDef
                   ) -> dict[str, ast.FunctionDef]:
    return {n.name: n for n in cls.body
            if isinstance(n, ast.FunctionDef)}


def _contracts(prog: Program) -> dict[tuple[str, str],
                                      dict[str, tuple[str, str]]]:
    """(module, class) -> {attr: (lock-id, "annotated"|"inferred")}.

    Annotated contracts come from ``# guarded-by:`` comments (parsed
    during the effect walk).  Inferred ones: in a thread-spawning
    class, an attribute whose every write outside ``__init__`` holds
    one common lock has declared its protocol by construction."""
    out: dict[tuple[str, str], dict[str, tuple[str, str]]] = {}
    for ck, guards in prog.guards.items():
        out[ck] = {attr: (lock, "annotated")
                   for attr, lock in guards.items()}
    for m in prog.modules:
        for cls in [n for n in walk(m.tree)
                    if isinstance(n, ast.ClassDef)]:
            methods = _class_methods(m, cls)
            if not _thread_entries(m, cls, methods):
                continue
            ck = (m.name, cls.name)
            have = out.setdefault(ck, {})
            # attr -> intersection of held locks over write sites
            common: dict[str, set[str]] = {}
            for mname, key in prog.classes.get(ck, {}).items():
                if mname == "__init__":
                    continue
                fi = prog.fns.get(key)
                if fi is None:
                    continue
                for site in fi.attr_sites:
                    if site.kind != "write":
                        continue
                    held = set(site.held)
                    if site.attr in common:
                        common[site.attr] &= held
                    else:
                        common[site.attr] = held
            for attr, locks in sorted(common.items()):
                if attr in have or not locks:
                    continue
                have[attr] = (sorted(locks)[0], "inferred")
    return out


def _check_guarded_by(prog: Program,
                      contracts: dict) -> list[Finding]:
    # safe(key, lock): every resolved caller holds `lock` at the call
    # site, or is __init__ of the owning class, or is itself safe —
    # the private-helper-under-lock idiom, closed over the call graph.
    memo: dict[tuple[Key, str, str], bool] = {}

    def safe(key: Key, lock: str, init_key: str,
             active: frozenset) -> bool:
        mk = (key, lock, init_key)
        if mk in memo:
            return memo[mk]
        if key in active:
            return True         # call cycle: don't condemn on it
        callers = prog.callers().get(key)
        if not callers:
            memo[mk] = False
            return False
        ok = True
        for ckey, ev in callers:
            if ckey[1] == init_key:
                continue        # construction happens-before publication
            if lock in ev.held:
                continue
            if not safe(ckey, lock, init_key, active | {key}):
                ok = False
                break
        memo[mk] = ok
        return ok

    out = []
    for (mod, cname), attrs in sorted(contracts.items()):
        methods = prog.classes.get((mod, cname), {})
        init_key = f"{cname}.__init__"
        for mname, key in sorted(methods.items()):
            if mname == "__init__":
                continue
            fi = prog.fns.get(key)
            if fi is None:
                continue
            flagged: set[str] = set()
            for site in fi.attr_sites:
                spec = attrs.get(site.attr)
                if spec is None or site.attr in flagged:
                    continue
                lock, how = spec
                if lock in site.held:
                    continue
                if safe(key, lock, init_key, frozenset()):
                    continue
                flagged.add(site.attr)      # one finding per (method, attr)
                short = lock.rsplit(".", 1)[-1]
                out.append(Finding(
                    rule="concurrency.guarded-by", severity="error",
                    path=fi.module.rel, line=site.line,
                    symbol=f"{cname}.{mname}",
                    message=(
                        f"self.{site.attr} is guarded by self.{short} "
                        f"({how}) but {site.kind} here without it — "
                        "hold the lock, or show every caller does"
                    ),
                ))
    return out


# ---------------------------------------------------------------------------
# unsynced-thread-attr (fallback advice for contract-less attributes)
# ---------------------------------------------------------------------------


def _check_thread_attrs(modules: list[Module],
                        contracts: dict) -> list[Finding]:
    out = []
    for m in modules:
        scope = LockScope(m)
        for cls in [n for n in walk(m.tree)
                    if isinstance(n, ast.ClassDef)]:
            methods = _class_methods(m, cls)
            entries = _thread_entries(m, cls, methods)
            if not entries:
                continue
            covered = contracts.get((m.name, cls.name), {})

            def _locks_held(node: ast.AST) -> set[str]:
                held = set()
                for p in m.parents(node):
                    if isinstance(p, ast.With):
                        for item in p.items:
                            r = scope.resolve(p, item.context_expr)
                            if r:
                                held.add(r[0])
                return held

            # attr -> union of locks held over its write sites in the
            # thread entry, and a witness line.
            writes: dict[str, tuple[set[str], int, bool]] = {}
            for ename in sorted(entries):
                for node in walk(methods[ename]):
                    tgt = None
                    if isinstance(node, ast.Assign):
                        tgt = node.targets
                    elif isinstance(node, ast.AugAssign):
                        tgt = [node.target]
                    if not tgt:
                        continue
                    for t in tgt:
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            held = _locks_held(node)
                            prev = writes.get(t.attr)
                            if prev is None:
                                writes[t.attr] = (held, node.lineno,
                                                  True)
                            else:
                                writes[t.attr] = (
                                    prev[0] | held,
                                    min(prev[1], node.lineno),
                                    prev[2] and bool(held),
                                )
            for attr, (wlocks, wline, _all) in sorted(writes.items()):
                if attr in covered:
                    continue        # the contract checks this one
                for mname, meth in methods.items():
                    if mname in entries or mname == "__init__":
                        continue
                    for node in walk(meth):
                        if (isinstance(node, ast.Attribute)
                                and isinstance(node.ctx, ast.Load)
                                and isinstance(node.value, ast.Name)
                                and node.value.id == "self"
                                and node.attr == attr):
                            rlocks = _locks_held(node)
                            if wlocks & rlocks:
                                continue
                            out.append(Finding(
                                rule="concurrency.unsynced-thread-attr",
                                severity="advice", path=m.rel,
                                line=node.lineno,
                                symbol=f"{cls.name}.{mname}",
                                message=(
                                    f"self.{attr} is written in thread "
                                    f"entry `{cls.name}."
                                    f"{'/'.join(sorted(entries))}` "
                                    f"(line {wline}) and read here "
                                    f"with no common lock — torn "
                                    f"state unless it is a single-word "
                                    f"flag the reader re-checks"
                                ),
                            ))
                            break       # one finding per reading method
    return out


def check(modules: list[Module]) -> list[Finding]:
    scan = [m for m in modules if m.rel.startswith("jepsen_tpu_torch/")]
    prog = effects.build(scan)
    contracts = _contracts(prog)
    out = _check_lock_order(prog)
    out.extend(_check_guarded_by(prog, contracts))
    out.extend(_check_thread_attrs(scan, contracts))
    return out
