"""Interprocedural effect summaries over the resolved intra-repo call
graph — the shared substrate under jepsenlint's rule families.

Per-function ``FnSummary`` records what a function *does*, in program
order: locks acquired (with the held-lock stack at each acquisition),
journal appends (``X.append(BLOCK_*, ...)``), ``.flush()`` calls,
fsyncs (``os.fsync`` / ``.sync()``), frame/socket sends
(``write_frame`` / ``.sendall``), every ``self.<attr>`` read/write with
the locks held at the site, swallowed exceptions, and the outgoing
calls themselves.  ``Program`` resolves those calls against the repo
(``self.m`` → the enclosing class's method, bare names → same module or
the imported definition, ``alias.f`` → the imported module, with a
unique-method-name fallback for dynamic dispatch), then offers two
interprocedural views:

  * ``trans_acquires`` / ``trans_kinds`` — flow-insensitive transitive
    effect sets, computed as a bounded fixpoint that is safe under
    recursion and call-graph cycles (a cycle simply reaches its own
    fixpoint; no unrolling).
  * ``trace(key)`` — a flow-*sensitive* inlined event list: callee
    events are spliced into the caller's event order at the call site
    (bounded depth, cycles cut), which is what lets durability rules
    ask "is there an fsync *between* this append and that reply?"
    across function boundaries.

The lock-identity machinery (``LockScope``) and import-alias resolution
(``import_map``) moved here from rules/concurrency.py so every family
shares one notion of what a lock is and where a name points; the
concurrency module re-exports them for its older callers.

Everything is pure ``ast`` — no imports of analyzed code — and the
whole-repo build stays well inside the analyzer's 10 s budget.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Iterable, Optional

from .core import Module, walk

Key = tuple[str, str]  # (dotted module name, "Class.method" symbol)

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}
_REENTRANT_CTORS = {"RLock", "Condition"}

#: Method names too generic for the unique-name dynamic-dispatch
#: fallback — resolving `x.append(...)` to *some* repo method named
#: `append` by uniqueness alone would be wrong far more often than
#: right.
_AMBIENT_METHODS = {
    "append", "flush", "close", "sync", "write", "read", "get", "put",
    "pop", "add", "send", "recv", "run", "start", "stop", "join",
    "acquire", "release", "update", "clear", "items", "keys", "values",
}

#: ``# guarded-by: self._lock`` — the annotation the concurrency
#: family's checked contract is declared with; parsed here because the
#: effect walk already visits every attribute assignment line.
GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][\w.]*)")


def _lockish_text(seg: str) -> bool:
    low = seg.lower()
    return ("lock" in low or "cond" in low or "sem" in low) and \
        "clock" not in low


class LockScope:
    """Lock creations and usages for one module (lock identity is
    scoped to where the lock object lives: ``module.NAME``,
    ``module.Class.attr``, ``module.func.NAME``)."""

    def __init__(self, m: Module):
        self.m = m
        # (scope-symbol or "", name) -> reentrant?
        self.created: dict[tuple[str, str], bool] = {}
        self._collect()

    def _collect(self) -> None:
        for node in walk(self.m.tree):
            if not isinstance(node, ast.Assign):
                continue
            ctor = self._ctor_of(node.value)
            if ctor is None:
                continue
            reentrant = ctor in _REENTRANT_CTORS
            fn = self.m.enclosing_function(node)
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    scope = self.m.symbol(node) if fn is not None else ""
                    self.created[(scope, tgt.id)] = reentrant
                elif (isinstance(tgt, ast.Attribute)
                      and isinstance(tgt.value, ast.Name)
                      and tgt.value.id == "self"):
                    cls = self.m.enclosing_class(node)
                    if cls is not None:
                        self.created[(cls.name, tgt.attr)] = reentrant

    def _ctor_of(self, value: ast.AST) -> Optional[str]:
        # `threading.Lock()`, `Lock()`, and the `x or threading.Lock()`
        # defaulting idiom all count as creations.
        if isinstance(value, ast.BoolOp):
            for v in value.values:
                c = self._ctor_of(v)
                if c:
                    return c
            return None
        if not isinstance(value, ast.Call):
            return None
        f = value.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        return name if name in _LOCK_CTORS else None

    def resolve(self, node: ast.AST,
                expr: ast.AST) -> Optional[tuple[str, bool]]:
        """(lock-id, reentrant) for a with-item / acquire target, or
        None when the expression isn't a lock."""
        # Unwrap `self._lock.read()` / `.write()` style wrappers.
        if isinstance(expr, ast.Call):
            expr = expr.func
            if isinstance(expr, ast.Attribute):
                expr = expr.value
        m = self.m
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"):
            cls = m.enclosing_class(node)
            cname = cls.name if cls is not None else "?"
            key = (cname, expr.attr)
            if key in self.created:
                return (f"{m.name}.{cname}.{expr.attr}",
                        self.created[key])
            if _lockish_text(expr.attr):
                return (f"{m.name}.{cname}.{expr.attr}", False)
            return None
        if isinstance(expr, ast.Name):
            # Innermost creating scope wins: function-local locks are
            # distinct per function, closures see their definer.
            fn = m.enclosing_function(node)
            while fn is not None:
                key = (m.symbol(fn), expr.id)
                if key in self.created:
                    return (f"{m.name}.{key[0]}.{expr.id}",
                            self.created[key])
                fn = m.enclosing_function(fn)
            if ("", expr.id) in self.created:
                return (f"{m.name}.{expr.id}",
                        self.created[("", expr.id)])
            if _lockish_text(expr.id):
                sym = m.symbol(node)
                scoped = sym if sym != "<module>" else ""
                return (f"{m.name}{'.' + scoped if scoped else ''}"
                        f".{expr.id}", False)
            return None
        seg = m.seg(expr)
        if _lockish_text(seg.split("(")[0].split("[")[0]):
            return (f"{m.name}.{seg.split('(')[0]}", False)
        return None


def import_map(m: Module) -> dict[str, str]:
    """alias -> dotted target ("telemetry" -> "jepsen_tpu_torch.telemetry",
    "_count" -> "jepsen_tpu_torch.telemetry.count", ...).  Cached on the
    Module instance — the tree walk is paid once even though device
    and the Program both ask."""
    cached = getattr(m, "_jl_imports", None)
    if cached is not None:
        return cached
    out: dict[str, str] = {}
    pkg_parts = m.name.split(".")
    for node in walk(m.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg_parts[: len(pkg_parts) - node.level]
            else:
                base = []
            mod = ".".join(base + ([node.module] if node.module else []))
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = (
                    f"{mod}.{a.name}" if mod else a.name
                )
    m._jl_imports = out  # type: ignore[attr-defined]
    return out


@dataclass
class Event:
    """One ordered effect inside a function body.

    kind ∈ {"acquire", "append", "flush", "fsync", "send", "call"};
    detail is the lock id (acquire), receiver/callee text (append,
    call), or the marker matched (flush/fsync/send); held is the
    with-statement lock stack at the site.
    """
    kind: str
    detail: str
    line: int
    held: tuple[str, ...] = ()


@dataclass
class AttrSite:
    """One ``self.<attr>`` access in a method body."""
    attr: str
    kind: str                    # "read" | "write"
    line: int
    held: tuple[str, ...] = ()


@dataclass
class FnSummary:
    key: Key
    module: Module
    node: ast.AST
    cls: Optional[str] = None            # enclosing class name, if any
    events: list[Event] = field(default_factory=list)
    acquires: set[str] = field(default_factory=set)   # direct lock ids
    attr_sites: list[AttrSite] = field(default_factory=list)
    swallows: list[int] = field(default_factory=list)  # bare-pass lines
    # local name -> the call text it was assigned from (`hw =
    # self._ensure_history_writer()` → "self._ensure_history_writer"),
    # the raw material for typed-local dispatch.
    local_calls: dict[str, str] = field(default_factory=dict)
    # local name -> annotated class name (`hw: HistoryWriter = ...`)
    local_anns: dict[str, str] = field(default_factory=dict)
    returns_cls: Optional[str] = None    # return-annotation class name

    @property
    def calls(self) -> list[Event]:
        return [e for e in self.events if e.kind == "call"]


_EFFECT_KINDS = ("append", "flush", "fsync", "send")

#: Annotation names that are containers/builtins, not the class we're
#: after when unwrapping `Optional["HistoryWriter"]` and friends.
_ANN_NOISE = {
    "Optional", "Union", "Any", "None", "list", "dict", "tuple", "set",
    "List", "Dict", "Tuple", "Set", "Iterable", "Iterator", "Callable",
    "str", "int", "float", "bool", "bytes", "object",
}


def _ann_name(ann: Optional[ast.AST]) -> Optional[str]:
    """The class name inside a (possibly Optional/quoted) annotation,
    or None when it's a builtin/container/absent."""
    if ann is None:
        return None
    for sub in walk(ann):
        name = None
        if isinstance(sub, ast.Name):
            name = sub.id
        elif isinstance(sub, ast.Attribute):
            name = sub.attr
        elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            name = sub.value.rsplit(".", 1)[-1].strip("'\" []")
        if name and name not in _ANN_NOISE:
            return name
    return None


def _is_block_const(expr: ast.AST) -> bool:
    name = None
    if isinstance(expr, ast.Name):
        name = expr.id
    elif isinstance(expr, ast.Attribute):
        name = expr.attr
    return bool(name) and name.startswith("BLOCK_")


class Program:
    """The whole scan set, summarized: per-function effect summaries,
    a resolved call graph, lock scopes, and the interprocedural
    fixpoints the rule families query."""

    def __init__(self, modules: Iterable[Module]):
        self.modules = list(modules)
        self.by_name: dict[str, Module] = {m.name: m for m in self.modules}
        self.scopes: dict[str, LockScope] = {}
        self.imports: dict[str, dict[str, str]] = {}
        self.fns: dict[Key, FnSummary] = {}
        # (module, class) -> {method name -> Key}
        self.classes: dict[tuple[str, str], dict[str, Key]] = {}
        # method name -> [Key] (dynamic-dispatch fallback index)
        self.by_method: dict[str, list[Key]] = {}
        self.reentrant: set[str] = set()
        # (cls-scoped) guarded-by annotations: (module, class) ->
        # {attr: lock-id}
        self.guards: dict[tuple[str, str], dict[str, str]] = {}
        for m in self.modules:
            self._index_module(m)
        self._resolved: dict[tuple[str, str, Optional[str]],
                             Optional[Key]] = {}
        self._edges: Optional[dict[Key, list[Key]]] = None
        self._rev: Optional[dict[Key, list[tuple[Key, Event]]]] = None
        self._trans_acquires: Optional[dict[Key, set[str]]] = None
        self._trans_kinds: Optional[dict[Key, set[str]]] = None
        self._traces: dict[tuple[Key, int], list[Event]] = {}

    # -- construction -----------------------------------------------------

    def _index_module(self, m: Module) -> None:
        scope = LockScope(m)
        self.scopes[m.name] = scope
        self.imports[m.name] = import_map(m)
        for node in walk(m.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                sym = m.symbol(node)
                key: Key = (m.name, sym)
                cls = m.enclosing_class(node)
                fi = FnSummary(key=key, module=m, node=node,
                               cls=cls.name if cls else None)
                fi.returns_cls = _ann_name(node.returns)
                self.fns[key] = fi
                self._walk_function(m, scope, node, fi)
                if cls is not None and sym == f"{cls.name}.{node.name}":
                    self.classes.setdefault(
                        (m.name, cls.name), {})[node.name] = key
                self.by_method.setdefault(node.name, []).append(key)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                self._maybe_guard(m, node)

    def _maybe_guard(self, m: Module, node: ast.AST) -> None:
        """`self.x = ...  # guarded-by: self._lock` declares the
        contract checked by concurrency.guarded-by."""
        cls = m.enclosing_class(node)
        if cls is None:
            return
        try:
            line = m.lines[node.lineno - 1]
        except IndexError:
            return
        gm = GUARDED_BY_RE.search(line)
        if not gm:
            return
        lock = gm.group(1)
        lock_attr = lock[5:] if lock.startswith("self.") else lock
        if lock.startswith("self."):
            lock_id = f"{m.name}.{cls.name}.{lock_attr}"
        else:
            lock_id = f"{m.name}.{lock_attr}"
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for tgt in targets:
            if (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                self.guards.setdefault(
                    (m.name, cls.name), {})[tgt.attr] = lock_id

    def _walk_function(self, m: Module, scope: LockScope,
                       fn: ast.AST, fi: FnSummary) -> None:
        """Single in-order pass tracking the held-lock stack.  Nested
        function bodies are skipped — they get their own summaries and
        run later, not under the caller's locks."""

        def attr_site(node: ast.Attribute, kind: str,
                      held: tuple[str, ...]) -> None:
            if (isinstance(node.value, ast.Name)
                    and node.value.id == "self"):
                fi.attr_sites.append(AttrSite(
                    attr=node.attr, kind=kind, line=node.lineno,
                    held=held))

        def visit(node: ast.AST, held: tuple[str, ...]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                return
            if isinstance(node, ast.With):
                acquired: list[str] = []
                for item in node.items:
                    r = scope.resolve(node, item.context_expr)
                    if r is not None:
                        lock, re_ok = r
                        if re_ok:
                            self.reentrant.add(lock)
                        fi.acquires.add(lock)
                        fi.events.append(Event(
                            "acquire", lock, node.lineno, held))
                        acquired.append(lock)
                    # Effects inside the context expression itself
                    # (e.g. open(...) calls) still happen.
                    visit(item.context_expr, held)
                inner = held + tuple(acquired)
                for child in node.body:
                    visit(child, inner)
                return
            if isinstance(node, ast.ExceptHandler):
                body = [s for s in node.body
                        if not isinstance(s, ast.Expr)
                        or not isinstance(s.value, ast.Constant)]
                if all(isinstance(s, (ast.Pass, ast.Continue))
                       for s in body):
                    fi.swallows.append(node.lineno)
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    for sub in walk(t):
                        if isinstance(sub, ast.Attribute) and isinstance(
                                sub.ctx, ast.Store):
                            attr_site(sub, "write", held)
                if (len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and isinstance(node.value, ast.Call)):
                    fi.local_calls[node.targets[0].id] = m.seg(
                        node.value.func)
            elif isinstance(node, ast.AnnAssign):
                if isinstance(node.target, ast.Name):
                    ann = _ann_name(node.annotation)
                    if ann:
                        fi.local_anns[node.target.id] = ann
                elif isinstance(node.target, ast.Attribute):
                    attr_site(node.target, "write", held)
            elif isinstance(node, ast.AugAssign):
                if isinstance(node.target, ast.Attribute):
                    attr_site(node.target, "write", held)
                    # aug-assign reads the old value too
                    attr_site(node.target, "read", held)
            elif isinstance(node, ast.Attribute) and isinstance(
                    node.ctx, ast.Load):
                attr_site(node, "read", held)
            elif isinstance(node, ast.Attribute) and isinstance(
                    node.ctx, ast.Del):
                attr_site(node, "write", held)
            if isinstance(node, ast.Call):
                self._classify_call(m, scope, node, fi, held)
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        body = getattr(fn, "body", [])
        for stmt in body:
            visit(stmt, ())

    def _classify_call(self, m: Module, scope: LockScope,
                       node: ast.Call, fi: FnSummary,
                       held: tuple[str, ...]) -> None:
        func = node.func
        line = node.lineno
        if isinstance(func, ast.Attribute):
            attr = func.attr
            if attr == "acquire":
                r = scope.resolve(node, func.value)
                if r is not None:
                    lock, re_ok = r
                    if re_ok:
                        self.reentrant.add(lock)
                    fi.acquires.add(lock)
                    fi.events.append(Event("acquire", lock, line, held))
                return
            if attr == "append" and node.args and _is_block_const(
                    node.args[0]):
                fi.events.append(Event(
                    "append", m.seg(func.value), line, held))
                return
            if attr == "flush" and not node.args:
                fi.events.append(Event(
                    "flush", m.seg(func.value), line, held))
                return
            if attr == "sync" and not node.args:
                fi.events.append(Event(
                    "fsync", m.seg(func.value), line, held))
                return
            if attr == "fsync":
                fi.events.append(Event("fsync", "os.fsync", line, held))
                return
            if attr == "sendall":
                fi.events.append(Event(
                    "send", m.seg(func.value), line, held))
                return
        name = func.id if isinstance(func, ast.Name) else None
        if name == "write_frame" or (
                isinstance(func, ast.Attribute)
                and func.attr == "write_frame"):
            fi.events.append(Event("send", "write_frame", line, held))
            return
        fi.events.append(Event("call", m.seg(func), line, held))

    # -- call resolution --------------------------------------------------

    def resolve(self, text: str, module: Module,
                cls: Optional[str] = None,
                caller: Optional[FnSummary] = None) -> Optional[Key]:
        """Best-effort callee resolution: ``self.m`` → the enclosing
        class's method (exact, not suffix-matched), bare name → same
        module or the imported definition, ``alias.f`` → the imported
        module's f.  A method call on a local receiver is resolved
        through the local's *type* when it is knowable — assigned from
        a constructor, an annotated local, or the return annotation of
        a resolved call (``hw = self._ensure_history_writer()`` →
        ``hw.checkpoint`` → ``HistoryWriter.checkpoint``).  Failing
        that, the unique repo-wide definition of the method name
        (dynamic dispatch fallback) when the name isn't ambient."""
        ck = (text, module.name, cls,
              caller.key if caller is not None else None)
        if ck in self._resolved:
            return self._resolved[ck]
        out = self._resolve_uncached(text, module, cls, caller)
        self._resolved[ck] = out
        return out

    def _resolve_uncached(self, text: str, module: Module,
                          cls: Optional[str],
                          caller: Optional[FnSummary]) -> Optional[Key]:
        text = text.strip()
        head = text.split("(")[0]
        imports = self.imports.get(module.name, {})
        if head.startswith("self."):
            parts0 = head[5:].split(".")
            meth = parts0[0]
            if len(parts0) > 1:
                # self.attr.meth(...): a call *through* an attribute —
                # the invoked method is the last segment, and the
                # attribute's type isn't tracked, so only the unique-
                # name fallback applies.  Resolving on the first
                # segment here would alias every `self._writer.close()`
                # in the repo onto some class's `_writer()` method.
                return self._dispatch_fallback(parts0[-1])
            if cls is not None:
                key = self.classes.get((module.name, cls), {}).get(meth)
                if key is not None:
                    return key
            # Older suffix-match behavior as a fallback when the
            # enclosing class isn't known.
            for (mod, sym), fi in self.fns.items():
                if mod == module.name and sym.endswith(f".{meth}"):
                    return (mod, sym)
            return self._dispatch_fallback(meth)
        if "." not in head:
            target = imports.get(head, head)
            if "." in target:           # from x import f
                mod, _, f = target.rpartition(".")
                hit = self.fns.get((mod, f))
                if hit is not None:
                    return hit.key
                return None
            fi = self.fns.get((module.name, head))
            return fi.key if fi is not None else None
        alias, _, rest = head.partition(".")
        base = imports.get(alias)
        if base is None:
            # Typed-local dispatch: the receiver is a local whose class
            # we can infer from how it was produced.
            meth = rest.split(".")[0]
            if caller is not None:
                cls_key = self._local_type(caller, alias)
                if cls_key is not None:
                    hit3 = self.classes.get(cls_key, {}).get(meth)
                    if hit3 is not None:
                        return hit3
            return self._dispatch_fallback(head.rsplit(".", 1)[-1])
        parts = rest.split(".")
        # alias may be a module (alias.f) or a package (alias.sub.f),
        # or a class imported from a module (alias.method on an
        # instance is not resolvable here).
        for split in range(len(parts), 0, -1):
            mod = ".".join([base] + parts[: split - 1])
            f = parts[split - 1]
            hit = self.fns.get((mod, f))
            if hit is not None:
                return hit.key
            # from pkg import cls; cls.method / Cls(...).method
            hit2 = self.fns.get((mod.rpartition(".")[0],
                                 f"{mod.rpartition('.')[2]}.{f}"))
            if hit2 is not None:
                return hit2.key
        return self._dispatch_fallback(parts[-1])

    def _dispatch_fallback(self, meth: str) -> Optional[Key]:
        if meth in _AMBIENT_METHODS:
            return None
        keys = self.by_method.get(meth) or []
        return keys[0] if len(keys) == 1 else None

    def _resolve_class(self, name: str,
                       module: Module) -> Optional[tuple[str, str]]:
        """(module, class) for a bare class name: same module first,
        then through the import map, then unique repo-wide."""
        if (module.name, name) in self.classes:
            return (module.name, name)
        target = self.imports.get(module.name, {}).get(name)
        if target and "." in target:
            mod, _, cname = target.rpartition(".")
            if (mod, cname) in self.classes:
                return (mod, cname)
        hits = [ck for ck in self.classes if ck[1] == name]
        return hits[0] if len(hits) == 1 else None

    def _local_type(self, caller: FnSummary,
                    local: str) -> Optional[tuple[str, str]]:
        """The class of a local variable, when knowable: an annotated
        local, a constructor assignment, or the return annotation of a
        resolved call."""
        ann = caller.local_anns.get(local)
        if ann is not None:
            return self._resolve_class(ann, caller.module)
        src = caller.local_calls.get(local)
        if src is None:
            return None
        head = src.strip().split("(")[0]
        ctor = head.rsplit(".", 1)[-1]
        if ctor and ctor[0].isupper():
            ck = self._resolve_class(ctor, caller.module)
            if ck is not None:
                return ck
        # Not a constructor: resolve the producing call (WITHOUT local
        # context — one level of indirection is where this stops) and
        # use its return annotation.
        prod = self.resolve(src, caller.module, caller.cls)
        if prod is None:
            return None
        pfi = self.fns.get(prod)
        if pfi is None or pfi.returns_cls is None:
            return None
        return self._resolve_class(pfi.returns_cls, pfi.module)

    # -- interprocedural views --------------------------------------------

    def edges(self) -> dict[Key, list[Key]]:
        """Resolved call graph: caller key -> callee keys."""
        if self._edges is None:
            self._edges = {}
            for key, fi in self.fns.items():
                outs = []
                for ev in fi.calls:
                    callee = self.resolve(ev.detail, fi.module,
                                          fi.cls, fi)
                    if callee is not None:
                        outs.append(callee)
                self._edges[key] = outs
        return self._edges

    def callers(self) -> dict[Key, list[tuple[Key, Event]]]:
        """Reverse call graph: callee key -> [(caller key, call
        event)] — the event carries line and held locks at the site."""
        if self._rev is None:
            self._rev = {}
            for key, fi in self.fns.items():
                for ev in fi.calls:
                    callee = self.resolve(ev.detail, fi.module,
                                          fi.cls, fi)
                    if callee is not None:
                        self._rev.setdefault(callee, []).append(
                            (key, ev))
        return self._rev

    def _fixpoint(self) -> None:
        acq = {k: set(fi.acquires) for k, fi in self.fns.items()}
        kinds = {
            k: {e.kind for e in fi.events if e.kind in _EFFECT_KINDS}
            for k, fi in self.fns.items()
        }
        edges = self.edges()
        # Bounded fixpoint: sets only grow, so this terminates; the
        # bound just caps pathological graphs.  Recursive and mutually
        # recursive functions are handled by the fixpoint itself.
        for _ in range(12):
            changed = False
            for key in self.fns:
                for callee in edges.get(key, ()):
                    a = acq[callee] - acq[key]
                    if a:
                        acq[key].update(a)
                        changed = True
                    kd = kinds[callee] - kinds[key]
                    if kd:
                        kinds[key].update(kd)
                        changed = True
            if not changed:
                break
        self._trans_acquires = acq
        self._trans_kinds = kinds

    def trans_acquires(self, key: Key) -> set[str]:
        """Every lock id acquired by `key` or anything it (transitively)
        calls."""
        if self._trans_acquires is None:
            self._fixpoint()
        return self._trans_acquires.get(key, set())  # type: ignore

    def trans_kinds(self, key: Key) -> set[str]:
        """Transitive effect kinds ({"append","flush","fsync","send"})
        reachable from `key`."""
        if self._trans_kinds is None:
            self._fixpoint()
        return self._trans_kinds.get(key, set())  # type: ignore

    def trace(self, key: Key, depth: int = 3) -> list[Event]:
        """Flow-sensitive inlined event list for `key`: each resolved
        call event is replaced by the callee's trace (down to `depth`
        levels; cycles and over-deep chains keep the bare call event
        with the callee's unordered transitive kinds appended, so an
        fsync buried deep still registers — just without ordering)."""
        memo_key = (key, depth)
        if memo_key in self._traces:
            return self._traces[memo_key]
        out = self._trace(key, depth, frozenset())
        self._traces[memo_key] = out
        return out

    def _trace(self, key: Key, depth: int,
               active: frozenset) -> list[Event]:
        fi = self.fns.get(key)
        if fi is None:
            return []
        out: list[Event] = []
        for ev in fi.events:
            if ev.kind != "call":
                out.append(ev)
                continue
            callee = self.resolve(ev.detail, fi.module, fi.cls, fi)
            if callee is None or callee == key:
                out.append(ev)
                continue
            if depth <= 0 or callee in active:
                # Cut — keep ordering-free knowledge of what's below.
                out.append(ev)
                for kind in sorted(self.trans_kinds(callee)):
                    out.append(Event(kind, f"<via {ev.detail}>",
                                     ev.line, ev.held))
                continue
            out.append(ev)
            out.extend(self._trace(callee, depth - 1,
                                   active | {key}))
        return out


#: One-slot build cache: concurrency and durability run over the same
#: module batch in one analyze pass — summarize it once.
_cache: Optional[tuple[tuple[int, ...], Program]] = None


def build(modules: Iterable[Module]) -> Program:
    """The one-call entry: summarize a scan set (cached for the batch
    so multiple rule families share one Program)."""
    global _cache
    mods = list(modules)
    key = tuple(id(m) for m in mods)
    if _cache is not None and _cache[0] == key:
        return _cache[1]
    prog = Program(mods)
    _cache = (key, prog)
    return prog
