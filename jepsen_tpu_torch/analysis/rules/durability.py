"""Crash-durability protocol, machine-checked at every journal site.

The repo's persistence story is one discipline implemented many times:
**append → flush → fsync → only then reply**, torn tails truncated on
reopen, checkpoints replaced atomically.  Crash tests prove individual
implementations point-by-point; this family verifies
the protocol *statically* at every site, over the interprocedural
effect summaries (analysis/effects.py) so the append and its fsync may
live in different functions — or different modules — and still be
matched up.

``durability.fsync-missing`` (error) — a ``X.append(BLOCK_*, ...)``
journal append after which no fsync (``.sync()`` / ``os.fsync``)
happens in the appender, and no caller chain supplies one after the
call site either; plus ``.jsonl`` append-mode writes whose ``with``
body lacks flush+fsync.  The analysis is path-insensitive (events in
textual order) and absolves an appender when *every* resolved caller
fsyncs after the call — the ledger/journal idiom of a bare append
helper sealed by its caller stays clean without annotations.

``durability.reply-before-fsync`` (error) — a frame or socket send
(``write_frame`` / ``.sendall``) reachable while a journal append's
fsync has not yet happened: the ack can outlive the data.  Checked per
function over the effect walk with callee effects folded in, so
"append here, reply in the helper" is still caught.

``durability.torn-tail-unhandled`` (warning) — a call to the
low-level ``_read_block`` frame reader outside store/format.py whose
result is never None-checked in the enclosing function: ``None`` *is*
the torn tail, and ignoring it turns a crash-truncated file into a
crash of the reader.

``durability.non-atomic-checkpoint`` (warning) — persistent JSON
state (a ``.json`` file the repo also *reads back* somewhere) written
via bare ``open(path, "w")`` + ``json.dump`` with no ``os.replace`` in
the writing function: a crash mid-write leaves a half-written
checkpoint where a consumer expects valid JSON.  Write-only artifacts
(reports, rendered dossiers) are out of scope by construction — no
read site, no finding.

``durability.block-type-collision`` (error) — two ``BLOCK_*`` wire ids
with the same value, or a checkerd ``F_*`` frame type colliding with a
store block type: the whole point of the shared id space is that a
frame can never be mistaken for an on-disk block.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from ..core import Finding, Module, walk
from .. import effects
from ..effects import Event, Key, Program

RULES = {
    "durability.fsync-missing": (
        "error",
        "journal append with no fsync afterwards in the function or "
        "any caller path",
    ),
    "durability.reply-before-fsync": (
        "error",
        "frame/socket send reachable while a journal append is not "
        "yet fsynced",
    ),
    "durability.torn-tail-unhandled": (
        "warning",
        "_read_block caller that never None-checks the result (None "
        "is the torn tail)",
    ),
    "durability.non-atomic-checkpoint": (
        "warning",
        "read-back JSON state written via bare open('w') instead of "
        "tmp + os.replace",
    ),
    "durability.block-type-collision": (
        "error",
        "duplicate BLOCK_*/F_* wire id — a frame could be mistaken "
        "for an on-disk block",
    ),
}

_HINT_RE = re.compile(r"[\w][\w.-]*\.json$")


# ---------------------------------------------------------------------------
# append → fsync ordering (fsync-missing, reply-before-fsync)
# ---------------------------------------------------------------------------


class _NetWalk:
    """Per-function 'does it leave an unfsynced journal append, and
    does a send happen while one is pending' — callee effects folded in
    via the program's transitive kinds and the callee's own net state
    (memoized, cycle-cut)."""

    def __init__(self, prog: Program):
        self.prog = prog
        # key -> (leaves_unsynced, origin_line) — origin is the append
        # (or call) line the pending obligation came from.
        self._net: dict[Key, tuple[bool, int]] = {}
        self._active: set[Key] = set()
        # key -> [(send-line, append-origin-line)]
        self.sends_while_pending: dict[Key, list[tuple[int, int]]] = {}

    def net(self, key: Key) -> tuple[bool, int]:
        if key in self._net:
            return self._net[key]
        if key in self._active:
            return (False, 0)           # recursion: cut, no obligation
        self._active.add(key)
        out = self._walk(key)
        self._active.discard(key)
        self._net[key] = out
        return out

    def _walk(self, key: Key) -> tuple[bool, int]:
        fi = self.prog.fns.get(key)
        if fi is None:
            return (False, 0)
        pending = False
        origin = 0
        bad_sends: list[tuple[int, int]] = []
        for ev in fi.events:
            if ev.kind == "append":
                pending, origin = True, ev.line
            elif ev.kind == "fsync":
                pending = False
            elif ev.kind == "send":
                if pending:
                    bad_sends.append((ev.line, origin))
            elif ev.kind == "call":
                callee = self.prog.resolve(ev.detail, fi.module, fi.cls, fi)
                if callee is None or callee == key:
                    continue
                kinds = self.prog.trans_kinds(callee)
                if "send" in kinds and pending:
                    bad_sends.append((ev.line, origin))
                if "fsync" in kinds:
                    pending = False
                sub_pending, _sub_origin = self.net(callee)
                if sub_pending:
                    pending, origin = True, ev.line
        if bad_sends:
            self.sends_while_pending[key] = bad_sends
        return (pending, origin)


def _absolved(prog: Program, walk: _NetWalk, key: Key,
              seen: frozenset) -> bool:
    """True when every resolved caller fsyncs after its call to `key`
    (directly or via its own callers) — the append helper whose caller
    owns the sync."""
    callers = prog.callers().get(key)
    if not callers:
        return False
    for ckey, ev in callers:
        if ckey in seen:
            continue                    # call cycle: don't block on it
        if not _fsync_after(prog, walk, ckey, ev,
                            seen | {key}):
            return False
    return True


def _fsync_after(prog: Program, walk: _NetWalk, caller: Key,
                 call_ev: Event, seen: frozenset) -> bool:
    fi = prog.fns.get(caller)
    if fi is None:
        return False
    idx = fi.events.index(call_ev)
    for ev in fi.events[idx + 1:]:
        if ev.kind == "fsync":
            return True
        if ev.kind == "call":
            callee = prog.resolve(ev.detail, fi.module, fi.cls, fi)
            if callee is not None and \
                    "fsync" in prog.trans_kinds(callee):
                return True
    return _absolved(prog, walk, caller, seen)


def _check_append_protocol(prog: Program) -> list[Finding]:
    out: list[Finding] = []
    walk = _NetWalk(prog)
    for key, fi in sorted(prog.fns.items()):
        if not fi.module.rel.startswith("jepsen_tpu_torch/"):
            continue
        direct_appends = [e for e in fi.events if e.kind == "append"]
        pending, origin = walk.net(key)
        if direct_appends and pending and origin in {
                e.line for e in direct_appends}:
            if not _absolved(prog, walk, key, frozenset({key})):
                out.append(Finding(
                    rule="durability.fsync-missing", severity="error",
                    path=fi.module.rel, line=origin,
                    symbol=key[1],
                    message=(
                        "journal append is never fsynced: neither "
                        f"`{key[1]}` nor any caller calls .sync()/"
                        "os.fsync after the append — a crash loses "
                        "acknowledged records (protocol: append → "
                        "flush → fsync → reply)"
                    ),
                ))
    for key, sends in sorted(walk.sends_while_pending.items()):
        fi = prog.fns[key]
        if not fi.module.rel.startswith("jepsen_tpu_torch/"):
            continue
        for line, origin in sends:
            out.append(Finding(
                rule="durability.reply-before-fsync", severity="error",
                path=fi.module.rel, line=line, symbol=key[1],
                message=(
                    f"reply/send reachable before the journal append "
                    f"at line {origin} is fsynced — the ack can "
                    "outlive the data; fsync before sending"
                ),
            ))
    return out


# ---------------------------------------------------------------------------
# .jsonl append-mode durability
# ---------------------------------------------------------------------------


def _const_strs(m: Module, expr: ast.AST) -> list[str]:
    """Every string constant inside `expr`, with module-level constant
    Names resolved one hop."""
    consts = _module_consts(m)
    out: list[str] = []
    for sub in walk(expr):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            out.append(sub.value)
        elif isinstance(sub, ast.Name) and sub.id in consts:
            out.append(consts[sub.id])
    return out


_CONSTS_CACHE: dict[int, dict[str, str]] = {}


def _module_consts(m: Module) -> dict[str, str]:
    key = id(m)
    if key in _CONSTS_CACHE:
        return _CONSTS_CACHE[key]
    out: dict[str, str] = {}
    for node in m.tree.body:
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out[tgt.id] = node.value.value
    _CONSTS_CACHE[key] = out
    return out


def _open_mode(call: ast.Call) -> str:
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
            and isinstance(call.args[1].value, str):
        return call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    return "r"


def _is_open(call: ast.Call) -> bool:
    return isinstance(call.func, ast.Name) and call.func.id == "open" \
        and bool(call.args)


def _check_jsonl_appends(modules: list[Module]) -> list[Finding]:
    out = []
    for m in modules:
        if not m.rel.startswith("jepsen_tpu_torch/"):
            continue
        for node in walk(m.tree):
            if not isinstance(node, ast.With):
                continue
            for item in node.items:
                call = item.context_expr
                if not isinstance(call, ast.Call) or not _is_open(call):
                    continue
                if "a" not in _open_mode(call):
                    continue
                hints = _const_strs(m, call.args[0])
                if not any(h.endswith(".jsonl") for h in hints):
                    continue
                has_flush = has_fsync = False
                for sub in walk(node):
                    if isinstance(sub, ast.Call) and isinstance(
                            sub.func, ast.Attribute):
                        if sub.func.attr == "flush":
                            has_flush = True
                        elif sub.func.attr in ("fsync", "sync"):
                            has_fsync = True
                if not (has_flush and has_fsync):
                    missing = []
                    if not has_flush:
                        missing.append("flush")
                    if not has_fsync:
                        missing.append("fsync")
                    out.append(m.finding(
                        "durability.fsync-missing", "error", node,
                        ".jsonl journal appended without "
                        + "+".join(missing)
                        + " inside the with block — a crash loses "
                        "acknowledged records",
                    ))
    return out


# ---------------------------------------------------------------------------
# torn-tail-unhandled
# ---------------------------------------------------------------------------


def _check_torn_tail(modules: list[Module]) -> list[Finding]:
    out = []
    for m in modules:
        if not m.rel.startswith("jepsen_tpu_torch/") or \
                m.rel.endswith("store/format.py"):
            continue
        for node in walk(m.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = None
            if isinstance(node.func, ast.Name):
                fname = node.func.id
            elif isinstance(node.func, ast.Attribute):
                fname = node.func.attr
            if fname != "_read_block":
                continue
            target = _assign_target(m, node)
            if target is not None and _none_checked(m, node, target):
                continue
            out.append(m.finding(
                "durability.torn-tail-unhandled", "warning", node,
                "_read_block result is never checked against None — "
                "None IS the torn tail; `if rec is None: break` (or "
                "route through the truncating BlockWriter reopen)",
            ))
    return out


def _assign_target(m: Module, call: ast.Call) -> Optional[str]:
    p = m.parent(call)
    if isinstance(p, ast.Assign) and len(p.targets) == 1 and \
            isinstance(p.targets[0], ast.Name):
        return p.targets[0].id
    if isinstance(p, ast.NamedExpr) and isinstance(p.target, ast.Name):
        return p.target.id
    return None


def _none_checked(m: Module, call: ast.Call, name: str) -> bool:
    fn = m.enclosing_function(call)
    scope: ast.AST = fn if fn is not None else m.tree
    for node in walk(scope):
        if isinstance(node, ast.Compare):
            parts = [node.left] + list(node.comparators)
            names = {p.id for p in parts if isinstance(p, ast.Name)}
            nones = any(isinstance(p, ast.Constant) and p.value is None
                        for p in parts)
            if name in names and nones:
                return True
        elif isinstance(node, (ast.If, ast.While)):
            t = node.test
            if isinstance(t, ast.UnaryOp) and isinstance(
                    t.op, ast.Not):
                t = t.operand
            if isinstance(t, ast.Name) and t.id == name:
                return True
    return False


# ---------------------------------------------------------------------------
# non-atomic-checkpoint
# ---------------------------------------------------------------------------


def _check_checkpoints(modules: list[Module]) -> list[Finding]:
    # Pass 1: every .json filename the repo reads back (open for read
    # + json.load in the same function, or any json.load-bearing
    # module-level reader).  Tools count as readers too — a consumer
    # is a consumer.
    read_hints: set[str] = set()
    for m in modules:
        for node in walk(m.tree):
            if not (isinstance(node, ast.Call) and _is_open(node)):
                continue
            mode = _open_mode(node)
            if any(c in mode for c in "wax"):
                continue
            fn = m.enclosing_function(node)
            scope: ast.AST = fn if fn is not None else m.tree
            loads = any(
                isinstance(s, ast.Call)
                and isinstance(s.func, ast.Attribute)
                and s.func.attr in ("load", "loads")
                and isinstance(s.func.value, ast.Name)
                and s.func.value.id == "json"
                for s in walk(scope)
            )
            if not loads:
                continue
            for h in _const_strs(m, node.args[0]):
                if _HINT_RE.search(h):
                    read_hints.add(h)

    # Pass 2: bare open('w') + json.dump writers of those files.
    out = []
    for m in modules:
        if not m.rel.startswith("jepsen_tpu_torch/"):
            continue
        for node in walk(m.tree):
            if not isinstance(node, ast.With):
                continue
            for item in node.items:
                call = item.context_expr
                if not isinstance(call, ast.Call) or not _is_open(call):
                    continue
                if "w" not in _open_mode(call):
                    continue
                dumps = any(
                    isinstance(s, ast.Call)
                    and isinstance(s.func, ast.Attribute)
                    and s.func.attr == "dump"
                    and isinstance(s.func.value, ast.Name)
                    and s.func.value.id == "json"
                    for s in walk(node)
                )
                if not dumps:
                    continue
                hints = [h for h in _const_strs(m, call.args[0])
                         if _HINT_RE.search(h)]
                hit = next((h for h in hints if h in read_hints), None)
                if hit is None:
                    continue
                if any(".tmp" in h for h in _const_strs(m, call.args[0])):
                    continue
                fn = m.enclosing_function(node)
                scope: ast.AST = fn if fn is not None else m.tree
                atomic = any(
                    isinstance(s, ast.Call)
                    and isinstance(s.func, ast.Attribute)
                    and s.func.attr == "replace"
                    and isinstance(s.func.value, ast.Name)
                    and s.func.value.id == "os"
                    for s in walk(scope)
                )
                if atomic:
                    continue
                out.append(m.finding(
                    "durability.non-atomic-checkpoint", "warning", node,
                    f"`{hit}` is read back elsewhere but written via "
                    "bare open('w') — a crash mid-write leaves a "
                    "half-checkpoint; write to a .tmp sibling, fsync, "
                    "then os.replace",
                ))
    return out


# ---------------------------------------------------------------------------
# block-type-collision
# ---------------------------------------------------------------------------

_BLOCK_NAME = re.compile(r"^BLOCK_[A-Z0-9_]+$")
_FRAME_NAME = re.compile(r"^F_[A-Z0-9_]+$")


def _check_block_ids(modules: list[Module]) -> list[Finding]:
    # value -> [(module, const name, line)] over the shared wire-id
    # space: every BLOCK_* definition, plus F_* frame types in the
    # checkerd protocol module.
    defs: dict[int, list[tuple[Module, str, int]]] = {}
    for m in modules:
        if not m.rel.startswith("jepsen_tpu_torch/"):
            continue
        frames_too = m.rel.endswith("checkerd/protocol.py")
        for node in m.tree.body:
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, int)
                    and not isinstance(node.value.value, bool)):
                continue
            for tgt in node.targets:
                if not isinstance(tgt, ast.Name):
                    continue
                if _BLOCK_NAME.match(tgt.id) or (
                        frames_too and _FRAME_NAME.match(tgt.id)):
                    defs.setdefault(node.value.value, []).append(
                        (m, tgt.id, node.lineno))
    out = []
    for value, sites in sorted(defs.items()):
        if len(sites) < 2:
            continue
        names = ", ".join(
            f"{mm.rel}:{ln} {name}" for mm, name, ln in sites)
        mm, name, ln = sites[-1]
        out.append(Finding(
            rule="durability.block-type-collision", severity="error",
            path=mm.rel, line=ln, symbol="<module>",
            message=(
                f"wire id {value} defined more than once ({names}) — "
                "block and frame types share one id space so a frame "
                "can never be mistaken for an on-disk block"
            ),
        ))
    return out


# ---------------------------------------------------------------------------


def check(modules: list[Module]) -> list[Finding]:
    _CONSTS_CACHE.clear()
    scan = [m for m in modules if m.rel.startswith("jepsen_tpu_torch/")]
    prog = effects.build(scan)
    out = _check_append_protocol(prog)
    out.extend(_check_jsonl_appends(scan))
    out.extend(_check_torn_tail(scan))
    out.extend(_check_checkpoints(modules))
    out.extend(_check_block_ids(scan))
    return out
