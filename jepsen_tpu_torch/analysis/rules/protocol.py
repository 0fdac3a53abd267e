"""Framework-protocol contracts: ledger, telemetry, checker budgets.

These rules encode conventions the framework established but never
enforced:

``protocol.intent-before-mutation`` (error) — nemesis ``invoke`` /
``inject*`` / ``teardown`` / ``heal*`` methods must journal ledger
intent *before* touching the session (``on_nodes`` / ``exec_star`` /
``drop_all`` / ...), and heal paths must consult ``heal_guard()``
before ``.heal(...)``.  Ordering is checked lexically within the
method: the whole point of the ledger is that a crash between
journal and injection replays the compensator, and a mutation above
the journal line reopens the stranded-fault window the ledger closed.

``protocol.unknown-compensator`` (error) — every ``compensator=
{"type": ...}`` literal must name a ctype that ``ledger.
run_compensator`` actually dispatches on.  The registry is parsed
out of ``nemesis/ledger.py``'s AST (the ``ctype == "..."`` chain), so
adding a fault with a typo'd or not-yet-implemented compensator fails
lint instead of raising ``unknown compensator type`` at repair time —
the single worst moment to discover it.

``protocol.counter-namespace`` (warning) — literal counter / gauge /
span names must live in a declared namespace (below).  f-strings are
resolved to their leading literal prefix.  The namespace table is what
``doc/counters_torch.md`` is generated from (``jepsen lint
--write-counters``), and ``tests/test_torch_analysis.py`` fails when
the committed table drifts from the code.

``protocol.fleet-counter-prefix`` (error) — counters emitted from the
fleet-scoped modules (``checkerd/``, ``streaming/``,
``nemesis/search.py``) must start with one of
``telemetry.FLEET_COUNTER_PREFIXES`` (parsed from
``telemetry/__init__.py``'s AST, not imported).  A counter outside the
prefixes is silently zeroed by ``scoped_reset`` at the next run scope
— exactly the drift this cross-check exists to catch.

``protocol.check-safe-bypass`` (error) — nothing outside
``checker/core.py`` calls ``<checker>.check(test, history, opts)``
directly; everything routes through ``check_safe`` so the wall-clock
budget and valid/unknown demotion apply.

``protocol.swallowed-teardown`` (warning) — ``except: pass`` bodies in
teardown/close/shutdown-shaped functions.  Teardown must not raise,
but it must not eat evidence either: the accepted ones are baselined
with their justification (usually "node already dead, OSError
expected"), new ones need a ``log.debug`` or their own justification.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from ..core import Finding, Module, walk

RULES = {
    "protocol.intent-before-mutation": (
        "error",
        "nemesis mutates the session before journaling ledger intent "
        "(or heals without heal_guard)",
    ),
    "protocol.unknown-compensator": (
        "error",
        "compensator type literal not dispatched by "
        "ledger.run_compensator",
    ),
    "protocol.counter-namespace": (
        "warning",
        "telemetry counter/gauge/span name outside the declared "
        "namespaces",
    ),
    "protocol.fleet-counter-prefix": (
        "error",
        "fleet-module counter outside FLEET_COUNTER_PREFIXES — "
        "scoped_reset will zero it",
    ),
    "protocol.check-safe-bypass": (
        "error",
        "direct checker .check() call bypasses check_safe budgets",
    ),
    "protocol.swallowed-teardown": (
        "warning",
        "except-with-only-pass in a teardown path swallows evidence",
    ),
}

#: Counter/gauge/span namespaces with an owner.  Extending this tuple
#: is the declared way to introduce a namespace — doc/counters_torch.md
#: is generated from it plus the live scan.  The port's table is the
#: reference's less the namespaces the port never emits ("bench",
#: "lint", "wgl.roofline") plus "elle", the spans of its Elle screen.
DECLARED_NAMESPACES = {
    "wgl": "device checker passes (ops/, streaming/, parallel/)",
    "wgl.packed": "bit-packed uint32-lane kernel variants: block "
                  "counts, lane-word gauges, shed-packing fallbacks "
                  "(ops/packing.py, ops/wgl*.py)",
    "wgl.plan": "checking-plan compiler/executor/cache (plan/)",
    "ingest": "history ingest path: builder append/snapshot, remote "
              "framing, daemon decode (history/, streaming/, "
              "checkerd/)",
    "checker": "checker harness (checker/)",
    "elle": "Elle cycle screen and extraction on the card (ops/scc.py)",
    "checkerd": "checker daemon fleet (checkerd/)",
    "checkerd.queue": "crash-safe queue journal (checkerd/journal.py)",
    "checkerd.overload": "overload control plane: fair queue, deadline "
                         "shed, brownout ladder (checkerd/overload.py)",
    "router": "checkerd federation router (checkerd/router.py)",
    "chaos": "fleet self-chaos harness (nemesis/selfchaos.py)",
    "nemesis": "fault injection + ledger + schedule search (nemesis/)",
    "lifecycle": "core.run phases (core.py)",
    "interpreter": "op interpreter + workers (interpreter.py)",
    "client": "workload clients (workloads/, interpreter.py)",
    "node": "node health probes (control/health.py)",
    "net": "net fault plumbing (control/remotes.py)",
    "daemon": "remote daemon supervision (control/util.py)",
    "profile": "per-pass cost profiling (telemetry/profile.py)",
    "forensics": "anomaly dossiers (forensics.py)",
    "slo": "SLO alert engine (telemetry/slo.py)",
    "monitor": "standing continuous verification (monitor/)",
    "monitor.live": "live-target mode: suite-backed client pool, "
                    "in-run fault windows, daemon supervision "
                    "(monitor/live.py)",
    "monitor.shed": "tee shed handling: deadline-aware backoff and "
                    "retry on F_SHED instead of in-process fallback "
                    "(monitor/loop.py)",
    "fleet": "multi-tenant fleet supervisor: tenant lifecycle, "
             "crash-loop parking, drains (monitor/fleet.py)",
    "fleet.retention": "per-tenant disk-budgeted dossier/series GC "
                       "(monitor/retention.py)",
    "alert": "alert router sink deliveries (monitor/alerts.py)",
}

#: Fleet-scoped modules: counters here survive scoped_reset only when
#: under a FLEET_COUNTER_PREFIXES prefix.
_FLEET_PATHS = ("jepsen_tpu_torch/checkerd/", "jepsen_tpu_torch/streaming/")
_FLEET_FILES = ("jepsen_tpu_torch/nemesis/search.py",
                "jepsen_tpu_torch/nemesis/selfchaos.py")

_TELEMETRY_INIT = "jepsen_tpu_torch/telemetry/__init__.py"
_LEDGER = "jepsen_tpu_torch/nemesis/ledger.py"
_CHECKER_CORE = "jepsen_tpu_torch/checker/core.py"

# --------------------------------------------------------------------------
# intent-before-mutation
# --------------------------------------------------------------------------

#: Session-mutating call shapes (source-segment match, lexical).
_MUT_RE = re.compile(
    r"\.(drop_all|drop|slow|flaky|exec_star|exec|su|kill_daemon|"
    r"start_daemon|signal_daemon)\s*\(|\bon_nodes\s*\("
)
_HEAL_RE = re.compile(r"\.heal\s*\(")
_INTENT_RE = re.compile(
    r"\b(fault_ledger|ledger)\s*\.\s*(intent|note)\s*\(|\bled\.intent\s*\("
)
_GUARD_RE = re.compile(r"\bheal_guard\s*\(")
_INJECTISH = re.compile(r"^(invoke|inject\w*|teardown|heal\w*)$")


def _check_intent_order(modules: list[Module]) -> list[Finding]:
    out = []
    for m in modules:
        if not m.rel.startswith("jepsen_tpu_torch/nemesis/"):
            continue
        if m.rel == _LEDGER:
            continue        # the ledger is the mechanism, not a client
        for fn in [n for n in walk(m.tree)
                   if isinstance(n, ast.FunctionDef)
                   and _INJECTISH.match(n.name)
                   and m.enclosing_class(n) is not None]:
            first_mut: Optional[ast.Call] = None
            first_intent_line: Optional[int] = None
            first_guard_line: Optional[int] = None
            first_heal: Optional[ast.Call] = None
            # Nested defs (the on_nodes closure idiom) execute at
            # their call site, not where they are written — the
            # `on_nodes(...)` call is the mutation, so closure bodies
            # are excluded from the lexical order.
            def _own_nodes(root: ast.AST):
                for child in ast.iter_child_nodes(root):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.Lambda)):
                        continue
                    yield child
                    yield from _own_nodes(child)

            for node in _own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                seg = m.seg(node)
                head = seg.split("\n")[0]
                if _INTENT_RE.search(seg):
                    if (first_intent_line is None
                            or node.lineno < first_intent_line):
                        first_intent_line = node.lineno
                if _GUARD_RE.search(head):
                    if (first_guard_line is None
                            or node.lineno < first_guard_line):
                        first_guard_line = node.lineno
                if _MUT_RE.search(head):
                    if first_mut is None or node.lineno < first_mut.lineno:
                        first_mut = node
                if _HEAL_RE.search(head):
                    if first_heal is None or node.lineno < first_heal.lineno:
                        first_heal = node
            if first_mut is not None:
                if first_intent_line is None:
                    out.append(m.finding(
                        "protocol.intent-before-mutation", "error",
                        first_mut,
                        f"`{m.seg(first_mut).split(chr(10))[0][:60]}` "
                        "mutates the session but this method never "
                        "journals ledger intent — a crash here strands "
                        "the fault with no compensator to replay",
                    ))
                elif first_mut.lineno < first_intent_line:
                    out.append(m.finding(
                        "protocol.intent-before-mutation", "error",
                        first_mut,
                        f"session mutation at line {first_mut.lineno} "
                        f"precedes the first ledger intent at line "
                        f"{first_intent_line} — journal intent first so "
                        "a crash between them is replayable",
                    ))
            if first_heal is not None and (
                    first_guard_line is None
                    or first_guard_line > first_heal.lineno):
                out.append(m.finding(
                    "protocol.intent-before-mutation", "error",
                    first_heal,
                    "heal path runs without consulting heal_guard() "
                    "first — abandon-mode crash tests will double-heal",
                ))
    return out


# --------------------------------------------------------------------------
# unknown-compensator
# --------------------------------------------------------------------------


def _registry_from_ledger(modules: list[Module]) -> Optional[set[str]]:
    """The ctypes run_compensator dispatches on, parsed from its AST:
    every ``ctype == "x"`` comparison plus the intent() default."""
    ledger = next((m for m in modules if m.rel == _LEDGER), None)
    if ledger is None:
        return None
    ctypes: set[str] = set()
    for node in walk(ledger.tree):
        if (isinstance(node, ast.Compare)
                and isinstance(node.left, ast.Name)
                and node.left.id == "ctype"
                and len(node.ops) == 1
                and isinstance(node.ops[0], ast.Eq)
                and isinstance(node.comparators[0], ast.Constant)
                and isinstance(node.comparators[0].value, str)):
            ctypes.add(node.comparators[0].value)
    # intent() defaults a missing compensator to {"type": "unreplayable"}.
    ctypes.add("unreplayable")
    return ctypes or None


def _check_compensators(modules: list[Module]) -> list[Finding]:
    registry = _registry_from_ledger(modules)
    if registry is None:
        return []            # fixture batch without the ledger: no-op
    out = []
    for m in modules:
        for node in walk(m.tree):
            if not isinstance(node, ast.Call):
                continue
            for kw in node.keywords:
                if kw.arg != "compensator":
                    continue
                d = kw.value
                if not isinstance(d, ast.Dict):
                    continue
                for k, v in zip(d.keys, d.values):
                    if (isinstance(k, ast.Constant) and k.value == "type"
                            and isinstance(v, ast.Constant)
                            and isinstance(v.value, str)
                            and v.value not in registry):
                        out.append(m.finding(
                            "protocol.unknown-compensator", "error", v,
                            f"compensator type {v.value!r} is not "
                            f"dispatched by ledger.run_compensator "
                            f"(knows: {', '.join(sorted(registry))}) — "
                            "repair would raise at the worst moment",
                        ))
    return out


# --------------------------------------------------------------------------
# counter scan (shared by the namespace rules and doc/counters_torch.md)
# --------------------------------------------------------------------------

_EMIT_ATTRS = {"count": "counter", "gauge": "gauge", "span": "span"}


def _literal_name(node: ast.AST, m: Module) -> Optional[str]:
    """Counter-name argument as text: plain literals verbatim,
    f-strings as ``prefix.{expr}`` with the leading literal kept.
    None for non-literal names (variables)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            elif isinstance(v, ast.FormattedValue):
                parts.append("{" + (m.seg(v.value) or "…") + "}")
        text = "".join(parts)
        return text if text and not text.startswith("{") else None
    return None


def scan_counters(modules: list[Module]) -> list[dict]:
    """Every literal telemetry emission in the scan set:
    ``{name, kind, path, line, subsystem}``.  The protocol rules, the
    generated doc/counters_torch.md, and the drift test all consume
    this."""
    out = []
    for m in modules:
        is_telemetry_pkg = m.rel.startswith("jepsen_tpu_torch/telemetry/")
        for node in walk(m.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            f = node.func
            kind = None
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "telemetry"
                    and f.attr in _EMIT_ATTRS):
                kind = _EMIT_ATTRS[f.attr]
            elif (isinstance(f, ast.Name) and is_telemetry_pkg
                    and f.id in ("_count", "count", "gauge", "span")):
                kind = _EMIT_ATTRS[f.id.lstrip("_")]
            if kind is None:
                continue
            name = _literal_name(node.args[0], m)
            if not name:        # "" is the shared no-op span — skip
                continue
            parts = m.rel.split("/")
            subsystem = (parts[1] if len(parts) > 2
                         else parts[-1].removesuffix(".py"))
            out.append({
                "name": name, "kind": kind, "path": m.rel,
                "line": node.lineno, "subsystem": subsystem,
                "node": node, "module": m,
            })
    out.sort(key=lambda e: (e["name"], e["path"], e["line"]))
    return out


def _fleet_prefixes(modules: list[Module]) -> Optional[tuple[str, ...]]:
    """FLEET_COUNTER_PREFIXES parsed out of telemetry/__init__.py —
    never imported, so lint sees exactly what is committed."""
    tele = next((m for m in modules if m.rel == _TELEMETRY_INIT), None)
    if tele is None:
        return None
    for node in walk(tele.tree):
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name)
                        and t.id == "FLEET_COUNTER_PREFIXES"
                        for t in node.targets)
                and isinstance(node.value, (ast.Tuple, ast.List))):
            vals = [e.value for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)]
            return tuple(vals)
    return None


def declared_namespace(name: str) -> Optional[str]:
    """The longest declared dotted prefix of a counter name, or None.
    Sub-namespaces (e.g. wgl.plan under wgl) resolve to the most
    specific owner, so doc/counters_torch.md files them under the right
    subsystem."""
    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        ns = ".".join(parts[:i])
        if ns in DECLARED_NAMESPACES:
            return ns
    return None


def _check_counters(modules: list[Module]) -> list[Finding]:
    out = []
    emissions = scan_counters(modules)
    for e in emissions:
        ns = declared_namespace(e["name"])
        if ns is None:
            m: Module = e["module"]
            out.append(m.finding(
                "protocol.counter-namespace", "warning", e["node"],
                f"{e['kind']} name {e['name']!r} is outside the "
                f"declared namespaces "
                f"({', '.join(sorted(DECLARED_NAMESPACES))}) — add the "
                "namespace to DECLARED_NAMESPACES + doc/counters_torch.md "
                "or "
                "rename",
            ))
    prefixes = _fleet_prefixes(modules)
    if prefixes:
        for e in emissions:
            if e["kind"] != "counter":
                continue
            rel = e["path"]
            if not (rel.startswith(_FLEET_PATHS) or rel in _FLEET_FILES):
                continue
            if not e["name"].startswith(prefixes):
                m = e["module"]
                out.append(m.finding(
                    "protocol.fleet-counter-prefix", "error", e["node"],
                    f"counter {e['name']!r} in fleet module {rel} "
                    f"does not match FLEET_COUNTER_PREFIXES "
                    f"{prefixes} — telemetry.scoped_reset will zero it "
                    "at the next run scope",
                ))
    return out


# --------------------------------------------------------------------------
# check-safe bypass
# --------------------------------------------------------------------------


def _check_bypass(modules: list[Module]) -> list[Finding]:
    out = []
    for m in modules:
        if m.rel == _CHECKER_CORE:
            continue        # check_safe's own call site lives here
        for node in walk(m.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "check"
                    and len(node.args) >= 2):
                out.append(m.finding(
                    "protocol.check-safe-bypass", "error", node,
                    f"`{m.seg(node)[:60]}` calls a checker directly — "
                    "route through checker.check_safe so the "
                    "wall-clock budget and valid:unknown demotion "
                    "apply",
                ))
    return out


# --------------------------------------------------------------------------
# swallowed teardown exceptions
# --------------------------------------------------------------------------

_TEARDOWNISH = re.compile(
    r"teardown|cleanup|shutdown|__exit__|__del__|^(close|stop|kill)$"
)


def _check_swallowed(modules: list[Module]) -> list[Finding]:
    out = []
    for m in modules:
        for node in walk(m.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            body = [s for s in node.body]
            if not all(isinstance(s, ast.Pass) for s in body):
                continue
            fn = m.enclosing_function(node)
            if fn is None or not _TEARDOWNISH.search(fn.name):
                continue
            exc = m.seg(node.type) if node.type is not None else "Exception"
            out.append(m.finding(
                "protocol.swallowed-teardown", "warning", node,
                f"except {exc}: pass in teardown path `{fn.name}` "
                "swallows the evidence — log.debug it or baseline with "
                "a written justification",
            ))
    return out


# --------------------------------------------------------------------------
# doc/counters_torch.md generation
# --------------------------------------------------------------------------


def render_counters_md(modules: list[Module]) -> str:
    """The canonical counter table.  Regenerate with
    ``jepsen lint --write-counters``; tests/test_torch_analysis.py
    fails when the committed file drifts from this output."""
    emissions = scan_counters(modules)
    by_name: dict[tuple[str, str], list[dict]] = {}
    for e in emissions:
        by_name.setdefault((e["name"], e["kind"]), []).append(e)
    lines = [
        "# Telemetry counters, gauges, and spans",
        "",
        "Generated by `jepsen lint --write-counters` from the live "
        "counter scan",
        "(`jepsen_tpu_torch/analysis/rules/protocol.py:scan_counters`). "
        "Do not edit by",
        "hand — `tests/test_torch_analysis.py::test_counters_doc_drift` "
        "fails when this",
        "table and the code disagree.",
        "",
        "## Namespaces",
        "",
        "| namespace | owner |",
        "|---|---|",
    ]
    for ns, owner in sorted(DECLARED_NAMESPACES.items()):
        lines.append(f"| `{ns}.` | {owner} |")
    lines += [
        "",
        "Fleet-scoped prefixes (survive `telemetry.scoped_reset`): "
        + ", ".join(f"`{p}`" for p in (_fleet_prefixes(modules) or ())),
        "",
        "## Emissions",
        "",
        "| name | kind | subsystem | emitted at |",
        "|---|---|---|---|",
    ]
    for (name, kind), es in sorted(by_name.items()):
        sites = ", ".join(
            f"{e['path']}:{e['line']}" for e in es[:3]
        ) + (f" (+{len(es) - 3} more)" if len(es) > 3 else "")
        subsystems = ", ".join(sorted({e["subsystem"] for e in es}))
        lines.append(f"| `{name}` | {kind} | {subsystems} | {sites} |")
    lines.append("")
    return "\n".join(lines)


def doc_counter_names(text: str) -> set[str]:
    """Counter names committed in doc/counters_torch.md — the drift test
    compares these against the live scan."""
    out = set()
    for line in text.splitlines():
        m = re.match(r"\|\s*`([^`]+)`\s*\|\s*(counter|gauge|span)\s*\|",
                     line)
        if m:
            out.add(m.group(1))
    return out


def check(modules: list[Module]) -> list[Finding]:
    scan = [m for m in modules if m.rel.startswith("jepsen_tpu_torch/")]
    out = _check_intent_order(scan)
    out.extend(_check_compensators(scan))
    out.extend(_check_counters(scan))
    out.extend(_check_bypass(scan))
    out.extend(_check_swallowed(scan))
    return out
