"""jepsenlint core: module loading, findings, suppressions, baseline.

The port's copy of `jepsen_tpu/analysis/core.py`, aimed at the port:
it scans ``jepsen_tpu_torch/`` and ``chip_smoke.py`` (the port's bench
script), and its baseline is ``jepsen_tpu_torch/lint_baseline.json``.

The analyzer is a pure-``ast`` pass over the repo's own sources — no
imports of the analyzed code, no third-party dependencies — so it runs
identically in CI, under pytest, and on a machine with neither torch
nor a card.
The whole-repo contract is <10 s (including the interprocedural
effect-summary build in effects.py); in practice a full parse+analyze
of ~200 files is well under 3 s.

Three moving parts:

  * **Finding** — one violation: rule id, severity, location, the
    enclosing symbol, and a *fingerprint* that is stable under line
    motion (hash of rule/path/symbol/message plus an occurrence index,
    never the line number), so baselines survive unrelated edits.
  * **Suppressions** — ``# jepsenlint: ignore[rule] -- reason`` on the
    flagged line or the line above.  The reason is mandatory: a bare
    ignore is itself an ``error`` finding, so every silenced rule has a
    written why next to the code it silences.
  * **Baseline** — ``jepsen_tpu_torch/lint_baseline.json``: accepted
    findings with justifications.  ``jepsen lint`` exits nonzero on any
    finding that is neither suppressed nor baselined; stale baseline
    entries (fixed code) are reported but never fail the gate, so
    fixing debt cannot break CI.
"""

from __future__ import annotations

import ast
import gc
import hashlib
import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

#: Severity order, most severe first.  Every unbaselined, unsuppressed
#: finding fails the gate regardless of severity; the tiers order the
#: report and feed the jepsen_lint_findings{severity=...} gauges.
SEVERITIES = ("error", "warning", "advice")

#: Whole-repo runtime contract (seconds); run_lint records its own
#: duration and test_analysis asserts against this.  Tightened from
#: 30 s when the interprocedural analyzer landed: the tier-1 gate cost
#: must stay negligible even with effect summaries in the loop.
RUNTIME_BUDGET_S = 10.0

BASELINE_FILE = "jepsen_tpu_torch/lint_baseline.json"

#: The scan set under the repo root when no paths are given.
SCAN_ROOTS = ("jepsen_tpu_torch", "chip_smoke.py")

#: Where ``--write-counters`` writes the counter table by default.
COUNTERS_DOC = "doc/counters_torch.md"

#: Suppression pragma — the whole comment, nothing before it:
#: ``jepsenlint: ignore[rule, family] -- reason`` (``:`` also accepted
#: before the reason).  Applies to its own line and the line below, so
#: it can sit above a long expression.  Anchored at the comment start
#: so prose *about* the pragma syntax (like this very comment) never
#: parses as a suppression.
_PRAGMA_RE = re.compile(
    r"^#+:?\s*jepsenlint:\s*ignore\[([^\]]*)\]\s*"
    r"(?:(?:--|:)\s*(\S.*))?\s*$"
)

#: Directories never scanned (generated, vendored, or test fixtures
#: that violate rules on purpose).  Note jepsen_tpu_torch/store/ — the
#: framed-file format module — IS scanned: the durability family's
#: block-id collision rule needs its BLOCK_* constants.  The repo-root
#: store/ data directory never enters the walk (the default roots are
#: SCAN_ROOTS) and holds no .py files anyway.
_SKIP_DIRS = {"__pycache__", ".git", "tests"}


@dataclass(frozen=True)
class Finding:
    rule: str          # "family.rule-name"
    severity: str      # one of SEVERITIES
    path: str          # repo-relative, "/" separated
    line: int
    symbol: str        # enclosing "Class.method" / "func" / "<module>"
    message: str
    fingerprint: str = ""

    @property
    def family(self) -> str:
        return self.rule.split(".", 1)[0]

    def sort_key(self) -> tuple:
        return (SEVERITIES.index(self.severity), self.path, self.line,
                self.rule)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }


def _fingerprint(rule: str, path: str, symbol: str, message: str,
                 occurrence: int) -> str:
    """Line-independent identity: identical findings in the same symbol
    are disambiguated by their ordinal, not their line number, so a
    baseline survives code moving around above it."""
    raw = f"{rule}|{path}|{symbol}|{message}|{occurrence}"
    return hashlib.sha256(raw.encode()).hexdigest()[:12]


def assign_fingerprints(findings: list[Finding]) -> list[Finding]:
    """Returns findings with fingerprints filled in, ordered by
    severity/path/line.  Occurrence indices are assigned in line order
    within each (rule, path, symbol, message) group."""
    groups: dict[tuple, list[Finding]] = {}
    for f in findings:
        groups.setdefault((f.rule, f.path, f.symbol, f.message),
                          []).append(f)
    out = []
    for key, fs in groups.items():
        for i, f in enumerate(sorted(fs, key=lambda f: f.line)):
            out.append(Finding(
                rule=f.rule, severity=f.severity, path=f.path,
                line=f.line, symbol=f.symbol, message=f.message,
                fingerprint=_fingerprint(*key, i),
            ))
    out.sort(key=Finding.sort_key)
    return out


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def walk(node: ast.AST) -> list[ast.AST]:
    """``list(ast.walk(node))``, in its order, memoized on the node: the
    rule families walk the same trees and function bodies again and
    again, and those walks were most of the whole-repo runtime.  The
    trees are never mutated after parsing, so the memo stays true."""
    nodes = node.__dict__.get("_jl_walk")
    if nodes is None:
        nodes = list(ast.walk(node))
        node._jl_walk = nodes  # type: ignore[attr-defined]
    return nodes


class Module:
    """One parsed source file plus the lookups every rule needs: parent
    links, enclosing-symbol resolution, and source segments."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=rel)
        # Dotted import name ("jepsen_tpu_torch.ops.wgl"), for lock ids and
        # cross-module call resolution.
        mod = self.rel[:-3] if self.rel.endswith(".py") else self.rel
        if mod.endswith("/__init__"):
            mod = mod[: -len("/__init__")]
        self.name = mod.replace("/", ".")
        # Parent links, in one breadth-first pass that also leaves the
        # tree's walk memoized (`walk`).
        nodes: list[ast.AST] = [self.tree]
        i = 0
        while i < len(nodes):
            parent = nodes[i]
            for child in ast.iter_child_nodes(parent):
                child._jl_parent = parent  # type: ignore[attr-defined]
                nodes.append(child)
            i += 1
        self.tree._jl_walk = nodes  # type: ignore[attr-defined]

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return getattr(node, "_jl_parent", None)

    def parents(self, node: ast.AST) -> Iterable[ast.AST]:
        p = self.parent(node)
        while p is not None:
            yield p
            p = self.parent(p)

    def enclosing_function(
        self, node: ast.AST
    ) -> Optional[ast.FunctionDef]:
        for p in self.parents(node):
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return p
        return None

    def enclosing_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        for p in self.parents(node):
            if isinstance(p, ast.ClassDef):
                return p
        return None

    def symbol(self, node: ast.AST) -> str:
        """"Class.method" / "func" / "<module>" for a node; nested
        functions join with ".", matching how humans name the spot."""
        names = []
        n: Optional[ast.AST] = node
        while n is not None:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                names.append(n.name)
            n = self.parent(n)
        return ".".join(reversed(names)) or "<module>"

    def seg(self, node: ast.AST) -> str:
        """Source text of a node ("" when unavailable).  Sliced from
        the precomputed line list — ast.get_source_segment re-splits
        the whole file per call, which alone blew the 30 s whole-repo
        budget ~2x."""
        try:
            l0 = node.lineno - 1
            l1 = node.end_lineno - 1
            c0, c1 = node.col_offset, node.end_col_offset
        except AttributeError:
            return ""
        try:
            if l0 == l1:
                return self.lines[l0][c0:c1]
            parts = [self.lines[l0][c0:]]
            parts.extend(self.lines[l0 + 1: l1])
            parts.append(self.lines[l1][:c1])
            return "\n".join(parts)
        except IndexError:
            return ""

    def finding(self, rule: str, severity: str, node: ast.AST,
                message: str) -> Finding:
        return Finding(
            rule=rule, severity=severity, path=self.rel,
            line=getattr(node, "lineno", 1),
            symbol=self.symbol(node), message=message,
        )


def load_modules(
    root: str, paths: Optional[list[str]] = None
) -> list[Module]:
    """Parses the scan set: ``SCAN_ROOTS`` (``jepsen_tpu_torch/`` and
    ``chip_smoke.py``) under `root` (or an explicit file/dir list).  Files
    that fail to parse become a synthetic ``lint.syntax-error`` via
    run_lint; here they are skipped."""
    roots: list[str] = []
    if paths:
        roots = [p if os.path.isabs(p) else os.path.join(root, p)
                 for p in paths]
    else:
        for rel in SCAN_ROOTS:
            p = os.path.join(root, rel)
            if os.path.exists(p):
                roots.append(p)
    files: list[str] = []
    for p in roots:
        if os.path.isfile(p):
            files.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in sorted(dirnames)
                           if d not in _SKIP_DIRS]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    files.append(os.path.join(dirpath, fn))
    out: list[Module] = []
    for path in files:
        rel = os.path.relpath(path, root)
        try:
            with open(path, encoding="utf-8") as f:
                src = f.read()
            out.append(Module(path, rel, src))
        except (OSError, SyntaxError, ValueError):
            continue
    return out


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------


@dataclass
class Suppression:
    line: int
    rules: tuple[str, ...]
    reason: Optional[str]
    used: bool = False


def _comment_lines(module: Module) -> dict[int, str]:
    """{line: comment text} from real COMMENT tokens — a pragma quoted
    inside a docstring or f-string (docs showing the syntax) must not
    parse as a suppression, or the unused-suppression rule flags the
    documentation."""
    import io
    import tokenize

    out: dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(
                io.StringIO(module.source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # Fall back to raw lines on tokenizer trouble; the module
        # parsed, so this is vanishingly rare.
        return dict(enumerate(module.lines, start=1))
    return out


def parse_suppressions(module: Module) -> list[Suppression]:
    out = []
    for i, text in sorted(_comment_lines(module).items()):
        m = _PRAGMA_RE.match(text.strip())
        if not m:
            continue
        rules = tuple(
            r.strip() for r in m.group(1).split(",") if r.strip()
        )
        reason = (m.group(2) or "").strip() or None
        out.append(Suppression(line=i, rules=rules or ("*",),
                               reason=reason))
    return out


def _matches(supp: Suppression, finding: Finding) -> bool:
    if finding.line not in (supp.line, supp.line + 1):
        return False
    return any(r in ("*", finding.rule, finding.family)
               for r in supp.rules)


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


def baseline_path(root: str) -> str:
    return os.path.join(root, BASELINE_FILE)


def load_baseline(path: str) -> dict[str, dict]:
    """{fingerprint: entry}.  A missing or unreadable file is an empty
    baseline — the gate then simply requires a clean tree."""
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    out = {}
    for e in data.get("findings", []):
        if isinstance(e, dict) and e.get("fingerprint"):
            out[e["fingerprint"]] = e
    return out


def save_baseline(path: str, findings: list[Finding],
                  old: Optional[dict[str, dict]] = None,
                  justification: Optional[str] = None) -> None:
    """Writes the baseline as the given findings; justifications of
    surviving fingerprints are carried over, new entries get
    `justification` (or a to-be-filled marker CI will tolerate but a
    reviewer should not)."""
    old = old or {}
    entries = []
    for f in sorted(findings, key=Finding.sort_key):
        prev = old.get(f.fingerprint) or {}
        entries.append({
            **f.to_dict(),
            "justification": prev.get("justification")
            or justification
            or "UNREVIEWED — justify or fix before merging",
        })
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(
            {"version": 1, "tool": "jepsenlint", "findings": entries},
            fh, indent=2, sort_keys=True,
        )
        fh.write("\n")


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


@dataclass
class LintReport:
    findings: list[Finding] = field(default_factory=list)       # gate set
    baselined: list[Finding] = field(default_factory=list)
    suppressed: list[tuple[Finding, str]] = field(default_factory=list)
    stale_baseline: list[dict] = field(default_factory=list)
    duration_s: float = 0.0
    files: int = 0

    @property
    def all_findings(self) -> list[Finding]:
        return sorted(self.findings + self.baselined,
                      key=Finding.sort_key)

    def counts(self, which: Optional[list[Finding]] = None) -> dict:
        out = {s: 0 for s in SEVERITIES}
        for f in (self.all_findings if which is None else which):
            out[f.severity] = out.get(f.severity, 0) + 1
        return out

    def family_counts(
        self, which: Optional[list[Finding]] = None
    ) -> dict:
        """{family: {severity: count}} — the shape behind the
        jepsen_lint_findings{family,severity} gauges."""
        out: dict[str, dict] = {}
        for f in (self.all_findings if which is None else which):
            fam = out.setdefault(f.family, {s: 0 for s in SEVERITIES})
            fam[f.severity] = fam.get(f.severity, 0) + 1
        return out

    @property
    def clean(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {
            "clean": self.clean,
            "files": self.files,
            "duration_s": round(self.duration_s, 3),
            "counts": self.counts(),
            "unbaselined": [f.to_dict() for f in self.findings],
            "baselined": [f.to_dict() for f in self.baselined],
            "suppressed": [
                {**f.to_dict(), "reason": reason}
                for f, reason in self.suppressed
            ],
            "stale_baseline": self.stale_baseline,
        }


def _families() -> dict[str, Callable]:
    from .rules import FAMILIES

    return FAMILIES


def analyze_modules(
    modules: list[Module],
    families: Optional[Iterable[str]] = None,
) -> list[Finding]:
    """Raw findings (fingerprinted, suppressions NOT yet applied) from
    running the selected rule families over parsed modules."""
    fams = _families()
    names = list(families) if families else list(fams)
    found: list[Finding] = []
    for name in names:
        found.extend(fams[name](modules))
    return assign_fingerprints(found)


def run_lint(
    root: str,
    *,
    paths: Optional[list[str]] = None,
    baseline: Optional[str] = None,
    families: Optional[Iterable[str]] = None,
) -> LintReport:
    t0 = time.perf_counter()
    # The batch allocates millions of AST/summary objects and frees
    # almost nothing until it returns — generational gc passes over
    # that live heap are pure overhead (~20% of the runtime budget).
    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        modules = load_modules(root, paths)
        raw = analyze_modules(modules, families)
    finally:
        if gc_was_on:
            gc.enable()

    # Suppressions: a matching pragma with a reason silences the
    # finding; a matching pragma WITHOUT a reason converts it into a
    # suppression-missing-reason error on the pragma line.
    supps = {m.rel: parse_suppressions(m) for m in modules}
    kept: list[Finding] = []
    suppressed: list[tuple[Finding, str]] = []
    for f in raw:
        hit = next(
            (s for s in supps.get(f.path, []) if _matches(s, f)), None
        )
        if hit is None:
            kept.append(f)
        elif hit.reason:
            hit.used = True
            suppressed.append((f, hit.reason))
        else:
            hit.used = True
            kept.append(Finding(
                rule="lint.suppression-missing-reason",
                severity="error", path=f.path, line=hit.line,
                symbol=f.symbol,
                message=f"ignore[{f.rule}] pragma has no reason; write "
                        f"`# jepsenlint: ignore[{f.rule}] -- why`",
            ))
    # A reasoned pragma that matches nothing is debt pretending to be
    # documentation: the code it silenced was fixed (or the rule id is
    # wrong) and the pragma now silences whatever lands on that line
    # next.  Only meaningful on a full run — a subset of paths or
    # families legitimately leaves pragmas unmatched.
    if paths is None and families is None:
        for m in modules:
            for s in supps.get(m.rel, []):
                if not s.used:
                    kept.append(Finding(
                        rule="lint.unused-suppression",
                        severity="error", path=m.rel, line=s.line,
                        symbol="<module>",
                        message=(
                            f"ignore[{', '.join(s.rules)}] pragma "
                            "matches no finding — the debt it "
                            "documented is gone; delete the pragma"
                        ),
                    ))
    kept = assign_fingerprints(kept)

    bl_path = baseline or baseline_path(root)
    bl = load_baseline(bl_path)
    gate = [f for f in kept if f.fingerprint not in bl]
    matched = [f for f in kept if f.fingerprint in bl]
    live = {f.fingerprint for f in kept}
    stale = [e for fp, e in sorted(bl.items()) if fp not in live]

    return LintReport(
        findings=gate,
        baselined=matched,
        suppressed=suppressed,
        stale_baseline=stale,
        duration_s=time.perf_counter() - t0,
        files=len(modules),
    )


def lint_source(
    source: str,
    rel: str = "jepsen_tpu_torch/fixture.py",
    families: Optional[Iterable[str]] = None,
    extra: Optional[dict[str, str]] = None,
) -> list[Finding]:
    """Lints a source string as if it lived at `rel` — the test-fixture
    entry point.  `extra` maps additional rel paths to sources analyzed
    in the same batch (for cross-module rules)."""
    modules = [Module(rel, rel, source)]
    for erel, esrc in (extra or {}).items():
        modules.append(Module(erel, erel, esrc))
    return analyze_modules(modules, families)


# ---------------------------------------------------------------------------
# Output + CLI
# ---------------------------------------------------------------------------


def render_human(report: LintReport, *, verbose: bool = False) -> str:
    lines = []
    for f in report.findings:
        lines.append(
            f"{f.path}:{f.line}: {f.severity} {f.rule} "
            f"[{f.fingerprint}] {f.symbol}: {f.message}"
        )
    if verbose:
        for f in report.baselined:
            lines.append(
                f"{f.path}:{f.line}: baselined {f.rule} "
                f"[{f.fingerprint}] {f.symbol}: {f.message}"
            )
        for f, reason in report.suppressed:
            lines.append(
                f"{f.path}:{f.line}: suppressed {f.rule}: {reason}"
            )
    for e in report.stale_baseline:
        lines.append(
            f"stale baseline entry [{e.get('fingerprint')}] "
            f"{e.get('rule')} at {e.get('path')} — fixed? run "
            f"--update-baseline to drop it"
        )
    c = report.counts()
    gate = report.counts(report.findings)
    lines.append(
        f"jepsenlint: {report.files} files in "
        f"{report.duration_s:.2f}s — "
        + ", ".join(f"{c[s]} {s}" for s in SEVERITIES)
        + f" ({sum(gate.values())} unbaselined, "
        f"{len(report.baselined)} baselined, "
        f"{len(report.suppressed)} suppressed, "
        f"{len(report.stale_baseline)} stale)"
    )
    return "\n".join(lines)


def render_json(report: LintReport) -> str:
    return json.dumps(report.to_dict(), indent=2, sort_keys=True)


def write_store_summary(report: LintReport, store_dir: str) -> Optional[str]:
    """Drops a lint.json summary into the store dir (when it exists) so
    the web /fleet page and /metrics scrape can surface lint state from
    another process.  Best-effort: lint's exit code never depends on
    this write."""
    if not os.path.isdir(store_dir):
        return None
    path = os.path.join(store_dir, "lint.json")
    try:
        payload = {
            "at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "clean": report.clean,
            "counts": report.counts(),
            "families": report.family_counts(),
            "unbaselined": len(report.findings),
            "baselined": len(report.baselined),
            "suppressed": len(report.suppressed),
            "stale": len(report.stale_baseline),
            "duration_s": round(report.duration_s, 3),
            "files": report.files,
        }
        # Atomic: the web /fleet page and /metrics scrape read this
        # back from another process — a torn lint.json must never be
        # observable (durability.non-atomic-checkpoint, eating our
        # own dogfood).
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path
    except OSError:
        return None


def read_store_summary(store_dir: str) -> Optional[dict]:
    try:
        with open(os.path.join(store_dir, "lint.json"),
                  encoding="utf-8") as f:
            data = json.load(f)
        return data if isinstance(data, dict) else None
    except (OSError, ValueError):
        return None


def add_lint_args(p: Any) -> None:
    """Registers the lint flags on an argparse parser (shared between
    `jepsen lint` and python -m jepsen_tpu_torch.analysis)."""
    p.add_argument(
        "paths", nargs="*", default=None,
        help="files/dirs to lint (default: jepsen_tpu_torch, "
        "chip_smoke.py)",
    )
    p.add_argument("--root", default=None,
                   help="repo root (default: auto-detected)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable report on stdout")
    p.add_argument("--verbose", "-v", action="store_true",
                   help="also list baselined and suppressed findings")
    p.add_argument("--baseline", default=None,
                   help=f"baseline file (default: <root>/{BASELINE_FILE})")
    p.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline to the current findings (keeps "
        "existing justifications, drops stale entries); new entries "
        "need a written justification before merging",
    )
    p.add_argument(
        "--families", default=None,
        help="comma-separated rule families "
        "(device,concurrency,durability,protocol)",
    )
    p.add_argument(
        "--sarif", default=None, metavar="PATH",
        help="also write the unbaselined findings as SARIF 2.1.0 "
        "(for CI PR annotation); exit code is unchanged",
    )
    p.add_argument(
        "--write-counters", nargs="?", const=COUNTERS_DOC,
        default=None, metavar="PATH",
        help="regenerate the canonical telemetry-counter table "
        f"(default {COUNTERS_DOC}) from the protocol rule's scan",
    )
    p.add_argument(
        "--lint-store-dir", default="store", metavar="DIR",
        help="store dir to drop the lint.json observatory summary "
        "into when it exists (default: store)",
    )


def find_root(start: Optional[str] = None) -> str:
    """The repo root: nearest ancestor holding jepsen_tpu_torch/ (falls back
    to this package's grandparent)."""
    d = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.isdir(os.path.join(d, "jepsen_tpu_torch")):
            return d
        nxt = os.path.dirname(d)
        if nxt == d:
            break
        d = nxt
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def main(opts: Any) -> int:
    """Shared driver behind every lint entry point.  Exit 0 = clean
    (no unbaselined findings), 1 = findings, 2 = internal error."""
    root = os.path.abspath(opts.root) if opts.root else find_root()
    families = None
    if getattr(opts, "families", None):
        families = [f.strip() for f in opts.families.split(",")
                    if f.strip()]

    if getattr(opts, "write_counters", None):
        from .rules import protocol

        path = opts.write_counters
        if not os.path.isabs(path):
            path = os.path.join(root, path)
        text = protocol.render_counters_md(load_modules(root))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"wrote {path}")
        return 0

    report = run_lint(
        root,
        paths=opts.paths or None,
        baseline=opts.baseline,
        families=families,
    )

    if getattr(opts, "update_baseline", False):
        bl_path = opts.baseline or baseline_path(root)
        old = load_baseline(bl_path)
        save_baseline(bl_path, report.all_findings, old)
        print(f"baseline rewritten: {bl_path} "
              f"({len(report.all_findings)} entries)")
        return 0

    sarif_path = getattr(opts, "sarif", None)
    if sarif_path:
        from . import sarif

        if not os.path.isabs(sarif_path):
            sarif_path = os.path.join(root, sarif_path)
        sarif.write_sarif(report, sarif_path)

    store_dir = getattr(opts, "lint_store_dir", None)
    if store_dir:
        if not os.path.isabs(store_dir):
            store_dir = os.path.join(root, store_dir)
        write_store_summary(report, store_dir)

    print(render_json(report) if opts.as_json
          else render_human(report, verbose=opts.verbose))
    return 0 if report.clean else 1
