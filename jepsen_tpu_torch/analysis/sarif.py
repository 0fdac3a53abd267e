"""SARIF 2.1.0 output for jepsenlint — the CI annotation surface.

One run, one tool (``jepsenlint``), rule metadata pulled from the
family catalogs, and one result per *unbaselined* finding (the gate
set: what a reviewer must act on).  Baselined findings are emitted as
suppressed results so the SARIF consumer sees the whole picture but
annotates only the live debt.  The line-motion-stable jepsenlint
fingerprint rides in ``partialFingerprints`` so GitHub's alert
tracking follows the same identity the baseline does.

The exit-code gate is unaffected: this is a *rendering* of the report,
written best-effort next to whatever the CLI was asked for.
"""

from __future__ import annotations

import json
from typing import Any

from .core import Finding, LintReport

#: SARIF `level` per jepsenlint severity.
_LEVEL = {"error": "error", "warning": "warning", "advice": "note"}


def _rule_ids(report: LintReport) -> list[str]:
    from .rules import RULES

    ids = set(RULES)
    for f in report.findings + report.baselined:
        ids.add(f.rule)
    return sorted(ids)


def _result(f: Finding, *, suppressed: bool = False) -> dict:
    out: dict[str, Any] = {
        "ruleId": f.rule,
        "level": _LEVEL.get(f.severity, "warning"),
        "message": {"text": f"{f.symbol}: {f.message}"},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {
                    "uri": f.path,
                    "uriBaseId": "SRCROOT",
                },
                "region": {"startLine": max(1, f.line)},
            },
        }],
        "partialFingerprints": {"jepsenlint/v1": f.fingerprint},
    }
    if suppressed:
        out["suppressions"] = [{
            "kind": "external",
            "justification": "accepted in lint_baseline.json",
        }]
    return out


def render_sarif(report: LintReport) -> dict:
    from .rules import RULES

    rules = []
    for rid in _rule_ids(report):
        sev, doc = RULES.get(rid, ("warning", rid))
        rules.append({
            "id": rid,
            "shortDescription": {"text": doc},
            "defaultConfiguration": {
                "level": _LEVEL.get(sev, "warning"),
            },
        })
    results = [_result(f) for f in report.findings]
    results += [_result(f, suppressed=True) for f in report.baselined]
    return {
        "version": "2.1.0",
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "runs": [{
            "tool": {
                "driver": {
                    "name": "jepsenlint",
                    "informationUri":
                        "https://example.invalid/jepsenlint",
                    "rules": rules,
                },
            },
            "originalUriBaseIds": {
                "SRCROOT": {"uri": "file:///"},
            },
            "results": results,
        }],
    }


def write_sarif(report: LintReport, path: str) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(render_sarif(report), f, indent=2, sort_keys=True)
        f.write("\n")
    return path
