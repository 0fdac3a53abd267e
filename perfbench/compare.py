"""The comparison that decides `correct`: every check of the window
against the reference's verdicts on the history it checked.

A check's outcome is an entry's dict: "valid", and for a keyed entry
"keys" ({key: valid}), "failure_count" and "key_count"; or None when
the check raised.  Every number is a count of disagreements, and the
comparison is exact: each limit is 0.
"""

from __future__ import annotations

#: name -> limit.  The keyed numbers are compared only for keyed cells.
LIMITS = {
    "no_verdict": 0,
    "verdict_mismatches": 0,
    "key_mismatches": 0,
    "failure_count_gap": 0,
}
KEYED = ("key_mismatches", "failure_count_gap")


def compare(checks: list, truth: dict, keyed: bool) -> dict:
    """{name: {"value", "limit"}} over `checks`, a list of (pool index,
    outcome), against `truth`, {pool index: {key: linearizable}}."""
    n = dict.fromkeys(LIMITS, 0)
    for idx, out in checks:
        keys = truth[idx]
        want = all(keys.values())
        if out is None or out["valid"] not in (True, False):
            n["no_verdict"] += 1
            continue
        n["verdict_mismatches"] += out["valid"] != want
        if keyed:
            got = out["keys"]
            n["key_mismatches"] += sum(
                got.get(k) != v for k, v in keys.items()) + sum(
                k not in keys for k in got)
            n["failure_count_gap"] += abs(
                out["failure_count"] - sum(not v for v in keys.values()))
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in n.items()
            if keyed or k not in KEYED}


def correct(compared: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in compared.values())
