"""Rule families.  Each module exposes ``check(modules) -> [Finding]``
plus a ``RULES`` catalog ({rule-id: (severity, one-line doc)}) that
SARIF rule metadata and the test suite are built from."""

from . import concurrency, device, durability, protocol

FAMILIES = {
    "device": device.check,
    "concurrency": concurrency.check,
    "durability": durability.check,
    "protocol": protocol.check,
}

#: {rule-id: (severity, doc)} over every family — the catalog.  The
#: ``lint.*`` entries are synthesized by the runner itself (core.py),
#: not by a family, but belong in the catalog so SARIF metadata and
#: the docs cover them.
RULES = {
    **device.RULES,
    **concurrency.RULES,
    **durability.RULES,
    **protocol.RULES,
    "lint.suppression-missing-reason": (
        "error",
        "ignore pragma with no written reason",
    ),
    "lint.unused-suppression": (
        "error",
        "ignore pragma that matches no finding — stale, delete it",
    ),
    "lint.syntax-error": (
        "error",
        "file in the scan set that does not parse",
    ),
}
