"""Transaction micro-op helpers — the port's copy of `jepsen_tpu/txn.py`.

A transaction is a list of micro-ops ("mops"), each an [f, k, v]
triple: f is "r", "w" or "append", k a key, v a value (for reads the
observed value, None in invocations).  `reduce_mops` folds over them;
`ext_reads` / `ext_writes` are the reads and writes visible to other
transactions (jepsen.txn's ext-reads and ext-writes).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Sequence

Mop = Sequence  # [f, k, v]


def reduce_mops(f: Callable, init: Any, txn: Iterable[Mop]) -> Any:
    """Folds f(acc, [fk, k, v]) over every mop (txn.clj:6-20)."""
    acc = init
    for mop in txn:
        acc = f(acc, mop)
    return acc


def ext_reads(txn: Iterable[Mop]) -> dict:
    """{k: value} for reads of keys not previously written in this txn
    — reads visible to the outside world (txn.clj:22-45)."""
    out: dict = {}
    written: set = set()
    for fk, k, v in txn:
        if fk == "r":
            if k not in written and k not in out:
                out[k] = v
        else:
            written.add(k)
    return out


def ext_writes(txn: Iterable[Mop]) -> dict:
    """{k: value} of the *last* write to each key — writes visible
    externally (txn.clj:47-79).  For appends the 'value' is the last
    appended element."""
    out: dict = {}
    for fk, k, v in txn:
        if fk != "r":
            out[k] = v
    return out


def int_reads(txn: Iterable[Mop]) -> list:
    """All read mops, internal or external."""
    return [m for m in txn if m[0] == "r"]


def writes(txn: Iterable[Mop]) -> list:
    return [m for m in txn if m[0] != "r"]
