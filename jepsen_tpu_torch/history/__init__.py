"""Histories and their packed columnar form."""

from .core import (FAIL, INFO, INVOKE, NEMESIS, OK, TYPES, History, Op,
                   fail, history, info, invoke, ok, op, parse_literal)
from .packed import NIL, NO_RET, ST_INFO, ST_OK, Interner, PackedOps, pack_history

__all__ = [
    "FAIL", "INFO", "INVOKE", "NEMESIS", "OK", "TYPES", "History", "Op",
    "fail", "history", "info", "invoke", "ok", "op", "parse_literal",
    "NIL", "NO_RET", "ST_INFO", "ST_OK", "Interner", "PackedOps",
    "pack_history",
]
