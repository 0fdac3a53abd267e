"""Histories and their packed columnar form."""

from .core import FAIL, INFO, INVOKE, OK, History, Op, history
from .packed import NIL, NO_RET, ST_INFO, ST_OK, Interner, PackedOps, pack_history

__all__ = [
    "FAIL", "INFO", "INVOKE", "OK", "History", "Op", "history",
    "NIL", "NO_RET", "ST_INFO", "ST_OK", "Interner", "PackedOps",
    "pack_history",
]
