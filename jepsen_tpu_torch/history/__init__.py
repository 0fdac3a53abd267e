"""Histories and their packed columnar form."""

from .core import (FAIL, INFO, INVOKE, NEMESIS, OK, TYPES, History, Op,
                   fail, history, info, invoke, ok, op, parse_literal)
from .fold import Fold, Task, loopf, task
from .fold import fold as run_fold  # `fold` stays the submodule name
from .packed import NIL, NO_RET, ST_INFO, ST_OK, Interner, PackedOps, pack_history

__all__ = [
    "FAIL", "INFO", "INVOKE", "NEMESIS", "OK", "TYPES", "History", "Op",
    "fail", "history", "info", "invoke", "ok", "op", "parse_literal",
    "NIL", "NO_RET", "ST_INFO", "ST_OK", "Interner", "PackedOps",
    "pack_history", "Fold", "Task", "loopf", "run_fold", "task",
]
