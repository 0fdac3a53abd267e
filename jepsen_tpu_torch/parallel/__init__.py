"""Many-key checking (jepsen.independent) on one card."""

from .independent import (KV, IndependentChecker, clear_settle_memo,
                          history_keys, is_kv, kv, subhistories)

__all__ = [
    "KV",
    "IndependentChecker",
    "clear_settle_memo",
    "history_keys",
    "is_kv",
    "kv",
    "subhistories",
]
