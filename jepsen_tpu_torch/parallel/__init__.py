"""Many-key checking (jepsen.independent), with keys split over the
devices of a mesh, and the mesh helpers."""

from .independent import (KV, IndependentChecker, clear_settle_memo,
                          history_keys, is_kv, kv, subhistories)
from .mesh import Mesh, checker_mesh, default_mesh, multihost_init

__all__ = [
    "KV",
    "IndependentChecker",
    "clear_settle_memo",
    "history_keys",
    "is_kv",
    "kv",
    "subhistories",
    "Mesh",
    "checker_mesh",
    "default_mesh",
    "multihost_init",
]
