"""Many-key checking (jepsen.independent), with keys split over the
devices of a mesh, and the mesh helpers."""

from .independent import (KV, IndependentChecker, clear_settle_memo,
                          history_keys, independent_checker, is_kv, kv,
                          subhistories, tuple_gen)
from .mesh import Mesh, checker_mesh, default_mesh, multihost_init

__all__ = [
    "KV",
    "IndependentChecker",
    "clear_settle_memo",
    "history_keys",
    "independent_checker",
    "is_kv",
    "kv",
    "subhistories",
    "tuple_gen",
    "Mesh",
    "checker_mesh",
    "default_mesh",
    "multihost_init",
]
