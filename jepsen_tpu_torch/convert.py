"""Carrying a packed history across from the JAX package.

The inputs of this system are packed histories, not weights: the
columns of a `PackedOps` and the interner's value list that gives
their codes meaning.  These functions move them between the JAX
package and the port as plain numpy arrays and lists, so the port
never imports the JAX package's types.  The parity tests use them to
feed identical packed input to both packages.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np

from .history.packed import PACKED_COLUMNS, PackedOps
from .models.base import PackedModel


def packed_from_arrays(arrays: Mapping[str, Any]) -> PackedOps:
    """A port `PackedOps` from its columns (`PACKED_COLUMNS` names, any
    array-likes); dtypes are fixed to the packed layout and every
    column must have the same length."""
    cols = {
        name: np.ascontiguousarray(np.asarray(arrays[name]), dtype=dtype)
        for name, dtype in PACKED_COLUMNS
    }
    n = len(cols["inv"])
    for name, col in cols.items():
        if col.shape != (n,):
            raise ValueError(f"column {name}: shape {col.shape} != ({n},)")
    return PackedOps(**cols)


def packed_to_arrays(p: Any) -> dict[str, np.ndarray]:
    """The columns of a packed history (the port's or the JAX package's
    `PackedOps` — anything with the column attributes) as numpy
    arrays."""
    return {name: np.asarray(getattr(p, name)) for name, _ in PACKED_COLUMNS}


def adopt_values(pm: PackedModel, values: Sequence[Any]) -> None:
    """Loads the JAX package's interner value list into `pm`'s
    interner, so codes in carried-over columns decode the same way.
    Codes the port already assigned must agree with `values`."""
    have = pm.interner.values
    if list(values[: len(have)]) != have:
        raise ValueError(
            f"interner prefix mismatch: port has {have!r}, "
            f"reference has {list(values[: len(have)])!r}"
        )
    for v in values[len(have):]:
        pm.interner.intern(v)
