"""Sequential specification models in their packed int32 form.

The port's copy of `jepsen_tpu/models/base.py`.  A checkable model
compiles itself to a `PackedModel`: an arithmetic transition function
over int32 state vectors, usable as plain Python (`py_step`, the exact
CPU engines) and as batched torch code over search frontiers
(`torch_step`, `torch_step_rows`).  Op payloads are interned to int32
by the model's encoder (history/packed.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..history.packed import Interner, OpEncoderFn


class Model:
    """Base sequential datatype model (knossos.model/Model)."""

    def packed(self) -> "PackedModel":
        """The packed form of this model, memoized per instance so one
        model's interner is shared by every pack and check."""
        cached = getattr(self, "_packed_cache", None)
        if cached is None:
            cached = self._compile_packed()
            self._packed_cache = cached
        return cached

    def _compile_packed(self) -> "PackedModel":
        raise NotImplementedError(
            f"{type(self).__name__} has no packed/device form"
        )


@dataclass
class PackedModel:
    """A model compiled for the packed/device pipeline.

    - `state_width`: int32 words of model state per configuration.
    - `init_state`: tuple of `state_width` ints.
    - `encode`: OpEncoderFn packing (invocation, completion) -> (f, a0,
      a1), or None to drop no-effect indeterminate ops.
    - `py_step(state, f, a0, a1) -> (state', legal)`: plain-Python
      transition over int tuples.
    - `torch_step(states (N, SW) i32, f, a0, a1) -> (states', legal
      (N,) bool)`: the same transition batched over rows; f/a0/a1 are
      Python ints or int32 tensors of shape (N,).
    - `torch_step_rows(states (SW, B) i32, f, a0, a1) -> (states',
      legal (B,) bool)`: the lane-major form for one barrier op (f/a0/
      a1 scalars), the layout of the witness sweep.
    - `kernel_model`: id of the device step compiled into the CUDA
      witness sweep (ops/kernels.py), or None when the sweep kernel
      has no step for this model: its witness then runs only on CPU
      tensors, and a sweep on the card raises.
    - `interner`: maps packed value codes back to real values.
    """

    name: str
    state_width: int
    init_state: tuple[int, ...]
    encode: OpEncoderFn
    py_step: Callable[[tuple[int, ...], int, int, int], tuple[tuple[int, ...], bool]]
    torch_step: Callable[..., Any]
    torch_step_rows: Callable[..., Any]
    interner: Interner
    kernel_model: Optional[int] = None
    #: optional pretty-printer for a packed op row
    describe_op: Optional[Callable[[int, int, int], str]] = None
    #: optional columnar facets for the refutation screens
    #: (checker/refute.py): PackedOps -> RefuteView
    refute_view: Optional[Callable[..., Any]] = None


def intern_value(interner: Interner, v: Any) -> int:
    """Interns an op payload value to an int32 code; lists become
    tuples so they hash."""
    if isinstance(v, list):
        v = tuple(v)
    return interner.intern(v)
