"""Mutex model (knossos.model/mutex).

The port's copy of `jepsen_tpu/models/mutex.py`: one word of state,
1 while the lock is held.  Acquire is legal iff the lock is free,
release iff it is held.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..history.core import Op
from ..history.packed import NIL, Interner
from .base import Model, PackedModel, inconsistent

F_ACQUIRE, F_RELEASE = 0, 1

#: `PackedModel.kernel_model` id of the mutex step compiled into the
#: witness sweep kernel (csrc/witness_sweep.cu MODEL_MUTEX).
KERNEL_MUTEX = 2


def _mutex_step(held: torch.Tensor, f):
    """The mutex transition over a vector of lock words: any f other
    than acquire steps as a release, as the reference's `jax_step`."""
    is_acq = torch.as_tensor(f, device=held.device) == F_ACQUIRE
    legal = torch.where(is_acq, held == 0, held == 1)
    new = torch.where(is_acq, 1, 0).to(torch.int32).expand_as(held)
    return new, legal


class Mutex(Model):
    def __init__(self, locked: bool = False):
        self.locked = locked

    def step(self, op: Op):
        if op.f == "acquire":
            if self.locked:
                return inconsistent("cannot acquire held mutex")
            return Mutex(True)
        if op.f == "release":
            if not self.locked:
                return inconsistent("cannot release free mutex")
            return Mutex(False)
        return inconsistent(f"unknown op f {op.f!r}")

    def __eq__(self, other):
        return type(other) is Mutex and other.locked == self.locked

    def __hash__(self):
        return hash(("Mutex", self.locked))

    def __repr__(self):
        return f"Mutex(locked={self.locked})"

    def _compile_packed(self) -> PackedModel:
        interner = Interner()
        interner.intern(None)
        init = (1 if self.locked else 0,)

        def encode(inv: Op, comp: Optional[Op]):
            if inv.f == "acquire":
                return (F_ACQUIRE, NIL, NIL)
            if inv.f == "release":
                return (F_RELEASE, NIL, NIL)
            raise ValueError(f"mutex can't encode op f {inv.f!r}")

        def py_step(state, f, a0, a1):
            held = state[0]
            if f == F_ACQUIRE:
                return (1,), held == 0
            return (0,), held == 1

        def torch_step(states, f, a0, a1):
            new, legal = _mutex_step(states[:, 0], f)
            return new[:, None], legal

        def torch_step_rows(states, f, a0, a1):
            # Lane-major (1, B).
            new, legal = _mutex_step(states[0], f)
            return new[None, :], legal

        def describe_op(f: int, a0: int, a1: int) -> str:
            return "acquire" if f == F_ACQUIRE else "release"

        return PackedModel(
            name="mutex",
            state_width=1,
            init_state=init,
            encode=encode,
            py_step=py_step,
            torch_step=torch_step,
            torch_step_rows=torch_step_rows,
            interner=interner,
            kernel_model=KERNEL_MUTEX,
            describe_op=describe_op,
        )


def mutex() -> Mutex:
    return Mutex(False)
