"""Register-family models: register and cas-register.

The port's copy of `jepsen_tpu/models/registers.py` (register and
cas-register only).  A read of `nil` is unconstrained (unknown
return), reads must otherwise match the current value, writes always
succeed, cas succeeds iff the old value matches.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..history.core import OK, Op
from ..history.packed import NIL, Interner
from .base import Model, PackedModel, intern_value

F_READ, F_WRITE, F_CAS = 0, 1, 2

#: `PackedModel.kernel_model` id of the register step compiled into the
#: witness sweep kernel (csrc/witness_sweep.cu MODEL_REGISTER).
KERNEL_REGISTER = 1


class Register(Model):
    """A single read/write register."""

    fs = ("read", "write")

    def __init__(self, value: Any = None):
        self.value = value

    def __repr__(self):
        return f"{type(self).__name__}({self.value!r})"

    def _compile_packed(self) -> PackedModel:
        return _register_packed(self, allow_cas=False)


class CASRegister(Register):
    """A register with read/write/compare-and-set."""

    fs = ("read", "write", "cas")

    def _compile_packed(self) -> PackedModel:
        return _register_packed(self, allow_cas=True)


def _pick(cond, x, y, like: torch.Tensor) -> torch.Tensor:
    """`torch.where(cond, x, y)` that also takes a Python bool `cond`
    (a scalar op code) and Python int branches, broadcast to `like`."""
    if isinstance(cond, (bool, np.bool_)):
        v = x if cond else y
        return (v.expand_as(like) if isinstance(v, torch.Tensor)
                else torch.full_like(like, v))
    return torch.where(cond, x, y)


def _register_step(s: torch.Tensor, f, a0, a1):
    """The register transition over a vector of register values `s`
    (int32): the arithmetic of the reference's `jax_step`, with f/a0/a1
    Python ints or int32 tensors broadcastable to `s`."""
    is_write = f == F_WRITE
    is_cas = f == F_CAS
    legal = (s == a0) | is_write
    new = _pick(is_write, a0, _pick(is_cas, a1, s, s), s)
    return new.to(torch.int32), legal


def _register_packed(model: Register, allow_cas: bool) -> PackedModel:
    interner = Interner()
    interner.intern(None)  # id 0
    init = (intern_value(interner, model.value),)

    def encode(inv: Op, comp: Optional[Op]):
        f = inv.f
        if f == "read":
            if comp is None or comp.type != OK:
                return None  # indeterminate read: no effect, droppable
            if comp.value is None:
                return None  # unknown return: unconstrained, droppable
            return (F_READ, intern_value(interner, comp.value), NIL)
        if f == "write":
            return (F_WRITE, intern_value(interner, inv.value), NIL)
        if f == "cas" and allow_cas:
            old, new = inv.value
            return (
                F_CAS,
                intern_value(interner, old),
                intern_value(interner, new),
            )
        raise ValueError(f"register model can't encode op f {f!r}")

    def py_step(state, f, a0, a1):
        s = state[0]
        if f == F_READ:
            return state, s == a0
        if f == F_WRITE:
            return (a0,), True
        return (a1,), s == a0  # cas

    def torch_step(states, f, a0, a1):
        new, legal = _register_step(states[:, 0], f, a0, a1)
        return new[:, None], legal

    def torch_step_rows(states, f, a0, a1):
        # Lane-major (1, B): the single row IS the register.
        new, legal = _register_step(states[0], f, a0, a1)
        return new[None, :], legal

    def describe_op(f: int, a0: int, a1: int) -> str:
        if f == F_READ:
            return f"read -> {interner.value(a0)!r}"
        if f == F_WRITE:
            return f"write {interner.value(a0)!r}"
        return f"cas {interner.value(a0)!r} -> {interner.value(a1)!r}"

    def refute_view(packed):
        from ..checker.refute import RefuteView

        f = packed.f
        return RefuteView(
            key=np.zeros(packed.n, dtype=np.int32),
            # reads assert the returned value; ok cas asserts the
            # expected old value at its linearization point
            asserts=np.where(f == F_READ, packed.a0,
                             np.where(f == F_CAS, packed.a0, NIL)),
            # writes force their value; an :ok cas's new value is a
            # forced effect (it returned success)
            produces=np.where(f == F_WRITE, packed.a0,
                              np.where(f == F_CAS, packed.a1, NIL)),
            init=np.array(init, dtype=np.int32),
        )

    return PackedModel(
        name="cas-register" if allow_cas else "register",
        state_width=1,
        init_state=init,
        encode=encode,
        py_step=py_step,
        torch_step=torch_step,
        torch_step_rows=torch_step_rows,
        interner=interner,
        kernel_model=KERNEL_REGISTER,
        describe_op=describe_op,
        refute_view=refute_view,
    )


def register(value: Any = None) -> Register:
    return Register(value)


def cas_register(value: Any = None) -> CASRegister:
    return CASRegister(value)
