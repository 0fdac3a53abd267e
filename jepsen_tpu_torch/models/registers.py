"""Register-family models: register, cas-register, multi-register.

The port's copy of `jepsen_tpu/models/registers.py`.  A read of `nil`
is unconstrained (unknown return), reads must otherwise match the
current value, writes always succeed, cas succeeds iff the old value
matches.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..history.core import OK, Op
from ..history.packed import NIL, Interner
from .base import Model, PackedModel, inconsistent, intern_value

F_READ, F_WRITE, F_CAS = 0, 1, 2

#: `PackedModel.kernel_model` ids of the register steps compiled into
#: the witness sweep kernel (csrc/witness_sweep.cu MODEL_REGISTER,
#: MODEL_MULTI_REGISTER).
KERNEL_REGISTER = 1
KERNEL_MULTI_REGISTER = 3


class Register(Model):
    """A single read/write register."""

    fs = ("read", "write")

    def __init__(self, value: Any = None):
        self.value = value

    def step(self, op: Op):
        if op.f == "read":
            if op.value is None or op.value == self.value:
                return self
            return inconsistent(
                f"read {op.value!r} but register held {self.value!r}")
        if op.f == "write":
            return type(self)(op.value)
        return inconsistent(f"unknown op f {op.f!r}")

    def __eq__(self, other):
        return type(other) is type(self) and other.value == self.value

    def __hash__(self):
        return hash((type(self).__name__, self.value))

    def __repr__(self):
        return f"{type(self).__name__}({self.value!r})"

    def _compile_packed(self) -> PackedModel:
        return _register_packed(self, allow_cas=False)


class CASRegister(Register):
    """A register with read/write/compare-and-set."""

    fs = ("read", "write", "cas")

    def step(self, op: Op):
        if op.f == "cas":
            old, new = op.value
            if self.value == old:
                return CASRegister(new)
            return inconsistent(
                f"cas from {old!r} but register held {self.value!r}")
        return super().step(op)

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

    def encode_many(items):
        # encode() over a [(inv, comp)] batch for PackedBuilder.
        # append_many, with the interner inlined: the same drops, the
        # same interner and the same codes as encode().
        ids = interner._ids
        vals = interner.values
        out = []
        add = out.append

        def code(v):
            if isinstance(v, list):
                v = tuple(v)
            i = ids.get(v)
            if i is None:
                i = len(vals)
                ids[v] = i
                vals.append(v)
            return i

        for inv, comp in items:
            f = inv.f
            if f == "read":
                if comp is None or comp.type != OK or comp.value is None:
                    add(None)
                else:
                    add((F_READ, code(comp.value), NIL))
            elif f == "write":
                add((F_WRITE, code(inv.value), NIL))
            elif f == "cas" and allow_cas:
                old, new = inv.value
                i0 = code(old)
                add((F_CAS, i0, code(new)))
            else:
                raise ValueError(f"register model can't encode op f {f!r}")
        return out

    encode.many = encode_many

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


class MultiRegister(Model):
    """A fixed set of named registers; ops read/write a single (k, v)
    pair (knossos.model/multi-register restricted to unit txns).  The
    packed state is one word per register, in the order of `values`;
    an op packs to (f, key index, value code)."""

    def __init__(self, values: dict[Any, Any]):
        self.values = dict(values)

    def step(self, op: Op):
        k, v = op.value
        if k not in self.values:
            return inconsistent(f"no such register {k!r}")
        if op.f == "read":
            if v is None or self.values[k] == v:
                return self
            return inconsistent(
                f"read {v!r} from {k!r} which held {self.values[k]!r}")
        if op.f == "write":
            nv = dict(self.values)
            nv[k] = v
            return MultiRegister(nv)
        return inconsistent(f"unknown op f {op.f!r}")

    def __eq__(self, other):
        return type(other) is MultiRegister and other.values == self.values

    def __hash__(self):
        return hash(tuple(sorted(self.values.items(), key=repr)))

    def __repr__(self):
        return f"MultiRegister({self.values!r})"

    def _compile_packed(self) -> PackedModel:
        interner = Interner()
        interner.intern(None)
        keys = list(self.values.keys())
        key_idx = {k: i for i, k in enumerate(keys)}
        init = tuple(intern_value(interner, self.values[k]) for k in keys)

        def encode(inv: Op, comp: Optional[Op]):
            if inv.f == "read":
                if comp is None or comp.type != OK:
                    return None
                k, v = comp.value
                if v is None:
                    return None
                return (F_READ, key_idx[k], intern_value(interner, v))
            if inv.f == "write":
                k, v = inv.value
                return (F_WRITE, key_idx[k], intern_value(interner, v))
            raise ValueError(f"multi-register can't encode op f {inv.f!r}")

        def py_step(state, f, a0, a1):
            if f == F_READ:
                return state, state[a0] == a1
            s = list(state)
            s[a0] = a1
            return tuple(s), True

        def torch_step(states, f, a0, a1):
            # (N, SW) rows; a0 is a key index in [0, SW).
            n = states.shape[0]
            idx = torch.as_tensor(a0, dtype=torch.int64,
                                  device=states.device).expand(n)
            cur = states.gather(1, idx[:, None])[:, 0]
            is_write = torch.as_tensor(f, device=states.device) == F_WRITE
            legal = is_write | (cur == a1)
            new = torch.where(is_write, torch.as_tensor(
                a1, dtype=torch.int32, device=states.device), cur)
            out = states.clone()
            out.scatter_(1, idx[:, None], new.expand(n)[:, None]
                         .to(torch.int32))
            return out, legal.expand(n)

        def torch_step_rows(states, f, a0, a1):
            # Lane-major (SW, B), scatter-free: the key's row is picked
            # by mask, so an a0 outside [0, SW) reads 0 and writes
            # nothing.
            nk = states.shape[0]
            key_mask = torch.arange(nk, device=states.device)[:, None] == a0
            cur = torch.where(key_mask, states, 0).sum(dim=0).to(torch.int32)
            is_write = f == F_WRITE
            legal = (cur == a1) | is_write
            out = torch.where(key_mask & is_write, a1, states)
            return out.to(torch.int32), legal

        def describe_op(f: int, a0: int, a1: int) -> str:
            verb = "read" if f == F_READ else "write"
            return f"{verb} {keys[a0]!r} {interner.value(a1)!r}"

        def refute_view(packed):
            from ..checker.refute import RefuteView

            f = packed.f
            return RefuteView(
                key=packed.a0.astype(np.int32),
                asserts=np.where(f == F_READ, packed.a1, NIL),
                produces=np.where(f == F_WRITE, packed.a1, NIL),
                init=np.array(init, dtype=np.int32),
            )

        return PackedModel(
            name="multi-register",
            state_width=len(keys),
            init_state=init,
            encode=encode,
            py_step=py_step,
            torch_step=torch_step,
            torch_step_rows=torch_step_rows,
            interner=interner,
            kernel_model=KERNEL_MULTI_REGISTER,
            describe_op=describe_op,
            refute_view=refute_view,
        )


def register(value: Any = None) -> Register:
    return Register(value)


def cas_register(value: Any = None) -> CASRegister:
    return CASRegister(value)


def multi_register(values: dict[Any, Any]) -> MultiRegister:
    return MultiRegister(values)
