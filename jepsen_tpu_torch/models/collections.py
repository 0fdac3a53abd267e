"""Collection models: set, unordered queue, FIFO queue.

The port's copy of `jepsen_tpu/models/collections.py`.  The host
models carry unbounded Python collections.  UnorderedQueue and
FIFOQueue also have bounded packed int32 forms of `packed_capacity`
slots (0 = empty), gated by `validate_packed`; SetModel has none, so
`packed()` raises and the linearizable checker takes the host-model
search.
"""

from __future__ import annotations

from typing import Any, FrozenSet, Tuple

import torch

from ..history.core import OK, Op
from ..history.packed import NIL, Interner
from .base import Model, PackedModel, inconsistent, intern_value

F_ENQ, F_DEQ = 0, 1

#: `PackedModel.kernel_model` ids of the queue steps compiled into the
#: witness sweep kernel (csrc/witness_sweep.cu MODEL_FIFO_QUEUE,
#: MODEL_UNORDERED_QUEUE).
KERNEL_FIFO_QUEUE = 4
KERNEL_UNORDERED_QUEUE = 5


def _freeze(v: Any) -> Any:
    if isinstance(v, list):
        return tuple(v)
    if isinstance(v, set):
        return frozenset(v)
    return v


class SetModel(Model):
    """A grow-only set: `add` elements, `read` the full contents."""

    def __init__(self, items: FrozenSet[Any] = frozenset()):
        self.items = frozenset(items)

    def step(self, op: Op):
        if op.f == "add":
            return SetModel(self.items | {_freeze(op.value)})
        if op.f == "read":
            if op.value is None:
                return self
            got = frozenset(_freeze(x) for x in op.value)
            if got == self.items:
                return self
            return inconsistent(
                f"read {sorted(map(repr, got))} but set contained "
                f"{sorted(map(repr, self.items))}")
        return inconsistent(f"unknown op f {op.f!r}")

    def __eq__(self, other):
        return type(other) is SetModel and other.items == self.items

    def __hash__(self):
        return hash(("SetModel", self.items))

    def __repr__(self):
        return f"SetModel({sorted(map(repr, self.items))})"


class UnorderedQueue(Model):
    """A queue where dequeue may return any enqueued-but-not-dequeued
    element (knossos.model/unordered-queue).

    Device form: a bounded multiset of `packed_capacity` int32 slots
    (0 = empty).  It is exact only when the history can never hold more
    than capacity elements; `validate_packed` checks a sound upper bound
    (enqueues invoked so far minus dequeues completed so far, maxed over
    the walk).  Indeterminate dequeues have no deterministic packed
    transition, so packing such histories raises; both send the checker
    to the host model."""

    packed_capacity = 32

    def __init__(self, pending: Tuple[Any, ...] = ()):
        self.pending = tuple(pending)

    def step(self, op: Op):
        v = _freeze(op.value)
        if op.f == "enqueue":
            return UnorderedQueue(self.pending + (v,))
        if op.f == "dequeue":
            if v in self.pending:
                i = self.pending.index(v)
                return UnorderedQueue(self.pending[:i] + self.pending[i + 1:])
            return inconsistent(f"can't dequeue {v!r}: not in queue")
        return inconsistent(f"unknown op f {op.f!r}")

    def __eq__(self, other):
        return type(other) is UnorderedQueue and sorted(
            map(repr, other.pending)) == sorted(map(repr, self.pending))

    def __hash__(self):
        return hash(("UnorderedQueue", tuple(sorted(map(repr, self.pending)))))

    def __repr__(self):
        return f"UnorderedQueue({list(self.pending)!r})"

    def _compile_packed(self):
        return _queue_packed(self.pending, self.packed_capacity, fifo=False)


class FIFOQueue(Model):
    """A strict FIFO queue: dequeue must return the head.  Device form:
    left-aligned bounded slots with the same capacity and indeterminate
    gates as UnorderedQueue."""

    packed_capacity = 32

    def __init__(self, items: Tuple[Any, ...] = ()):
        self.items = tuple(items)

    def step(self, op: Op):
        v = _freeze(op.value)
        if op.f == "enqueue":
            return FIFOQueue(self.items + (v,))
        if op.f == "dequeue":
            if not self.items:
                return inconsistent(f"can't dequeue {v!r} from empty queue")
            if self.items[0] == v:
                return FIFOQueue(self.items[1:])
            return inconsistent(
                f"dequeued {v!r} but head was {self.items[0]!r}")
        return inconsistent(f"unknown op f {op.f!r}")

    def __eq__(self, other):
        return type(other) is FIFOQueue and other.items == self.items

    def __hash__(self):
        return hash(("FIFOQueue", self.items))

    def __repr__(self):
        return f"FIFOQueue({list(self.items)!r})"

    def _compile_packed(self):
        return _queue_packed(self.items, self.packed_capacity, fifo=True)


def _first(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """The first True of `mask` along `dim`, as a mask."""
    return (torch.cumsum(mask.to(torch.int32), dim) == 1) & mask


def _queue_packed(initial, capacity: int, *, fifo: bool) -> PackedModel:
    """The bounded queues' packed form: `capacity` int32 slots, 0 =
    empty, a value's code = its interned id + 1.  The unordered
    `torch_step` keeps the multiset sorted, for the search's dedup;
    FIFO keeps insertion order left-aligned."""
    C = capacity
    initial = tuple(initial)
    if len(initial) > C:
        raise NotImplementedError("initial queue exceeds capacity")
    interner = Interner()
    interner.intern(None)  # id 0 -> code 1 for None

    def code(v):
        return intern_value(interner, _freeze(v)) + 1  # 0 = empty

    def encode(inv, comp):
        if inv.f == "enqueue":
            return (F_ENQ, code(inv.value), NIL)
        if inv.f == "dequeue":
            if comp is None or comp.type != OK:
                raise ValueError("indeterminate dequeue has no packed form")
            return (F_DEQ, code(comp.value), NIL)
        raise ValueError(f"queue model can't encode f {inv.f!r}")

    codes = [code(x) for x in initial]
    if fifo:
        init_state = tuple(codes + [0] * (C - len(codes)))
    else:
        init_state = tuple([0] * (C - len(codes)) + sorted(codes))

    def py_step(state, f, a0, a1):
        s = list(state)
        if fifo:
            if f == F_ENQ:
                if 0 not in s:
                    return state, False
                s[s.index(0)] = a0
                return tuple(s), True
            if s[0] != a0 or a0 == 0:
                return state, False
            return tuple(s[1:] + [0]), True
        if f == F_ENQ:
            if 0 not in s:
                return state, False
            s[s.index(0)] = a0
            return tuple(sorted(s)), True
        if a0 not in s:
            return state, False
        s.remove(a0)
        return tuple(sorted([0] + s)), True

    def torch_step(states, f, a0, a1):
        # (N, C) rows; f/a0 Python ints or (N,) tensors.
        n = states.shape[0]
        dev = states.device
        is_enq = (torch.as_tensor(f, device=dev) == F_ENQ).expand(n)
        a0c = torch.as_tensor(a0, dtype=torch.int32, device=dev).expand(n)
        if fifo:
            length = (states != 0).sum(dim=1)
            has_room = length < C
            enq = states.clone()
            enq.scatter_(1, length.clamp(0, C - 1)[:, None], a0c[:, None])
            head_ok = (states[:, 0] == a0c) & (a0c != 0)
            deq = torch.cat([states[:, 1:],
                             torch.zeros_like(states[:, :1])], dim=1)
            legal = torch.where(is_enq, has_room, head_ok)
            new = torch.where(
                is_enq[:, None],
                torch.where(has_room[:, None], enq, states),
                torch.where(head_ok[:, None], deq, states))
            return new, legal
        has_room = (states == 0).any(dim=1)
        enq = states.clone()
        enq.scatter_(1, states.argmin(dim=1)[:, None], a0c[:, None])
        eq = states == a0c[:, None]
        present = eq.any(dim=1)
        first = eq.to(torch.int32).argmax(dim=1)
        deq = torch.where(
            torch.arange(C, device=dev)[None, :] == first[:, None], 0, states)
        legal = torch.where(is_enq, has_room, present)
        new = torch.where(is_enq[:, None], enq,
                          torch.where(present[:, None], deq, states))
        return new.sort(dim=1).values, legal

    def torch_step_rows_fifo(states, f, a0, a1):
        # Lane-major (C, B), left-aligned: the enqueue slot is the row
        # equal to the length, so a full lane matches none and keeps
        # its state; dequeue is a one-row shift.
        is_enq = torch.as_tensor(f == F_ENQ, device=states.device)
        length = (states != 0).sum(dim=0)
        has_room = length < C
        slot = torch.arange(C, device=states.device)[:, None] == length
        enq = torch.where(slot, a0, states)
        head_ok = (states[0] == a0) & (a0 != 0)
        deq = torch.cat([states[1:], torch.zeros_like(states[:1])], dim=0)
        legal = torch.where(is_enq, has_room, head_ok)
        new = torch.where(is_enq, enq,
                          torch.where(head_ok[None, :], deq, states))
        return new, legal

    def torch_step_rows_unordered(states, f, a0, a1):
        # Lane-major (C, B), unsorted: enqueue fills the first empty
        # slot, dequeue clears the first slot holding a0.  Legality is
        # order-independent, and unsorted states only pass through the
        # sweep: the chain search's dedup compares `torch_step` outputs,
        # which sort.
        is_enq = torch.as_tensor(f == F_ENQ, device=states.device)
        zero = states == 0
        has_room = zero.any(dim=0)
        enq = torch.where(_first(zero, 0), a0, states)
        match = states == a0
        present = match.any(dim=0)
        deq = torch.where(_first(match, 0), 0, states)
        legal = torch.where(is_enq, has_room, present)
        new = torch.where(is_enq, enq,
                          torch.where(present[None, :], deq, states))
        return new, legal

    def validate_packed(packed) -> "str | None":
        # Sound size bound at any linearization point t: every enqueue
        # invoked by t could be in the queue; dequeues completed by t
        # must already be linearized (removed).
        size = len(initial)
        worst = size
        events = []  # (when, +1 enqueue invoked / -1 dequeue completed)
        for i in range(packed.n):
            if packed.f[i] == F_ENQ:
                events.append((int(packed.inv[i]), 1))
            else:
                events.append((int(packed.ret[i]), -1))
        for _, delta in sorted(events):
            size += delta
            worst = max(worst, size)
        if worst > C:
            return (f"history may hold {worst} elements; packed "
                    f"capacity is {C}")
        return None

    def describe_op(f, a0, a1):
        v = interner.value(a0 - 1) if a0 > 0 else "?"
        return ("enqueue " if f == F_ENQ else "dequeue -> ") + repr(v)

    return PackedModel(
        name="fifo-queue" if fifo else "unordered-queue",
        state_width=C,
        init_state=init_state,
        encode=encode,
        py_step=py_step,
        torch_step=torch_step,
        torch_step_rows=(torch_step_rows_fifo if fifo
                         else torch_step_rows_unordered),
        interner=interner,
        kernel_model=KERNEL_FIFO_QUEUE if fifo else KERNEL_UNORDERED_QUEUE,
        describe_op=describe_op,
        validate_packed=validate_packed,
    )


def set_model() -> SetModel:
    return SetModel()


def unordered_queue() -> UnorderedQueue:
    return UnorderedQueue()


def fifo_queue() -> FIFOQueue:
    return FIFOQueue()
