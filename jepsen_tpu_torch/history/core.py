"""Operations and histories — the port's copy of
`jepsen_tpu/history/core.py`, trimmed to what history generation,
packing and the Elle analyses need: the `Op` record, the op types, a
dense-indexed `History` sequence with invoke/completion pairing, and
the filtered views `filter` and `client_ops`.  Folds and the other
views wait for the slices that use them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

# Op types (the reference uses keywords :invoke :ok :fail :info).
INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"

TYPES = (INVOKE, OK, FAIL, INFO)


@dataclass(slots=True)
class Op:
    """One history event: `index` is the dense position in the history,
    `time` nanoseconds since test start, `type` one of
    invoke/ok/fail/info, `process` an integer worker (or a non-int such
    as the nemesis), `f` the operation function, `value` its payload.
    Extra keys (e.g. :error) live in `ext`."""

    type: str
    f: Any = None
    value: Any = None
    process: Any = None
    time: int = -1
    index: int = -1
    ext: dict[str, Any] = field(default_factory=dict)

    @property
    def is_invoke(self) -> bool:
        return self.type == INVOKE

    @property
    def is_ok(self) -> bool:
        return self.type == OK

    @property
    def is_fail(self) -> bool:
        return self.type == FAIL

    @property
    def is_info(self) -> bool:
        return self.type == INFO

    @property
    def is_client_op(self) -> bool:
        """Client ops have integer processes; the nemesis doesn't."""
        return isinstance(self.process, int)

    def replace(self, **kw: Any) -> "Op":
        fields = {
            "type": self.type, "f": self.f, "value": self.value,
            "process": self.process, "time": self.time,
            "index": self.index, "ext": self.ext,
        }
        fields.update(kw)
        return Op(**fields)


class History(Sequence[Op]):
    """An immutable sequence of Ops with dense indices.  Indices are
    (re)assigned densely unless the ops already carry them, and missing
    times are filled from indices.  The pairing of invocations with
    completions is computed on first use (the packers never need it)."""

    __slots__ = ("ops", "_pairs")

    def __init__(self, ops: Iterable[Op], *, reindex: bool | None = None):
        rows = list(ops)
        if reindex is None:
            reindex = not all(o.index == i for i, o in enumerate(rows))
        if reindex:
            rows = [
                o.replace(index=i, time=(o.time if o.time >= 0 else i))
                for i, o in enumerate(rows)
            ]
        self.ops: tuple[Op, ...] = tuple(rows)
        self._pairs: Optional[tuple[dict[int, int], dict[int, int]]] = None

    # -- pairing ----------------------------------------------------------

    def _index(self) -> tuple[dict[int, int], dict[int, int]]:
        """(Op.index -> paired Op.index, Op.index -> position in
        self.ops); the two differ on filtered views, which keep the
        original indices.

        An invocation pairs with the next op on the same process (its
        completion); a client :info completion crashes the process and
        the next op of that worker comes under a fresh process, so
        same-process pairing is unambiguous.  A double invoke without a
        completion leaves the earlier op unpaired."""
        if self._pairs is None:
            pair: dict[int, int] = {}
            pending: dict[Any, int] = {}
            for o in self.ops:
                if o.is_invoke:
                    pending[o.process] = o.index
                else:
                    j = pending.pop(o.process, None)
                    if j is not None:
                        pair[j] = o.index
                        pair[o.index] = j
            by_index = {o.index: pos for pos, o in enumerate(self.ops)}
            self._pairs = (pair, by_index)
        return self._pairs

    def completion(self, o: "Op | int") -> Optional[Op]:
        """The completion op of an invocation, or None if it never
        completed.  Works on filtered views: lookups key on Op.index."""
        pair, by_index = self._index()
        i = o if isinstance(o, int) else o.index
        j = pair.get(i, -1)
        if j > i and j in by_index:
            return self.ops[by_index[j]]
        return None

    def invocation(self, o: "Op | int") -> Optional[Op]:
        """The invocation op of a completion, or None."""
        pair, by_index = self._index()
        i = o if isinstance(o, int) else o.index
        j = pair.get(i, -1)
        if 0 <= j < i and j in by_index:
            return self.ops[by_index[j]]
        return None

    def pair_index(self, i: int) -> int:
        return self._index()[0].get(i, -1)

    # -- filtered views ----------------------------------------------------

    def filter(self, pred: Callable[[Op], bool]) -> "History":
        """A new history of the ops matching `pred`.  Indices are kept,
        so pairing against the original stays meaningful via .index."""
        return History([o for o in self.ops if pred(o)], reindex=False)

    def client_ops(self) -> "History":
        return self.filter(lambda o: o.is_client_op)

    # -- sequence protocol -------------------------------------------------

    def __len__(self) -> int:
        return len(self.ops)

    def __getitem__(self, i):  # type: ignore[override]
        if isinstance(i, slice):
            return list(self.ops[i])
        return self.ops[i]

    def __iter__(self) -> Iterator[Op]:
        return iter(self.ops)

    def __repr__(self) -> str:
        return f"History({len(self.ops)} ops)"


def history(ops: Iterable[Op], **kw: Any) -> History:
    return History(ops, **kw)
