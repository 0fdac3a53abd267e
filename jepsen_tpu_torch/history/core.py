"""Operations and histories — the port's copy of
`jepsen_tpu/history/core.py`, trimmed to what history generation and
packing need: the `Op` record, the op types, and a dense-indexed
`History` sequence.  Pairing, filtered views and folds wait for the
slices that use them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator, Sequence

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
    times are filled from indices."""

    __slots__ = ("ops",)

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
