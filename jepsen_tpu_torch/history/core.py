"""Operations and histories — the port's copy of
`jepsen_tpu/history/core.py`, trimmed to what history generation,
packing, the Elle analyses and a test run need: the `Op` record with
its completion helpers, the op types and the nemesis process, a
dense-indexed `History` sequence with invoke/completion pairing and
its filtered views, the terse constructors (`invoke`, `ok`, ...,
`parse_literal`), and the op-dict form (`Op.to_dict` / `Op.from_dict`,
`History.to_dicts`) the checker daemon's wire, its queue journal and
the store carry.  Folds wait for the slices that use them.
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

#: The nemesis's logical process.
NEMESIS = "nemesis"

#: Sentinel for Op.complete: keep the invocation's value.
_KEEP = object()


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

    @property
    def error(self) -> Any:
        return self.ext.get("error")

    def replace(self, *, type: Any = _KEEP, f: Any = _KEEP,
                value: Any = _KEEP, process: Any = _KEEP,
                time: Any = _KEEP, index: Any = _KEEP,
                ext: Any = _KEEP) -> "Op":
        # Named sentinels, not **kw: the interpreter calls this three
        # times per executed op.
        return Op(
            type=self.type if type is _KEEP else type,
            f=self.f if f is _KEEP else f,
            value=self.value if value is _KEEP else value,
            process=self.process if process is _KEEP else process,
            time=self.time if time is _KEEP else time,
            index=self.index if index is _KEEP else index,
            ext=self.ext if ext is _KEEP else ext,
        )

    def complete(self, type: str, value: Any = _KEEP, **ext: Any) -> "Op":
        """The completion of this invocation: same process and f, a new
        type, optionally a new value and extra keys (error=...); time
        and index are left for the interpreter to fill."""
        new_ext = dict(self.ext)
        new_ext.update(ext)
        return self.replace(type=type,
                            value=self.value if value is _KEEP else value,
                            time=-1, index=-1, ext=new_ext)

    def to_dict(self) -> dict[str, Any]:
        """The op as a flat dict, extra keys beside the fields."""
        d = {"index": self.index, "time": self.time, "type": self.type,
             "process": self.process, "f": self.f, "value": self.value}
        d.update(self.ext)
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Op":
        ext = {k: v for k, v in d.items()
               if k not in ("index", "time", "type", "process", "f",
                            "value")}
        return cls(type=d["type"], f=d.get("f"), value=d.get("value"),
                   process=d.get("process"), time=d.get("time", -1),
                   index=d.get("index", -1), ext=ext)

    def __str__(self) -> str:
        return (f"{self.index}\t{self.process}\t{self.type}\t{self.f}\t"
                f"{self.value!r}" + (f"\t{self.ext}" if self.ext else ""))


def op(type: str, f: Any = None, value: Any = None, process: Any = None,
       **ext: Any) -> Op:
    """Terse Op constructor for tests and literal histories."""
    return Op(type=type, f=f, value=value, process=process, ext=ext)


def invoke(f: Any = None, value: Any = None, process: Any = 0,
           **ext: Any) -> Op:
    return op(INVOKE, f, value, process, **ext)


def ok(f: Any = None, value: Any = None, process: Any = 0, **ext: Any) -> Op:
    return op(OK, f, value, process, **ext)


def fail(f: Any = None, value: Any = None, process: Any = 0,
         **ext: Any) -> Op:
    return op(FAIL, f, value, process, **ext)


def info(f: Any = None, value: Any = None, process: Any = 0,
         **ext: Any) -> Op:
    return op(INFO, f, value, process, **ext)


class History(Sequence[Op]):
    """An immutable sequence of Ops with dense indices.  Indices are
    (re)assigned densely unless the ops already carry them, and missing
    times are filled from indices.  The pairing of invocations with
    completions is computed on first use (the packers never need it)."""

    __slots__ = ("ops", "_pairs")

    def __init__(self, ops: Iterable["Op | dict"], *,
                 reindex: bool | None = None):
        rows = [o if isinstance(o, Op) else Op.from_dict(o) for o in ops]
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

    def to_dicts(self) -> list[dict[str, Any]]:
        return [o.to_dict() for o in self.ops]

    def __eq__(self, other: object) -> bool:
        if isinstance(other, History):
            return self.ops == other.ops
        if isinstance(other, (list, tuple)):
            return list(self.ops) == list(other)
        return NotImplemented

    __hash__ = None  # type: ignore[assignment]

    def __repr__(self) -> str:
        return f"History({len(self.ops)} ops)"


def history(ops: Iterable[Op], **kw: Any) -> History:
    return History(ops, **kw)


def parse_literal(rows: Iterable[tuple]) -> History:
    """A history from terse (process, type, f, value) tuples."""
    return History([Op(type=t, f=f, value=v, process=p)
                    for p, t, f, v in rows])
