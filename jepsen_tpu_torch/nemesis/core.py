"""Nemesis protocol and its combinators.

The port's copy of `jepsen_tpu/nemesis/core.py`, trimmed to the
`Nemesis` protocol, `noop`, and the combinators `compose`, `f_map` and
`timeout`; the partitioners and the faults that shell into nodes wait
for the remotes that reach real nodes.
"""

from __future__ import annotations

import logging
from typing import Any, Mapping

from ..history import Op
from ..utils import JepsenTimeout, timeout as run_timeout

log = logging.getLogger(__name__)


class Nemesis:
    """A special process that injects faults (nemesis.clj:12-17)."""

    def setup(self, test: dict) -> "Nemesis":
        return self

    def invoke(self, test: dict, op: Op) -> Op:
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        pass

    def fs(self) -> set:
        """The :f values this nemesis handles (Reflection, :19-22)."""
        return set()


class NoopNemesis(Nemesis):
    """Does nothing (nemesis.clj:24-30)."""

    def invoke(self, test: dict, op: Op) -> Op:
        return op

    def fs(self) -> set:
        return set()


noop = NoopNemesis()


# ---------------------------------------------------------------------------
# Combinators
# ---------------------------------------------------------------------------


class FMap(Nemesis):
    """Remaps the :f values a nemesis sees: `fmap` is {outer-f: inner-f};
    ops are translated on the way in and back on the way out
    (nemesis.clj:303-328)."""

    def __init__(self, fmap: Mapping[Any, Any], nem: Nemesis):
        self.fmap = dict(fmap)
        self.inv = {v: k for k, v in self.fmap.items()}
        self.nem = nem

    def setup(self, test: dict) -> "FMap":
        return FMap(self.fmap, self.nem.setup(test))

    def invoke(self, test: dict, op: Op) -> Op:
        inner = op.replace(f=self.fmap[op.f])
        out = self.nem.invoke(test, inner)
        return out.replace(f=self.inv[out.f])

    def teardown(self, test: dict) -> None:
        self.nem.teardown(test)

    def fs(self) -> set:
        return set(self.fmap.keys())


def f_map(fmap: Mapping[Any, Any], nem: Nemesis) -> FMap:
    return FMap(fmap, nem)


class NemesisTeardownError(Exception):
    """Aggregate of per-child Compose teardown failures: every child got
    its teardown attempt; these are the ones that failed."""

    def __init__(self, failures: list[tuple["Nemesis", BaseException]]):
        self.failures = failures
        super().__init__(
            "nemesis teardown failed for "
            + "; ".join(
                f"{type(nem).__name__}: {type(e).__name__}: {e}"
                for nem, e in failures
            )
        )


class Compose(Nemesis):
    """Routes ops to one of several nemeses by :f (nemesis.clj:385-429).
    Takes a plain list of nemeses (fs taken from Reflection) or a list
    of (fs, nemesis) pairs, where fs is a collection of f values or an
    {outer-f: inner-f} remapping (the reference's fmap-key form —
    expressed as pairs here since dicts can't key a Python dict)."""

    def __init__(self, nemeses: Any):
        entries = []
        for item in nemeses:
            if (
                isinstance(item, tuple)
                and len(item) == 2
                and not isinstance(item[0], Nemesis)
            ):
                fs, nem = item
                if isinstance(fs, Mapping):
                    entries.append((set(fs.keys()), f_map(fs, nem)))
                else:
                    entries.append((set(fs), nem))
            else:
                entries.append((set(item.fs()), item))
        seen: set = set()
        for fs, _ in entries:
            dup = seen & fs
            if dup:
                raise ValueError(f"multiple nemeses claim fs {sorted(dup)}")
            seen |= fs
        self.entries = entries

    @classmethod
    def _from_entries(cls, entries: list) -> "Compose":
        self = cls([])
        self.entries = entries
        return self

    def _route(self, f: Any) -> Nemesis:
        for fs, nem in self.entries:
            if f in fs:
                return nem
        raise ValueError(f"no nemesis handles f {f!r}")

    def setup(self, test: dict) -> "Compose":
        return Compose._from_entries(
            [(fs, nem.setup(test)) for fs, nem in self.entries]
        )

    def invoke(self, test: dict, op: Op) -> Op:
        return self._route(op.f).invoke(test, op)

    def teardown(self, test: dict) -> None:
        # One failing child must not strand its siblings' faults: every
        # child gets its teardown attempt, then the failures surface as
        # one aggregate.
        failures: list[tuple[Nemesis, BaseException]] = []
        for _, nem in self.entries:
            try:
                nem.teardown(test)
            except Exception as e:  # noqa: BLE001 — aggregated below
                log.warning(
                    "nemesis %s teardown failed: %r", type(nem).__name__, e
                )
                failures.append((nem, e))
        if failures:
            raise NemesisTeardownError(failures)

    def fs(self) -> set:
        out: set = set()
        for fs, _ in self.entries:
            out |= fs
        return out


def compose(nemeses: Any) -> Compose:
    return Compose(nemeses)


class Timeout(Nemesis):
    """Bounds nemesis invocations at `ms`; on expiry the op completes
    with an error note and the fault thread keeps running
    (nemesis.clj:430-434 analog of client/Timeout)."""

    def __init__(self, ms: float, nem: Nemesis):
        self.ms = ms
        self.nem = nem

    def setup(self, test: dict) -> "Timeout":
        return Timeout(self.ms, self.nem.setup(test))

    def invoke(self, test: dict, op: Op) -> Op:
        try:
            return run_timeout(self.ms, lambda: self.nem.invoke(test, op))
        except JepsenTimeout:
            return op.replace(value="nemesis timeout")

    def teardown(self, test: dict) -> None:
        self.nem.teardown(test)

    def fs(self) -> set:
        return self.nem.fs()


def timeout(ms: float, nem: Nemesis) -> Timeout:
    return Timeout(ms, nem)
