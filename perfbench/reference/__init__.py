"""The plain reference: an exact linearizability decider for cas-register
histories, in plain Python.

It decides knossos's `cas-register` model, the one the configurations
name: a write always succeeds and sets the value; a cas `(old, new)`
succeeds iff the value is `old` and sets `new`; a read must return the
value, but a read that returns nil is unconstrained (knossos reads a
nil return as "unknown").  The initial value is nil.  A :fail op never
took effect and is dropped.  An op completed :info, or never completed,
may have taken effect at any instant after its invocation, or never.

The search.  Events are taken in history order.  A configuration,
between two completions, is (the register's value, the set of ops still
open that are already linearized, how many :info ops of each effect
have been spent).  At an :ok completion of `a` not yet linearized, the
configuration must linearize `a` now, after any number of other open
ops, each of which may be preceded by a chain of :info ops that brings
the value to what it needs.  That move set is complete: in any
linearization an :info op whose effect no later op observes can be
dropped, and one whose effect is observed stands right before its
observer (nothing between them can read or set the value without
observing or overwriting it), so it belongs to that observer's chain;
chains that revisit a value are dominated by the shorter chain, as are
configurations that spend more :info ops of each effect.  The history
is linearizable iff some path of moves passes every completion: a
depth-first search over configurations, memoized, tries the cheapest
move first.

Nothing here imports the port, JAX or `jepsen_tpu`: the records it
takes are the harness's (see `perfbench/generate.py`).
"""

from __future__ import annotations

import time
from bisect import bisect_left
from collections import defaultdict
from typing import Any, Iterator, Optional

#: The initial value of the register: nil.
INIT = None


class Undecided(RuntimeError):
    """The search ran past its deadline."""


def _rows(records: list) -> list:
    """(invocation position, completion position or None, f, value) of
    every op that can matter: :fail ops, reads that never completed :ok
    and :ok reads of nil are dropped."""
    open_: dict = {}
    rows = []
    for pos, (_, p, typ, f, v) in enumerate(records):
        if typ == "invoke":
            if p in open_:  # its last op never completed
                i, f0, v0 = open_.pop(p)
                rows.append((i, None, f0, v0))
            open_[p] = (pos, f, v)
            continue
        if p not in open_:
            continue
        i, f0, v0 = open_.pop(p)
        if typ == "ok":
            rows.append((i, pos, f0, v if f0 == "read" else v0))
        elif typ == "info":
            rows.append((i, None, f0, v0))
    rows += [(i, None, f0, v0) for i, f0, v0 in open_.values()]
    return [r for r in rows
            if r[2] != "read" or (r[1] is not None and r[3] is not None)]


class _Search:
    """One key's history, laid out for the search."""

    def __init__(self, records: list):
        rows = _rows(records)
        self.pre: list = []   # the value an :ok op needs before it (None: any)
        self.post: list = []  # (f, value) of each :ok op
        ok_rows = [r for r in rows if r[1] is not None]
        ok_rows.sort(key=lambda r: r[0])
        for _, _, f, v in ok_rows:
            self.post.append((f, v))
        # Completions in history order, each with the :ok ops open then.
        rets = sorted((r[1], i) for i, r in enumerate(ok_rows))
        self.ret_pos = [pos for pos, _ in rets]
        self.ret_op = [i for _, i in rets]
        events = sorted([(r[0], 0, i) for i, r in enumerate(ok_rows)]
                        + [(r[1], 1, i) for i, r in enumerate(ok_rows)])
        live: set = set()
        self.open_at: list = []
        for _, kind, i in events:
            if kind == 0:
                live.add(i)
            else:
                live.discard(i)
                self.open_at.append(tuple(sorted(live)))
        # :info effects: ("write", v) or ("cas", old, new), each with the
        # invocation positions of its ops.
        info = defaultdict(list)
        for inv, ret, f, v in rows:
            if ret is None:
                info[("write", v) if f == "write" else ("cas",) + tuple(v)
                     ].append(inv)
        self.kinds = sorted(info, key=repr)
        self.kind_inv = [sorted(info[k]) for k in self.kinds]

    def _avail(self, j: int) -> list:
        """:info ops of each effect invoked before completion j."""
        pos = self.ret_pos[j]
        return [bisect_left(inv, pos) for inv in self.kind_inv]

    def _chains(self, j: int, avail: list, state: Any, need: Any,
                spent: tuple) -> Iterator[tuple]:
        """(value, spent) after each chain of :info ops that takes the
        value from `state` to `need`, shortest first, never revisiting
        a value."""
        if state == need:
            yield state, spent
            return
        kinds = self.kinds
        paths = [(state, spent, (state,))]
        while paths:
            nxt = []
            for s, sp, seen in paths:
                for t, kind in enumerate(kinds):
                    if sp[t] >= avail[t]:
                        continue
                    if kind[0] == "write":
                        to = kind[1]
                    elif kind[1] == s:
                        to = kind[2]
                    else:
                        continue
                    if to in seen:
                        continue
                    sp2 = sp[:t] + (sp[t] + 1,) + sp[t + 1:]
                    if to == need:
                        yield to, sp2
                    else:
                        nxt.append((to, sp2, seen + (to,)))
            paths = nxt

    def _moves(self, j: int, state: Any, lin: frozenset,
               spent: tuple) -> Iterator[tuple]:
        """Every configuration after completion j, cheapest first."""
        a = self.ret_op[j]
        if a in lin:
            yield state, lin - {a}, spent
            return
        post, avail = self.post, None
        seen = {(state, lin, spent)}
        level = [(state, lin, spent)]
        while level:
            nxt = []
            for s, ln, sp in level:
                for x in (a,) + tuple(o for o in self.open_at[j]
                                      if o not in ln):
                    f, v = post[x]
                    need = v if f == "read" else v[0] if f == "cas" else s
                    if need != s and avail is None:
                        avail = self._avail(j)
                    for s2, sp2 in (self._chains(j, avail, s, need, sp)
                                    if need != s else ((s, sp),)):
                        after = v if f == "write" else v[1] if f == "cas" \
                            else s2
                        if x == a:
                            yield after, ln, sp2
                        else:
                            node = (after, ln | {x}, sp2)
                            if node not in seen:
                                seen.add(node)
                                nxt.append(node)
            level = nxt

    def decide(self, deadline: Optional[float] = None) -> bool:
        n = len(self.ret_op)
        if n == 0:
            return True
        start = (INIT, frozenset(), (0,) * len(self.kinds))
        visited = {(0,) + start}
        stack = [self._moves(0, *start)]
        steps = 0
        while stack:
            nxt = next(stack[-1], None)
            if nxt is None:
                stack.pop()
                continue
            j = len(stack)
            if j == n:
                return True
            key = (j,) + nxt
            if key in visited:
                continue
            visited.add(key)
            steps += 1
            if deadline is not None and not steps & 0xFFF \
                    and time.monotonic() > deadline:
                raise Undecided(f"no verdict after {steps} configurations")
            stack.append(self._moves(j, *nxt))
        return False


def decide(records: list, deadline: Optional[float] = None) -> bool:
    """Whether one key's history is linearizable (records of
    `perfbench/generate.py`; their keys are not read).  Raises
    Undecided past `deadline` (a `time.monotonic()` instant)."""
    return _Search(records).decide(deadline)


def split_keys(records: list) -> dict:
    """Each key's records, keys in first-seen order
    (`jepsen.independent`'s subhistories)."""
    out: dict = {}
    for r in records:
        out.setdefault(r[0], []).append(r)
    return out


def decide_keys(records: list, deadline: Optional[float] = None) -> dict:
    """{key: linearizable} of every key of a history."""
    return {k: decide(rs, deadline) for k, rs in split_keys(records).items()}
