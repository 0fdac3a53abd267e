"""The port's stock checkers (jepsen_tpu_torch/checker/core.py) and
timeline against the JAX package's: every case of tests/test_checkers.py
through the port, and seeded histories through both packages' checkers
giving equal results."""

import random

import pytest

import jepsen_tpu.checker as rchk
import jepsen_tpu.checker.timeline as rtl
import jepsen_tpu.history as rh
import jepsen_tpu_torch.checker as pchk
import jepsen_tpu_torch.checker.timeline as ptl
import jepsen_tpu_torch.history as ph
import torch_ported

PORTED = torch_ported.load("test_checkers")


@pytest.mark.parametrize("case", torch_ported.cases(PORTED))
def test_checker_cases_through_the_port(case, request):
    torch_ported.run(PORTED, case, request)


def _rows(kind, seed):
    """(process, type, f, value) rows of a seeded concurrent history of
    `kind`: set adds and reads, counter adds and reads, queue enqueues
    and dequeues, with :info and :fail completions mixed in, some
    values lost or duplicated."""
    rng = random.Random(seed)
    rows, added, total = [], [], 0
    for i in range(120):
        p = rng.randrange(4)
        r = rng.random()
        kind_f = {"set": ("add", "read"), "counter": ("add", "read"),
                  "queue": ("enqueue", "dequeue")}[kind]
        if r < 0.6:
            v = i if kind != "counter" else rng.randrange(1, 4)
            t = rng.choice(["ok"] * 8 + ["info", "fail"])
            rows += [(p, "invoke", kind_f[0], v), (p, t, kind_f[0], v)]
            if t != "fail":
                added.append(v)
                total += v if kind == "counter" else 0
        elif kind == "queue":
            v = added.pop(0) if added and rng.random() < 0.9 else 999
            rows += [(p, "invoke", "dequeue", None), (p, "ok", "dequeue", v)]
        else:
            seen = (sorted(a for a in added if rng.random() < 0.97)
                    if kind == "set" else total + rng.choice([0, 0, 1]))
            rows += [(p, "invoke", "read", None), (p, "ok", "read", seen)]
    return rows


def _checkers(chk):
    return {"stats": chk.Stats(), "exceptions": chk.UnhandledExceptions(),
            "set": chk.SetChecker(), "set-full": chk.SetFull(),
            "counter": chk.CounterChecker(), "queue": chk.TotalQueue(),
            "unique": chk.UniqueIds()}


def _norm(x):
    """A result as comparable plain data: keys by repr, a traceback
    (whose file paths name the package) left out."""
    if isinstance(x, dict):
        return {repr(k): _norm(v) for k, v in x.items() if k != "traceback"}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(repr(v) for v in x)
    return x


@pytest.mark.parametrize("kind", ["set", "counter", "queue"])
@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(_checkers(pchk)))
def test_stock_checkers_equal_the_reference(kind, seed, name):
    rows = _rows(kind, seed)
    want = rchk.check_safe(_checkers(rchk)[name], {},
                           rh.parse_literal(rows), {})
    got = pchk.check_safe(_checkers(pchk)[name], {},
                          ph.parse_literal(rows), {})
    assert _norm(got) == _norm(want)


def test_compose_equals_the_reference():
    rows = _rows("set", 9)
    want = rchk.compose(_checkers(rchk)).check({}, rh.parse_literal(rows), {})
    got = pchk.compose(_checkers(pchk)).check({}, ph.parse_literal(rows), {})
    assert _norm(got) == _norm(want)


def test_compose_raises_a_device_fault():
    """A child's device fault leaves the compose as it leaves
    check_safe: raised, not an "unknown" entry."""
    from jepsen_tpu_torch.device import DeviceUnavailable

    class Dead(pchk.Checker):
        def check(self, test, history, opts):
            raise DeviceUnavailable("no card")

    with pytest.raises(DeviceUnavailable):
        pchk.compose({"ok": pchk.Stats(), "dead": Dead()}).check(
            {}, ph.parse_literal(_rows("set", 1)), {})


def test_timeline_writes_the_same_page(tmp_path):
    rows = _rows("queue", 4)
    outs = []
    for tl, h, sub in ((rtl, rh, "ref"), (ptl, ph, "port")):
        d = tmp_path / sub
        d.mkdir()
        res = tl.html_checker().check({"name": "t"}, h.parse_literal(rows),
                              {"dir": str(d)})
        res["file"] = res["file"].replace(str(d), "<dir>")
        outs.append((res, sorted(p.name for p in d.iterdir()),
                     [p.read_text() for p in sorted(d.iterdir())]))
    assert outs[0] == outs[1]
