"""The history API of the port's copies (jepsen_tpu_torch/history/,
utils/histgen.py, telemetry) against the JAX package's: every case of
tests/test_history.py through the port, the cases of
tests/test_histgen_packed.py (PackedBuilder.extend) and
tests/test_refute.py (stale_read_history) that load there, and each
name's output equal to the reference's on the same seeded histories.

Left out: test_histgen_packed's `test_generation_speed_floor`, a
wall-clock floor on the generator that the reference's own file keeps;
it measures this machine's load, not the copied API."""

import numpy as np
import pytest
import torch

import jepsen_tpu.history.core as rcore
import jepsen_tpu.history.packed as rpacked
import jepsen_tpu.telemetry as rtel
import jepsen_tpu.utils.histgen as rgen
import jepsen_tpu_torch.history.core as pcore
import jepsen_tpu_torch.history.packed as ppacked
import jepsen_tpu_torch.telemetry as ptel
import jepsen_tpu_torch.utils.histgen as pgen
from jepsen_tpu.models import cas_register as rcas
from jepsen_tpu_torch.models import cas_register as pcas
import torch_ported

HISTORY = torch_ported.load("test_history")
HISTGEN = torch_ported.load("test_histgen_packed")
REFUTE = torch_ported.load("test_refute")


@pytest.fixture(autouse=True)
def _one_thread():
    """The refutation cases run the CPU device search under a checker
    budget: one torch thread, as the other such files do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pm():
    """The ported files' own `pm` fixture, which pytest does not
    collect from them."""
    return pcas().packed()


@pytest.mark.parametrize("case", torch_ported.cases(HISTORY))
def test_history_scenarios_through_the_port(case, request):
    torch_ported.run(HISTORY, case, request)


@pytest.mark.parametrize("case", torch_ported.cases(
    HISTGEN, exclude=("test_generation_speed_floor",)))
def test_histgen_packed_scenarios_through_the_port(case, request):
    torch_ported.run(HISTGEN, case, request)


@pytest.mark.parametrize("case", torch_ported.cases(REFUTE))
def test_refute_scenarios_through_the_port(case, request):
    torch_ported.run(REFUTE, case, request)


def _mixed(core, seed):
    """A seeded client and nemesis history with every completion type
    and a few double invokes."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(300):
        p = int(rng.integers(0, 5))
        f = ["read", "write", "cas"][int(rng.integers(0, 3))]
        t = ["ok", "fail", "info"][int(rng.integers(0, 3))]
        ops.append(core.Op(type="invoke", f=f, value=int(rng.integers(0, 4)),
                           process=p))
        if rng.random() < 0.9:
            ops.append(core.Op(type=t, f=f, value=int(rng.integers(0, 4)),
                               process=p, ext={"k": int(rng.integers(0, 3))}))
        if rng.random() < 0.1:
            ops.append(core.Op(type="info", f="start", value=None,
                               process=core.NEMESIS))
    return core.history(ops)


def _dicts(ops):
    return [o.to_dict() for o in ops]


VIEWS = [
    ("oks", lambda h: h.oks()),
    ("invokes", lambda h: h.invokes()),
    ("fails", lambda h: h.fails()),
    ("infos", lambda h: h.infos()),
    ("nemesis_ops", lambda h: h.nemesis_ops()),
    ("has_f str", lambda h: h.has_f("cas")),
    ("has_f set", lambda h: h.has_f({"read", "write"})),
    ("has_f pred", lambda h: h.has_f(lambda f: f != "read")),
    ("possible", lambda h: h.possible()),
    ("possible of oks", lambda h: h.client_ops().possible()),
    ("remove", lambda h: h.remove(lambda o: o.is_info)),
    ("map", lambda h: h.map(lambda o: o.with_ext(seen=o.index % 3))),
    ("strip_indices", lambda h: h.strip_indices()),
    ("get_index", lambda h: [o for o in (h.oks().get_index(i)
                                         for i in range(len(h)))
                             if o is not None]),
]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name,view", VIEWS, ids=[v[0] for v in VIEWS])
def test_history_views_equal_the_reference(seed, name, view):
    got = view(_mixed(pcore, seed))
    want = view(_mixed(rcore, seed))
    assert _dicts(got) == _dicts(want), name
    if isinstance(want, rcore.History):
        assert isinstance(got, pcore.History)
        assert [got.pair_index(o.index) for o in got] == \
            [want.pair_index(o.index) for o in want]


def test_get_index_misses_are_none():
    h = _mixed(pcore, 4)
    oks = h.oks()
    assert oks.get_index(h.invokes()[0].index) is None
    assert oks.get_index(len(h) + 10) is None


def test_with_ext_keeps_the_other_fields():
    o = pcore.Op(type="ok", f="read", value=3, process=2, time=7, index=5,
                 ext={"a": 1})
    r = rcore.Op(type="ok", f="read", value=3, process=2, time=7, index=5,
                 ext={"a": 1})
    assert o.with_ext(a=2, b=3).to_dict() == r.with_ext(a=2, b=3).to_dict()
    assert o.ext == {"a": 1}


@pytest.mark.parametrize("seed,read_at", [(11, 0.6), (5, 0.1), (7, 0.95)])
def test_stale_read_history_equals_the_reference(seed, read_at):
    got = pgen.stale_read_history(2_000, procs=8, info_rate=0.05, seed=seed,
                                  read_at=read_at)
    want = rgen.stale_read_history(2_000, procs=8, info_rate=0.05,
                                   seed=seed, read_at=read_at)
    assert _dicts(got) == _dicts(want)


@pytest.mark.parametrize("chunks", [1, 7, 64])
def test_builder_extend_and_op_row_equal_the_reference(chunks):
    ph = pgen.random_register_history(1_500, procs=6, info_rate=0.1, seed=9)
    rh = rgen.random_register_history(1_500, procs=6, info_rate=0.1, seed=9)
    pb = ppacked.PackedBuilder(pcas().packed().encode)
    rb = rpacked.PackedBuilder(rcas().packed().encode)
    p_ops, r_ops = list(ph), list(rh)
    step = max(1, len(p_ops) // chunks)
    for i in range(0, len(p_ops), step):
        pb.extend(p_ops[i:i + step])
        rb.extend(r_ops[i:i + step])
        assert pb.n_events == rb.n_events
    pb.extend([])
    p, r = pb.finish(), rb.finish()
    assert ppacked.packed_to_bytes(p) == rpacked.packed_to_bytes(r)
    assert [p.op_row(a) for a in range(p.n)] == \
        [r.op_row(a) for a in range(r.n)]


def test_foreign_events_equal_the_reference():
    events = [{"name": "checkerd.check", "ts": 1.5, "dur": 2.0},
              {"name": "checkerd.queue", "ts": 0.5, "dur": 1.0, "pid": 9},
              {"bad": 1}, "not a dict"]
    out = []
    for tel in (ptel, rtel):
        was = tel.enabled()
        tel.reset()
        tel.enable(True)
        try:
            assert tel.foreign_events() == []
            tel.adopt_remote_events(events, pid="daemon")
            got = tel.foreign_events()
            got[0]["name"] = "mutated"
            out.append(tel.foreign_events())
        finally:
            tel.reset()
            tel.enable(was)
    assert out[0] == out[1]
    assert [e["pid"] for e in out[0]] == ["daemon", 9]
