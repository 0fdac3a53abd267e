"""Port parity for the mutex, multi-register and queue models: the
host `step`, `encode`, `py_step`, `torch_step` and `torch_step_rows`
against the JAX package's `step`, `encode`, `py_step`, `vmap(jax_step)`
and `jax_step_rows` on the same seeded states (exact integer equality),
`validate_packed`, and the host-model fallback of `Linearizable` for
models and histories with no packed form (the cases of
tests/test_wgl_pallas.py and tests/test_queue_packed.py)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jepsen_tpu.history.core as ref_hc
import jepsen_tpu.models as ref_models
from jepsen_tpu.checker.linearizable import Linearizable as RefLinearizable
from jepsen_tpu.history.packed import pack_history as ref_pack
from jepsen_tpu_torch import models
from jepsen_tpu_torch.checker import Linearizable
from jepsen_tpu_torch.history.core import Op, history
from jepsen_tpu_torch.history.packed import PACKED_COLUMNS, pack_history

from chip_smoke import multi_register_ops, mutex_ops, queue_ops

#: (port factory, reference factory) by name.
MODELS = {
    "mutex": (models.mutex, ref_models.mutex),
    "multi3": (lambda: models.multi_register({"x": 0, "y": 1, "z": 2}),
               lambda: ref_models.multi_register({"x": 0, "y": 1, "z": 2})),
    "multi5": (lambda: models.multi_register({f"r{i}": 0 for i in range(5)}),
               lambda: ref_models.multi_register(
                   {f"r{i}": 0 for i in range(5)})),
    "fifo": (models.fifo_queue, ref_models.fifo_queue),
    "unordered": (models.unordered_queue, ref_models.unordered_queue),
}


def _pms(name):
    mk, ref_mk = MODELS[name]
    return mk().packed(), ref_mk().packed()


def _queue_lanes(C, fifo):
    """Queue states: every fill 0..3 of codes 2..4 (left-aligned for
    the FIFO, in scattered slots for the unordered queue), an empty and
    a full queue."""
    rng = np.random.default_rng(3)
    lanes = []
    for fill in range(4):
        for vals in itertools.product((2, 3, 4), repeat=fill):
            lane = [0] * C
            slots = range(fill) if fifo else sorted(
                rng.permutation(C)[:fill].tolist())
            for s, v in zip(slots, vals):
                lane[s] = v
            lanes.append(lane)
    lanes.append([0] * C)
    lanes.append([(j % 5) + 2 for j in range(C)])  # full
    return np.array(lanes, dtype=np.int32)


def _states(name, pm):
    if name == "mutex":
        return np.array([[0], [1], [0], [1]], dtype=np.int32)
    if name.startswith("multi"):
        return np.random.default_rng(7).integers(
            0, 5, size=(8, pm.state_width)).astype(np.int32)
    return _queue_lanes(pm.state_width, fifo=name == "fifo")


def _ops(name, pm):
    """(f, a0, a1) codes: every op kind, every register index of a
    multi-register, a0 = 0 and codes absent from the states for the
    queues."""
    if name == "mutex":
        return [(0, 0, 0), (1, 0, 0)]
    if name.startswith("multi"):
        return [(f, k, v) for f in (0, 1) for k in range(pm.state_width)
                for v in (0, 3)]
    return [(f, a0, 0) for f in (0, 1) for a0 in (0, 2, 3, 5)]


@pytest.mark.parametrize("name", list(MODELS))
def test_torch_step_matches_vmap_jax_step(name):
    pm, ref_pm = _pms(name)
    states = _states(name, pm)
    for f, a0, a1 in _ops(name, pm):
        want_s, want_l = jax.vmap(
            lambda s: ref_pm.jax_step(s, f, a0, a1))(jnp.asarray(states))
        got_s, got_l = pm.torch_step(torch.from_numpy(states), f, a0, a1)
        assert np.array_equal(got_s.numpy(), np.asarray(want_s)), (f, a0, a1)
        assert np.array_equal(got_l.numpy(),
                              np.asarray(want_l).astype(bool)), (f, a0, a1)


@pytest.mark.parametrize("name", list(MODELS))
def test_torch_step_rows_matches_jax_step_rows(name):
    """The lane-major rows step, state for state: the unordered queue's
    is the unsorted first-zero / first-match form on both sides."""
    pm, ref_pm = _pms(name)
    states = _states(name, pm).T.copy()
    for f, a0, a1 in _ops(name, pm):
        want_s, want_l = ref_pm.jax_step_rows(
            jnp.asarray(states), jnp.int32(f), jnp.int32(a0), jnp.int32(a1))
        got_s, got_l = pm.torch_step_rows(torch.from_numpy(states), f, a0, a1)
        assert np.array_equal(got_s.numpy(), np.asarray(want_s)), (f, a0, a1)
        assert np.array_equal(got_l.numpy(),
                              np.asarray(want_l).astype(bool)), (f, a0, a1)


@pytest.mark.parametrize("name", list(MODELS))
def test_py_step_matches_reference(name):
    pm, ref_pm = _pms(name)
    assert pm.init_state == ref_pm.init_state
    assert pm.state_width == ref_pm.state_width
    assert pm.kernel_model is not None
    for lane in _states(name, pm):
        for f, a0, a1 in _ops(name, pm):
            s = tuple(int(x) for x in lane)
            assert pm.py_step(s, f, a0, a1) == ref_pm.py_step(s, f, a0, a1)


def test_multi_register_rows_step_outside_its_registers():
    """An a0 outside [0, SW) reads 0 and writes nothing, on both sides
    (the sweep kernel clears such an index the same way)."""
    pm, ref_pm = _pms("multi3")
    states = _states("multi3", pm).T.copy()
    for f, a0, a1 in ((0, -1, 0), (1, -1, 4), (0, 3, 0), (1, 7, 2)):
        want_s, want_l = ref_pm.jax_step_rows(
            jnp.asarray(states), jnp.int32(f), jnp.int32(a0), jnp.int32(a1))
        got_s, got_l = pm.torch_step_rows(torch.from_numpy(states), f, a0, a1)
        assert np.array_equal(got_s.numpy(), np.asarray(want_s))
        assert np.array_equal(got_l.numpy(), np.asarray(want_l).astype(bool))


GENERATORS = {"mutex": mutex_ops, "multi5": multi_register_ops,
              "fifo": queue_ops, "unordered": queue_ops}


@pytest.mark.parametrize("name", list(GENERATORS))
@pytest.mark.parametrize("bad", [False, True])
def test_pack_history_identical(name, bad):
    """The same generated history packs to identical columns and
    interners in both packages."""
    pm, ref_pm = _pms(name)
    ops = GENERATORS[name](80, seed=11, bad=bad, info=0.0)
    got = pack_history(history([Op(**d) for d in ops]), pm.encode)
    ref = ref_pack(ref_hc.history([ref_hc.Op(**d) for d in ops]),
                   ref_pm.encode)
    for col, _ in PACKED_COLUMNS:
        assert np.array_equal(getattr(got, col), getattr(ref, col)), col
    assert pm.interner.values == ref_pm.interner.values
    if pm.validate_packed is not None:
        assert pm.validate_packed(got) == ref_pm.validate_packed(ref)


@pytest.mark.parametrize("name", ["mutex", "multi5", "fifo", "unordered"])
def test_host_step_matches_reference(name):
    """Model.step (the host-model search's transition) along a generated
    history's completions: the same legality at every op."""
    mk, ref_mk = MODELS[name]
    m, ref_m = mk(), ref_mk()
    ops = [d for d in GENERATORS[name](60, seed=5, bad=True, info=0.0)
           if d["type"] == "ok"]
    for d in ops:
        m = m.step(Op(**d))
        ref_m = ref_m.step(ref_hc.Op(**d))
        assert m.is_inconsistent == ref_m.is_inconsistent, d
        if m.is_inconsistent:
            assert m.msg == ref_m.msg
            break
        assert repr(m) == repr(ref_m)
    assert m.is_inconsistent  # every bad history ends illegal


def test_set_model_host_step():
    s = models.set_model()
    ref_s = ref_models.set_model()
    for f, v in (("add", 1), ("add", 2), ("read", [2, 1]), ("read", [1])):
        s = s.step(Op(type="ok", f=f, value=v, process=0))
        ref_s = ref_s.step(ref_hc.Op(type="ok", f=f, value=v, process=0))
        assert s.is_inconsistent == ref_s.is_inconsistent
    assert s.is_inconsistent


# ---------------------------------------------------------------------------
# Linearizable on the queue cases of tests/test_queue_packed.py.

def _q(*rows):
    return [dict(type=t, f=f, value=v, process=p) for t, f, v, p in rows]


VALID = _q(("invoke", "enqueue", 1, 0), ("invoke", "enqueue", 2, 1),
           ("ok", "enqueue", 1, 0), ("ok", "enqueue", 2, 1),
           ("invoke", "dequeue", None, 2), ("ok", "dequeue", 2, 2),
           ("invoke", "dequeue", None, 0), ("ok", "dequeue", 1, 0))
BAD = _q(("invoke", "enqueue", 1, 0), ("ok", "enqueue", 1, 0),
         ("invoke", "dequeue", None, 1), ("ok", "dequeue", 9, 1))
INFO_ENQ = _q(("invoke", "enqueue", 5, 0), ("info", "enqueue", 5, 0),
              ("invoke", "dequeue", None, 1), ("ok", "dequeue", 5, 1))
INFO_DEQ = _q(("invoke", "enqueue", 1, 0), ("ok", "enqueue", 1, 0),
              ("invoke", "dequeue", None, 1), ("info", "dequeue", None, 1))
FIFO_VALID = _q(("invoke", "enqueue", 1, 0), ("ok", "enqueue", 1, 0),
                ("invoke", "enqueue", 2, 1), ("ok", "enqueue", 2, 1),
                ("invoke", "dequeue", None, 2), ("ok", "dequeue", 1, 2),
                ("invoke", "dequeue", None, 0), ("ok", "dequeue", 2, 0))
FIFO_BAD = _q(("invoke", "enqueue", 1, 0), ("ok", "enqueue", 1, 0),
              ("invoke", "enqueue", 2, 1), ("ok", "enqueue", 2, 1),
              ("invoke", "dequeue", None, 2), ("ok", "dequeue", 2, 2))

QUEUE_CASES = [
    ("unordered", VALID, True), ("unordered", BAD, False),
    ("unordered", INFO_ENQ, True), ("unordered", INFO_DEQ, True),
    ("fifo", FIFO_VALID, True), ("fifo", FIFO_BAD, False),
    ("unordered", FIFO_BAD, True), ("fifo", INFO_DEQ, True),
]


#: One model pair per name for the checker tests: the JAX package
#: caches its compiled witness by the model's step function, so a fresh
#: model per check would compile again.  Both packages see the same
#: histories in the same order, so their interners stay equal.
_CHECKED = {}


def _both(name, rows, algo, **kw):
    if name not in _CHECKED:
        mk, ref_mk = MODELS[name]
        _CHECKED[name] = (mk(), ref_mk())
    m, ref_m = _CHECKED[name]
    got = Linearizable(m, algo, device="cpu", **kw).check(
        {}, history([Op(**d) for d in rows]), {})
    ref = RefLinearizable(ref_m, algo, **kw).check(
        {}, ref_hc.history([ref_hc.Op(**d) for d in rows]), {})
    return got, ref


@pytest.mark.parametrize("algo", ["cpu", "wgl-tpu"])
@pytest.mark.parametrize("i", range(len(QUEUE_CASES)))
def test_queue_verdicts_match_reference(algo, i):
    name, rows, want = QUEUE_CASES[i]
    got, ref = _both(name, rows, algo)
    assert got["valid"] is ref["valid"] is want
    assert got["algorithm"] == ref["algorithm"]


def test_indeterminate_dequeue_takes_the_host_model():
    got, ref = _both("unordered", INFO_DEQ, "wgl-tpu")
    assert got["algorithm"] == ref["algorithm"] == "wgl-host-unpackable"


def test_capacity_gate_falls_back_to_host():
    class Tiny(models.UnorderedQueue):
        packed_capacity = 1

    class RefTiny(ref_models.UnorderedQueue):
        packed_capacity = 1

    rows = history([Op(**d) for d in VALID])
    got = Linearizable(Tiny(), "wgl-tpu", device="cpu").check({}, rows, {})
    ref = RefLinearizable(RefTiny(), "wgl-tpu").check(
        {}, ref_hc.history([ref_hc.Op(**d) for d in VALID]), {})
    assert got["valid"] is ref["valid"] is True
    assert got["algorithm"] == ref["algorithm"] == "wgl-host-unpackable"
    assert got["packed-fallback-reason"] == ref["packed-fallback-reason"]


def test_set_model_takes_the_host_search():
    rows = _q(("invoke", "add", 1, 0), ("ok", "add", 1, 0),
              ("invoke", "read", None, 1), ("ok", "read", [1], 1),
              ("invoke", "read", None, 2), ("ok", "read", [], 2))
    for algo in ("wgl-tpu", "cpu"):
        got = Linearizable(models.set_model(), algo, device="cpu").check(
            {}, history([Op(**d) for d in rows]), {})
        ref = RefLinearizable(ref_models.set_model(), algo).check(
            {}, ref_hc.history([ref_hc.Op(**d) for d in rows]), {})
        assert got["valid"] is ref["valid"] is False
        assert got["algorithm"] == ref["algorithm"] == "wgl-host"
        assert got["configs-explored"] == ref["configs-explored"]


@pytest.mark.parametrize("name", ["mutex", "multi5", "fifo", "unordered"])
def test_generated_histories_match_reference(name):
    """Whole generated histories of each model through `Linearizable`
    (refutation screen, witness, frontier BFS, exact settle): the same
    verdict, engine label and configurations explored."""
    for seed, bad in ((1, False), (2, True)):
        rows = GENERATORS[name](40, seed=seed, bad=bad,
                                **({"procs": 3, "info": 0.0}
                                   if name == "fifo" else {}))
        got, ref = _both(name, rows, "wgl-tpu", time_limit_s=60.0)
        assert got["valid"] is ref["valid"] is (not bad)
        assert got["algorithm"] == ref["algorithm"]
        assert got["configs-explored"] == ref["configs-explored"]
