"""Port parity: packing, the convert round trip, and the register
models' torch steps against the JAX package's (jepsen_tpu_torch vs
jepsen_tpu, same seeded inputs, exact integer equality)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.history.packed import pack_history as ref_pack
from jepsen_tpu.models import cas_register as ref_cas_register
from jepsen_tpu.models import register as ref_register
from jepsen_tpu.utils.histgen import random_register_history as ref_gen
from jepsen_tpu_torch import convert
from jepsen_tpu_torch.history.packed import NIL, PACKED_COLUMNS, pack_history
from jepsen_tpu_torch.models import cas_register, register
from jepsen_tpu_torch.utils.histgen import random_register_history

# The histories of tests/test_wgl_pallas.py's interpret-parity cases.
PALLAS_CASES = [
    (256, 0.0, 4, 1),
    (1024, 0.1, 8, 2),
    (2048, 0.3, 16, 3),
    (4096, 0.05, 8, 4),
]


@pytest.mark.parametrize("n,info,procs,seed", PALLAS_CASES)
def test_pack_history_identical(n, info, procs, seed):
    ref_pm = ref_cas_register().packed()
    pm = cas_register().packed()
    ref = ref_pack(ref_gen(n, procs=procs, info_rate=info, seed=seed),
                   ref_pm.encode)
    got = pack_history(
        random_register_history(n, procs=procs, info_rate=info, seed=seed),
        pm.encode)
    for name, dtype in PACKED_COLUMNS:
        a, b = getattr(ref, name), getattr(got, name)
        assert b.dtype == dtype and a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    assert ref_pm.interner.values == pm.interner.values
    assert ref_pm.init_state == pm.init_state


def test_pack_history_bad_and_register():
    for cas, bad in ((True, True), (False, False)):
        ref_m = (ref_cas_register() if cas else ref_register()).packed()
        m = (cas_register() if cas else register()).packed()
        ref = ref_pack(ref_gen(300, procs=6, info_rate=0.2, seed=5, cas=cas,
                               bad=bad, bad_at=0.5), ref_m.encode)
        got = pack_history(random_register_history(
            300, procs=6, info_rate=0.2, seed=5, cas=cas, bad=bad,
            bad_at=0.5), m.encode)
        for name, _ in PACKED_COLUMNS:
            assert np.array_equal(getattr(ref, name), getattr(got, name))


def test_convert_round_trip():
    ref_pm = ref_cas_register().packed()
    ref = ref_pack(ref_gen(512, procs=8, info_rate=0.1, seed=3), ref_pm.encode)
    pm = cas_register().packed()
    got = convert.packed_from_arrays(convert.packed_to_arrays(ref))
    convert.adopt_values(pm, ref_pm.interner.values)
    assert pm.interner.values == ref_pm.interner.values
    back = convert.packed_to_arrays(got)
    for name, dtype in PACKED_COLUMNS:
        assert back[name].dtype == dtype
        assert np.array_equal(back[name], getattr(ref, name)), name
    assert got.n == ref.n and got.n_ok == ref.n_ok
    # A describe_op through the adopted interner decodes like the JAX one.
    row = int(np.nonzero(got.f == 2)[0][0])
    args = (int(got.f[row]), int(got.a0[row]), int(got.a1[row]))
    assert pm.describe_op(*args) == ref_pm.describe_op(*args)
    with pytest.raises(ValueError, match="prefix"):
        convert.adopt_values(cas_register(7).packed(), ref_pm.interner.values)
    with pytest.raises(ValueError, match="shape"):
        bad = convert.packed_to_arrays(ref)
        bad["a0"] = bad["a0"][:-1]
        convert.packed_from_arrays(bad)


def _domain():
    values = [0, 1, 2, 3, NIL]
    return [(f, a0, a1, s) for f, a0, a1, s in itertools.product(
        (0, 1, 2), values, values, (0, 1, 2, 3))]


@pytest.mark.parametrize("ctor,ref_ctor", [(register, ref_register),
                                            (cas_register, ref_cas_register)])
def test_torch_step_matches_jax_step(ctor, ref_ctor):
    pm, ref_pm = ctor().packed(), ref_ctor().packed()
    f, a0, a1, s = (np.array(c, dtype=np.int32) for c in zip(*_domain()))
    states = s[:, None]
    ref_s, ref_legal = jax.vmap(ref_pm.jax_step)(
        jnp.asarray(states), jnp.asarray(f), jnp.asarray(a0), jnp.asarray(a1))
    got_s, got_legal = pm.torch_step(
        torch.from_numpy(states), torch.from_numpy(f), torch.from_numpy(a0),
        torch.from_numpy(a1))
    assert got_s.dtype == torch.int32 and got_legal.dtype == torch.bool
    assert np.array_equal(got_s.numpy(), np.asarray(ref_s))
    assert np.array_equal(got_legal.numpy(), np.asarray(ref_legal))
    # Scalar op codes (one barrier op against a batch of states), as the
    # chain search calls it.
    lanes = torch.tensor([[0], [1], [2], [3], [NIL]], dtype=torch.int32)
    for fi, a0i, a1i in itertools.product((0, 1, 2), (0, 3, NIL), (1, NIL)):
        got_s, got_legal = pm.torch_step(lanes, fi, a0i, a1i)
        ref_s, ref_legal = jax.vmap(
            lambda st: ref_pm.jax_step(st, fi, a0i, a1i))(
                jnp.asarray(lanes.numpy()))
        assert np.array_equal(got_s.numpy(), np.asarray(ref_s))
        assert np.array_equal(got_legal.numpy(), np.asarray(ref_legal))


@pytest.mark.parametrize("ctor,ref_ctor", [(register, ref_register),
                                            (cas_register, ref_cas_register)])
def test_torch_step_rows_matches_jax_step_rows(ctor, ref_ctor):
    pm, ref_pm = ctor().packed(), ref_ctor().packed()
    lanes = np.array([[0, 1, 2, 3, NIL, 1, 0, 2]], dtype=np.int32)  # (1, B)
    for fi, a0i, a1i in itertools.product((0, 1, 2), (0, 1, 3, NIL),
                                          (0, 2, NIL)):
        ref_s, ref_legal = ref_pm.jax_step_rows(jnp.asarray(lanes), fi, a0i,
                                                a1i)
        got_s, got_legal = pm.torch_step_rows(torch.from_numpy(lanes), fi,
                                              a0i, a1i)
        assert got_s.shape == lanes.shape and got_legal.shape == (8,)
        assert np.array_equal(got_s.numpy(), np.asarray(ref_s))
        assert np.array_equal(got_legal.numpy(),
                              np.asarray(ref_legal).astype(bool))


def test_kernel_model_ids():
    assert cas_register().packed().kernel_model == 1
    assert register().packed().kernel_model == 1
    assert cas_register().packed().state_width == 1
