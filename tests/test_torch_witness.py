"""Witness search parity: the port's `check_wgl_witness` (CPU, plain
sweep) against the JAX package's on the corpora of
tests/test_wgl_pallas.py (JAX side in Pallas interpret mode, as that
file runs it) and tests/test_wgl_witness.py (JAX side as that file
runs it): verdict (True or None) and `died_at_rank` must match
exactly, and the block planner's output must be identical."""

import numpy as np
import pytest

from jepsen_tpu.history.core import Op as RefOp
from jepsen_tpu.history.core import history as ref_history
from jepsen_tpu.history.packed import pack_history as ref_pack
from jepsen_tpu.models import cas_register as ref_cas_register
from jepsen_tpu.models import register as ref_register
from jepsen_tpu.ops.wgl_witness import _plan_blocks as ref_plan_blocks
from jepsen_tpu.ops.wgl_witness import check_wgl_witness as ref_witness
from jepsen_tpu.ops.wgl_witness import plan_drops as ref_plan_drops
from jepsen_tpu.ops.wgl_witness import plan_width as ref_plan_width
from jepsen_tpu.utils.histgen import random_register_history as ref_gen
from jepsen_tpu_torch.history.core import Op, history
from jepsen_tpu_torch.history.packed import pack_history
from jepsen_tpu_torch.models import cas_register, register
from jepsen_tpu_torch.ops.wgl_witness import (_plan_blocks,
                                              check_wgl_witness, plan_drops,
                                              plan_width)
from jepsen_tpu_torch.utils.histgen import random_register_history


#: One model per package and kind for the whole file: the JAX package
#: caches its compiled chunk program by the model's step function, so a
#: fresh model per case would recompile every time.  Both packages pack
#: the same histories in the same order, so their interners stay equal.
_MODELS = {
    True: (ref_cas_register().packed(), cas_register().packed()),
    False: (ref_register().packed(), register().packed()),
}


def _pair(n, info, procs, seed, *, bad=False, cas=True):
    ref_pm, pm = _MODELS[cas]
    kw = dict(procs=procs, info_rate=info, seed=seed, bad=bad, cas=cas)
    return (ref_pack(ref_gen(n, **kw), ref_pm.encode), ref_pm,
            pack_history(random_register_history(n, **kw), pm.encode), pm)


#: One window width for every case on both sides, so the JAX package
#: compiles its chunk program once per sweep mode instead of per case.
#: The width only pads the window; the tile compaction threshold
#: (min(W // 2, info window)) stays 512.
WIDTH = 2048


def _verdicts(ref_p, ref_pm, p, pm, **ref_kw):
    ref_info, info = {}, {}
    a = ref_witness(ref_p, ref_pm, out_info=ref_info, width_hint=WIDTH,
                    **ref_kw)
    b = check_wgl_witness(p, pm, out_info=info, width_hint=WIDTH,
                          device="cpu")
    return (None if a is None else a.valid, ref_info,
            None if b is None else b.valid, info)


@pytest.mark.parametrize("n,info,procs,seed", [
    (256, 0.0, 4, 1),
    (1024, 0.1, 8, 2),
    (2048, 0.3, 16, 3),   # heavy chain rounds interleave the sweep
    (4096, 0.05, 8, 4),
])
def test_witness_parity_pallas_corpus(n, info, procs, seed):
    a, ai, b, bi = _verdicts(*_pair(n, info, procs, seed), pallas="interpret")
    assert a == b and a in (True, None)
    assert ai == bi


@pytest.mark.parametrize("n,info,procs,seed", [
    (128, 0.0, 4, 1),
    (512, 0.0, 16, 2),
    (512, 0.2, 16, 3),
    (512, 0.3, 4, 4),
    (2048, 0.1, 8, 5),
    (1024, 0.5, 8, 6),
])
def test_witness_parity_witness_corpus(n, info, procs, seed):
    a, ai, b, bi = _verdicts(*_pair(n, info, procs, seed))
    assert a == b is True
    assert ai == bi == {}


@pytest.mark.parametrize("n,info,procs,seed", [
    (256, 0.0, 4, 13),   # test_wgl_pallas.py's invalid-dies case
    (96, 0.1, 4, 9),     # test_wgl_witness.py's never-reports-invalid
])
def test_witness_invalid_dies_at_same_rank(n, info, procs, seed):
    a, ai, b, bi = _verdicts(*_pair(n, info, procs, seed, bad=True),
                             pallas="interpret")
    assert a is None and b is None
    assert bi["died_at_rank"] is not None
    assert ai == bi


def test_witness_parity_plain_register():
    a, ai, b, bi = _verdicts(*_pair(1024, 0.1, 8, 21, cas=False),
                             pallas="interpret")
    assert a == b is True


def _both(ops):
    ref_pm, pm = _MODELS[True]
    ref_h = ref_history([RefOp(**o) for o in ops])
    h = history([Op(**o) for o in ops])
    return ref_pack(ref_h, ref_pm.encode), ref_pm, pack_history(h, pm.encode), pm


def test_witness_chain_through_info_ops():
    """A read only explainable by linearizing two pending info ops in
    sequence (write 5, then cas 5->7): the expand-any round."""
    a, _, b, _ = _verdicts(*_both([
        dict(type="invoke", f="write", value=1, process=0),
        dict(type="ok", f="write", value=1, process=0),
        dict(type="invoke", f="write", value=5, process=1),
        dict(type="invoke", f="cas", value=(5, 7), process=2),
        dict(type="invoke", f="read", value=None, process=3),
        dict(type="ok", f="read", value=7, process=3),
    ]))
    assert a == b is True


def test_witness_empty_and_info_only():
    assert check_wgl_witness(
        pack_history(history([]), cas_register().packed().encode),
        cas_register().packed(), device="cpu").valid is True
    a, _, b, _ = _verdicts(*_both([
        dict(type="invoke", f="write", value=3, process=0),
        dict(type="info", f="write", value=3, process=0),
    ]))
    assert a == b is True


@pytest.mark.parametrize("n,info,procs,seed,bars,window", [
    (2048, 0.4, 16, 3, 256, 8),
    (4096, 0.05, 16, 7, 512, 512),
    (3000, 0.2, 8, 11, 2048, None),
])
def test_plan_blocks_identical(n, info, procs, seed, bars, window):
    ref_p, _, p, _ = _pair(n, info, procs, seed)
    ref = ref_plan_blocks(ref_p, bars, window)
    got = _plan_blocks(p, bars, window)
    for i in range(4):  # bars, bar_rank, inv32, ret32
        assert got[i].dtype == ref[i].dtype
        assert np.array_equal(got[i], ref[i])
    assert len(got[4]) == len(ref[4])
    for (k0, bb, act), (rk0, rbb, ract) in zip(got[4], ref[4]):
        assert k0 == rk0
        assert np.array_equal(bb, rbb) and np.array_equal(act, ract)
    assert got[5] == ref[5]
    assert plan_width(p, bars, window) == ref_plan_width(ref_p, bars, window)
    assert plan_drops(p, bars, window) == ref_plan_drops(ref_p, bars, window)


def test_plan_blocks_int32_timeline_guard():
    _, _, p, pm = _pair(64, 0.0, 4, 1)
    p.inv = p.inv + 2**31
    with pytest.raises(OverflowError):
        _plan_blocks(p, 2048)
    assert check_wgl_witness(p, pm, device="cpu") is None
