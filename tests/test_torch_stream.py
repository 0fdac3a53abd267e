"""Port parity for the many-key stream witness (ops/wgl_stream.py) and
the witness's `rank_override`: the port against the JAX package on the
cases of tests/test_wgl_stream.py, with identical packed input carried
across as numpy arrays, both with wide member windows
(JEPSEN_WGL_PACKED=0) and at the default, packed lanes.  The JAX side
is pinned to the port's knobs (2,048 barriers per block, 32 blocks per
call, the XLA scan sweep).  `concat_packs` arrays, per-key True/None lists and
`died_at_rank` must match exactly."""

import numpy as np
import pytest
import torch

import jepsen_tpu.models as ref_models
from jepsen_tpu.history.core import Op as RefOp
from jepsen_tpu.history.core import history as ref_history
from jepsen_tpu.history.packed import PackedOps as RefPackedOps
from jepsen_tpu.history.packed import pack_history as ref_pack
from jepsen_tpu.ops.wgl_stream import check_wgl_witness_stream as ref_stream
from jepsen_tpu.ops.wgl_stream import concat_packs as ref_concat
from jepsen_tpu.ops.wgl_stream import stream_model as ref_stream_model
from jepsen_tpu.ops.wgl_stream import stream_timeline_len as ref_timeline
from jepsen_tpu.ops.wgl_witness import _plan_blocks as ref_plan_blocks
from jepsen_tpu.ops.wgl_witness import check_wgl_witness as ref_witness
from jepsen_tpu.utils.histgen import random_register_history as ref_gen
from jepsen_tpu_torch import convert
from jepsen_tpu_torch import device as D
from jepsen_tpu_torch import models
from jepsen_tpu_torch.history.packed import PACKED_COLUMNS, ST_OK
from jepsen_tpu_torch.ops.wgl_stream import (F_RESET,
                                             check_wgl_witness_stream,
                                             concat_packs, stream_model,
                                             stream_timeline_len)
from jepsen_tpu_torch.ops.wgl_witness import _plan_blocks, check_wgl_witness

from chip_smoke import multi_register_ops, mutex_ops, queue_ops

#: The JAX side's witness knobs, the port's fixed ones.
PINNED = dict(bars_per_block=2048, blocks_per_call=32,
              pallas="off")

#: One model pair per kind for the file (the JAX package compiles per
#: step function).
_REF_CAS = ref_models.cas_register().packed()
_CAS = models.cas_register().packed()


@pytest.fixture(autouse=True, params=["0", None], ids=["wide", "packed"])
def packing(request, monkeypatch):
    """Both packages with wide bool member bitsets
    (JEPSEN_WGL_PACKED=0), then at the default: 32-bit packed lanes."""
    if request.param is None:
        monkeypatch.delenv("JEPSEN_WGL_PACKED", raising=False)
    else:
        monkeypatch.setenv("JEPSEN_WGL_PACKED", request.param)


def _cas_packs(n_keys, n_ops=100, bad_keys=(), info=0.05, procs=4):
    """Per-key packs of the JAX package's generator, and the same
    arrays as port packs."""
    ref = [ref_pack(ref_gen(n_ops, procs=procs, info_rate=info, seed=i,
                            bad=i in bad_keys), _REF_CAS.encode)
           for i in range(n_keys)]
    return ref, convert.packs_across(ref)


def _streams(ref_packs, packs, ref_pm, pm):
    want = ref_stream(ref_packs, ref_pm, **PINNED)
    got = check_wgl_witness_stream(packs, pm, device="cpu")
    return got, want


def _empty_pack():
    e = {name: np.empty(0, dtype=dtype) for name, dtype in PACKED_COLUMNS}
    return RefPackedOps(**e)


def test_concat_packs_arrays_equal():
    ref, port = _cas_packs(5)
    ref = ref[:2] + [_empty_pack()] + ref[2:]
    port = convert.packs_across(ref)
    want = ref_concat(ref)
    got = concat_packs(port)
    for name, _ in PACKED_COLUMNS:
        assert np.array_equal(getattr(got[0], name),
                              getattr(want[0], name)), name
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[2], want[2])
    # Each key's indeterminate rows are fenced at its RESET's rank.
    info_rows = got[0].status != ST_OK
    assert (got[1][info_rows] >= 0).all() and (got[1][~info_rows] == -1).all()
    assert int((got[0].f == F_RESET).sum()) == 6


@pytest.mark.parametrize("n_keys,bad_keys", [
    (40, ()),             # all valid: one pass
    (30, (7, 19)),        # bad keys localized, the rest proven
    (10, (0, 9)),         # first and last key bad
    (24, (3, 4, 5, 11)),  # adjacent bad keys: restarts in segments
])
def test_stream_verdicts_match_reference(n_keys, bad_keys):
    ref, port = _cas_packs(n_keys, bad_keys=bad_keys)
    D.counters.clear()
    got, want = _streams(ref, port, _REF_CAS, _CAS)
    assert got == want
    for i, v in enumerate(got):
        assert (v is True) == (i not in bad_keys)
    assert D.counters["stream_restarts"] == len(bad_keys)
    assert D.counters["stream_keys_proven"] == n_keys - len(bad_keys)


def test_stream_restart_cap_matches_reference():
    """Twelve bad keys of twenty: past max(8, K // 2) = 10 restarts the
    keys left stay None, valid or not."""
    bad = (0, 1, 2, 4, 5, 7, 8, 10, 12, 13, 15, 17)
    ref, port = _cas_packs(20, n_ops=40, bad_keys=bad)
    D.counters.clear()
    got, want = _streams(ref, port, _REF_CAS, _CAS)
    assert got == want
    assert D.counters["stream_restarts"] == 10
    assert any(v is None for i, v in enumerate(got) if i not in bad)


def test_stream_empty_and_tiny_keys():
    rows = [RefOp(type="invoke", f="write", value=1, process=0),
            RefOp(type="ok", f="write", value=1, process=0),
            RefOp(type="invoke", f="read", value=None, process=1),
            RefOp(type="ok", f="read", value=1, process=1)]
    one = ref_pack(ref_history(rows), _REF_CAS.encode)
    ref = [_empty_pack(), one, _empty_pack()]
    got, want = _streams(ref, convert.packs_across(ref), _REF_CAS, _CAS)
    assert got == want == [True, True, True]


def test_stream_time_budget_degrades_to_none():
    _, port = _cas_packs(6)
    assert check_wgl_witness_stream(port, _CAS, time_limit_s=0.0,
                                    device="cpu") == [None] * 6


def _pack_at_offset(offset, n=2):
    """A tiny valid write-only pack whose events start at `offset`."""
    fc, a0, a1 = _REF_CAS.encode(RefOp(type="invoke", f="write", value=1,
                                       process=0),
                                 RefOp(type="ok", f="write", value=1,
                                       process=0))
    inv = offset + 2 * np.arange(n, dtype=np.int64)
    return RefPackedOps(
        inv=inv, ret=inv + 1, process=np.zeros(n, dtype=np.int32),
        status=np.full(n, ST_OK, dtype=np.int32),
        f=np.full(n, fc, dtype=np.int32), a0=np.full(n, a0, dtype=np.int32),
        a1=np.full(n, a1, dtype=np.int32),
        src_index=np.arange(n, dtype=np.int64),
        preds=np.zeros(n, dtype=np.int64),
        horizon=np.full(n, n - 1, dtype=np.int64))


def test_timeline_len_and_int32_fallback():
    ref, port = _cas_packs(4, n_ops=50)
    assert stream_timeline_len(port) == ref_timeline(ref)
    combined, _, _ = concat_packs(port)
    assert int(combined.inv.max()) < stream_timeline_len(port)
    big = [_pack_at_offset(0), _pack_at_offset(2**31 - 1)]
    got, want = _streams(big, convert.packs_across(big), _REF_CAS, _CAS)
    assert got == want == [None, None]
    with pytest.raises(OverflowError):
        _plan_blocks(convert.packs_across(big)[1], 1024)
    assert check_wgl_witness(convert.packs_across(big)[1], _CAS,
                             device="cpu") is None


def _states_of(ref_pm, pm):
    sw = pm.state_width
    return np.random.default_rng(sw).integers(0, 4, (6, sw)).astype(np.int32)


STREAM_MODELS = {
    "cas": (_CAS, _REF_CAS),
    "mutex": (models.mutex().packed(), ref_models.mutex().packed()),
    "multi3": (models.multi_register({"r0": 0, "r1": 1, "r2": 2}).packed(),
               ref_models.multi_register(
                   {"r0": 0, "r1": 1, "r2": 2}).packed()),
    "fifo": (models.fifo_queue().packed(), ref_models.fifo_queue().packed()),
}


@pytest.mark.parametrize("name", list(STREAM_MODELS))
def test_stream_model_reset_semantics(name):
    """RESET maps any state to the initial state and is always legal,
    in every step form; other codes step as the base model."""
    pm, ref_pm = STREAM_MODELS[name]
    spm, ref_spm = stream_model(pm), ref_stream_model(ref_pm)
    assert spm.stream and not pm.stream
    assert spm.kernel_model == pm.kernel_model
    states = _states_of(ref_pm, pm)
    init = np.array(pm.init_state, dtype=np.int32)
    s, legal = spm.torch_step(torch.from_numpy(states), F_RESET, 0, 0)
    assert legal.all() and (s.numpy() == init).all()
    f = torch.tensor([F_RESET, 0, F_RESET, 1, 0, 1], dtype=torch.int32)
    s, legal = spm.torch_step(torch.from_numpy(states), f, 1, 2)
    base_s, base_l = pm.torch_step(torch.from_numpy(states),
                                   torch.where(f == F_RESET, 0, f), 1, 2)
    reset = (f == F_RESET).numpy()
    assert (s.numpy()[reset] == init).all() and legal.numpy()[reset].all()
    assert np.array_equal(s.numpy()[~reset], base_s.numpy()[~reset])
    assert np.array_equal(legal.numpy()[~reset], base_l.numpy()[~reset])
    rows = states.T.copy()
    for fc in (F_RESET, 0, 1):
        got_s, got_l = spm.torch_step_rows(torch.from_numpy(rows), fc, 1, 2)
        want_s, want_l = ref_spm.jax_step_rows(rows, np.int32(fc),
                                               np.int32(1), np.int32(2))
        assert np.array_equal(got_s.numpy(), np.asarray(want_s))
        assert np.array_equal(got_l.numpy(), np.asarray(want_l).astype(bool))
    for lane in states:
        st = tuple(int(x) for x in lane)
        for fc in (F_RESET, 0, 1):
            assert spm.py_step(st, fc, 1, 2) == ref_spm.py_step(st, fc, 1, 2)


def _model_packs(gen, ref_pm, n_keys, n_ops, bad_keys, **kw):
    ref = [ref_pack(ref_history([RefOp(**d) for d in gen(
        n_ops, seed=i, bad=i in bad_keys, **kw)]), ref_pm.encode)
        for i in range(n_keys)]
    return ref, convert.packs_across(ref)


@pytest.mark.parametrize("name,gen,kw", [
    ("mutex", mutex_ops, {}),
    ("multi3", lambda n, **k: multi_register_ops(n, n_regs=3, **k), {}),
    ("fifo", queue_ops, {"procs": 3, "info": 0.0}),
])
def test_stream_other_models_match_reference(name, gen, kw):
    pm, ref_pm = STREAM_MODELS[name]
    ref, port = _model_packs(gen, ref_pm, 12, 40, (2, 7), **kw)
    got, want = _streams(ref, port, ref_pm, pm)
    assert got == want
    assert got[2] is None and got[7] is None


def test_stream_sequential_fifo_all_proven():
    """tests/test_wgl_stream.py's FIFO case: eight keys of strictly
    sequential enqueue/dequeue pairs, every key proven."""
    pm, ref_pm = STREAM_MODELS["fifo"]
    rows = []
    for j in range(16):
        rows += [RefOp(type="invoke", f="enqueue", value=j, process=0),
                 RefOp(type="ok", f="enqueue", value=j, process=0),
                 RefOp(type="invoke", f="dequeue", value=None, process=1),
                 RefOp(type="ok", f="dequeue", value=j, process=1)]
    ref = [ref_pack(ref_history(rows), ref_pm.encode) for _ in range(8)]
    got, want = _streams(ref, convert.packs_across(ref), ref_pm, pm)
    assert got == want == [True] * 8


def test_witness_rank_override_matches_reference():
    """check_wgl_witness on a concatenated stream with its
    rank_override: the plan (barriers, ranks, int32 tables, blocks) is
    identical, and so are the verdict and the death rank."""
    ref, port = _cas_packs(8, n_ops=80, bad_keys=(5,), info=0.2)
    ref_c, ref_ov, _ = ref_concat(ref)
    c, ov, _ = concat_packs(port)
    want_plan = ref_plan_blocks(ref_c, 2048, 256, ref_ov)
    got_plan = _plan_blocks(c, 2048, 256, ov)
    for a, b in zip(got_plan[:4], want_plan[:4]):
        assert np.array_equal(a, b)
    assert len(got_plan[4]) == len(want_plan[4])
    for ga, wa in zip(got_plan[4], want_plan[4]):
        for x, y in zip(ga, wa):
            assert np.array_equal(x, y)
    assert got_plan[5] == want_plan[5]
    ref_spm, spm = ref_stream_model(_REF_CAS), stream_model(_CAS)
    ref_info, info = {}, {}
    a = ref_witness(ref_c, ref_spm, rank_override=ref_ov, out_info=ref_info,
                    **PINNED)
    b = check_wgl_witness(c, spm, rank_override=ov, out_info=info,
                          device="cpu")
    assert a is None and b is None
    assert info["died_at_rank"] == ref_info["died_at_rank"] is not None
