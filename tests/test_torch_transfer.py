"""The witness's transfer modes in the port (ops/wgl_witness.py), on the
CPU.

* Every case of tests/test_wgl_transfer.py through the port
  (tests/torch_ported.py): "full", "indices" and "device" give the same
  verdicts and death ranks, "auto" is accepted and an unknown mode
  raises.
* Parity with the JAX package's `check_wgl_witness(transfer=m)` for
  each mode, with packed member lanes off and on ("wide"/"packed"):
  the verdict and `died_at_rank` are equal exactly.
* The tables the card builds ("indices" from row indices, "device" from
  the host's per-block scalars) equal the host's "full" tables block
  for block, and so do the member re-gathers.
* A checkpoint saved in "device" mode resumes in "device" mode (the
  carried window rows rebuilt from the previous block's) to the fresh
  run's verdict and death rank.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jepsen_tpu.models as ref_models
from jepsen_tpu.history.packed import pack_history as ref_pack
from jepsen_tpu.ops.wgl_stream import concat_packs as ref_concat_packs
from jepsen_tpu.ops.wgl_stream import stream_model as ref_stream_model
from jepsen_tpu.ops.wgl_witness import check_wgl_witness as ref_witness
from jepsen_tpu.utils.histgen import random_register_history as ref_gen
from jepsen_tpu_torch import models, telemetry
from jepsen_tpu_torch.history.packed import pack_history
from jepsen_tpu_torch.ops import wgl_witness
from jepsen_tpu_torch.ops.wgl import PACKED_ENV, window_regather
from jepsen_tpu_torch.ops.wgl_stream import concat_packs, stream_model
from jepsen_tpu_torch.ops.wgl_witness import (
    NARROW_INFO_WINDOW, _card_tables, _card_window, _chunk_tables,
    _device_plan, _plan_blocks, _upload_rows, check_wgl_witness,
    resolve_transfer)
from jepsen_tpu_torch.utils.histgen import random_register_history

import torch_ported

PORTED = torch_ported.load("test_wgl_transfer")
MODES = ("full", "indices", "device")

#: One model pair for the file (the JAX side compiles per step
#: function).
_REF_CAS = ref_models.cas_register().packed()
_CAS = models.cas_register().packed()

#: One block shape and window width on both sides, so the JAX package
#: compiles each mode's chunk program once for the file.
KNOBS = dict(bars_per_block=256, blocks_per_call=4, width_hint=1024)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["wide", "packed"])
def lanes(request, monkeypatch):
    """Packed member lanes off ("wide") or at their default, on, in
    both packages."""
    if request.param == "wide":
        monkeypatch.setenv(PACKED_ENV, "0")
    else:
        monkeypatch.delenv(PACKED_ENV, raising=False)
    return request.param


@pytest.mark.parametrize("case", torch_ported.cases(PORTED))
def test_transfer_cases_through_the_port(case, request):
    torch_ported.run(PORTED, case, request)


def _v(r):
    return None if r is None else r.valid


def _pair(n, info, procs, seed, bad=False):
    kw = dict(procs=procs, info_rate=info, seed=seed, bad=bad)
    return (ref_pack(ref_gen(n, **kw), _REF_CAS.encode),
            pack_history(random_register_history(n, **kw), _CAS.encode))


CORPORA = [
    (1024, 0.1, 8, 2, False),
    (2048, 0.3, 16, 3, False),   # info-heavy: the retention rule works
    (4096, 0.05, 8, 4, False),   # more blocks than one chunk
    (512, 0.0, 4, 13, True),     # dies: the death rank must agree
    (3000, 0.05, 8, 1, True),
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,info,procs,seed,bad", CORPORA)
def test_modes_equal_the_reference(n, info, procs, seed, bad, mode, lanes):
    ref_p, p = _pair(n, info, procs, seed, bad)
    ref_info, info_d = {}, {}
    want = ref_witness(ref_p, _REF_CAS, transfer=mode, out_info=ref_info,
                       pallas="off", **KNOBS)
    got = check_wgl_witness(p, _CAS, transfer=mode, out_info=info_d,
                            device="cpu", **KNOBS)
    assert _v(got) == _v(want)
    assert info_d == ref_info
    if bad:
        assert got is None and isinstance(info_d["died_at_rank"], int)


def test_override_stream_equals_the_reference(lanes):
    """Under a rank override "device" runs as "indices" in both."""
    refs, ports = [], []
    for i in range(8):
        bad = i in (2, 5)
        ref_p, p = _pair(100, 0.1, 4, i, bad)
        refs.append(ref_p)
        ports.append(p)
    ref_c, ref_ov, _ = ref_concat_packs(refs)
    c, ov, _ = concat_packs(ports)
    for mode in MODES:
        ref_info, info_d = {}, {}
        want = ref_witness(ref_c, ref_stream_model(_REF_CAS),
                           rank_override=ref_ov, transfer=mode,
                           out_info=ref_info, pallas="off", **KNOBS)
        got = check_wgl_witness(c, stream_model(_CAS), rank_override=ov,
                                transfer=mode, out_info=info_d,
                                device="cpu", **KNOBS)
        assert _v(got) == _v(want)
        assert info_d == ref_info


def test_resolve_transfer():
    assert resolve_transfer("auto") == "full"
    assert resolve_transfer("auto", np.zeros(3)) == "full"
    assert resolve_transfer("device") == "device"
    assert resolve_transfer("device", np.zeros(3)) == "indices"
    assert resolve_transfer("indices", np.zeros(3)) == "indices"
    with pytest.raises(ValueError):
        resolve_transfer("bogus")


@pytest.mark.parametrize("info_window", [NARROW_INFO_WINDOW, 64, None])
def test_card_tables_equal_the_host_tables(info_window):
    """Block for block, the tables "indices" and "device" build on the
    card are "full"'s, and the device-planned re-gather is the host's
    (perm where present)."""
    p = pack_history(random_register_history(
        6000, procs=16, info_rate=0.2, seed=21), _CAS.encode)
    K = 128
    plan = _plan_blocks(p, K, info_window)
    blocks = plan[4]
    W = wgl_witness._bucket(max(len(a) for _, _, a in blocks))
    dev = torch.device("cpu")
    rows, _ = _upload_rows(p, plan, K, True, dev)
    scal, S = _device_plan(p, plan, blocks, info_window, W)
    bars_h, tab_h, perm_h, present_h, _ = _chunk_tables(
        p, plan, blocks, None, K, W)
    prev_act = torch.full((W,), p.n, dtype=torch.int32)
    prev = None
    for bi, (k0, block_bars, active) in enumerate(blocks):
        # "indices": the block's rows, padded as the upload pads them.
        bar_i = np.zeros(K, dtype=np.int32)
        bar_i[:len(block_bars)] = block_bars
        act_i = np.full(W, p.n, dtype=np.int32)
        act_i[:len(active)] = active
        bars_b, tab_b = _card_tables(rows, torch.from_numpy(bar_i),
                                     torch.from_numpy(act_i),
                                     len(block_bars), len(active), K, W)
        assert np.array_equal(bars_b.numpy(), bars_h[bi])
        assert np.array_equal(tab_b.numpy(), tab_h[bi])
        # "device": the window planned from the block's scalars.
        k0_, er, lo, nb, cut, _ = scal[bi]
        assert (k0_, nb) == (k0, len(block_bars))
        act, nw, perm, present = _card_window(rows, prev_act, k0, er, lo,
                                              cut, S, W)
        assert int(nw) == len(active)
        assert np.array_equal(act.numpy(), act_i)
        bars_d, tab_d = _card_tables(rows, rows.bars[k0:k0 + K], act, nb,
                                     nw, K, W)
        assert np.array_equal(bars_d.numpy(), bars_h[bi])
        assert np.array_equal(tab_d.numpy(), tab_h[bi])
        assert np.array_equal(present.numpy(), present_h[bi])
        if prev is not None:
            want_perm, _ = window_regather(prev, active)
            got = perm.numpy()[:len(active)]
            mask = present_h[bi][:len(active)]
            assert np.array_equal(got[mask], want_perm[mask])
        prev_act, prev = act, active


def _h2d(p, mode, **kw):
    telemetry.enable(True)
    telemetry.reset()
    try:
        r = check_wgl_witness(p, _CAS, transfer=mode, device="cpu", **kw)
        return _v(r), telemetry.counter_value("wgl.h2d-bytes")
    finally:
        telemetry.reset()
        telemetry.enable(False)


def test_h2d_bytes_by_mode(lanes):
    """Past a few chunks "indices" uploads less than "full", and
    "device" only its once-per-check tables."""
    p = pack_history(random_register_history(
        8000, procs=8, info_rate=0.05, seed=5), _CAS.encode)
    kw = dict(bars_per_block=128, blocks_per_call=2)
    got = {m: _h2d(p, m, **kw) for m in MODES}
    assert {v for v, _ in got.values()} == {True}
    full, idx, dev = (got[m][1] for m in MODES)
    assert 0 < dev < idx < full
    plan = _plan_blocks(p, 128, NARROW_INFO_WINDOW)
    W = wgl_witness._bucket(max(len(a) for _, _, a in plan[4]))
    bars_pad = wgl_witness._bucket(len(plan[0]) + 128, lo=128)
    assert dev == 4 * (7 * p.n + bars_pad + W)


def _ckpts(d):
    return sorted(glob.glob(os.path.join(str(d), "wgl-witness-*.ckpt.npz")))


@pytest.mark.parametrize("bad", [False, True])
def test_device_mode_resumes_from_a_checkpoint(bad, lanes, tmp_path,
                                               monkeypatch):
    p = pack_history(random_register_history(
        3000, procs=8, info_rate=0.05, seed=1, bad=bad), _CAS.encode)
    kw = dict(bars_per_block=64, blocks_per_call=2, device="cpu",
              transfer="device")
    real = wgl_witness.sweep
    calls = []
    monkeypatch.setattr(wgl_witness, "sweep",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    fresh_info, info_d = {}, {}
    fresh = check_wgl_witness(p, _CAS, out_info=fresh_info, **kw)
    n_fresh = len(calls)
    if bad:
        assert fresh is None and fresh_info["died_at_rank"] > 128

    # The budget runs out after the first chunk: it saves there.
    assert check_wgl_witness(p, _CAS, time_limit_s=1e-9,
                             checkpoint_dir=str(tmp_path), **kw) is None
    (path,) = _ckpts(tmp_path)
    with np.load(path) as z:
        assert int(z["c0"]) == 2
    del calls[:]
    res = check_wgl_witness(p, _CAS, checkpoint_dir=str(tmp_path),
                            out_info=info_d, **kw)
    assert _v(res) == _v(fresh)
    assert info_d == fresh_info
    assert not _ckpts(tmp_path)
    # The resume swept from block 2 on, not from block 0.
    assert 0 < len(calls) < n_fresh
