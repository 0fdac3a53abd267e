"""The port's 32-bit packed member lanes (jepsen_tpu_torch/ops/packing.py
and the packed engines) against the JAX package, on the CPU.

* Every case of tests/test_wgl_packed.py through the port
  (tests/torch_ported.py), but the `append_many` ones, which are
  `PackedBuilder`'s and held by tests/test_torch_packed_builder.py.
* The packing primitives against the JAX package's, with
  JEPSEN_WGL_PACKED unset on both sides: pack/unpack/set_bit/covers
  over W = 1, 31, 32, 33, 100, and the uint32 hashes bit for bit on
  words with the top bit set.
* The BFS, the batched BFS, the witness and the stream with packing at
  its default on both sides: equal verdicts, `configs_explored`,
  witness hit/miss and `died_at_rank` — exact.
* The degradation ladder: a device resource error sheds the packed
  lanes at the same beam before any halving, and never settles on the
  CPU."""

import numpy as np
import pytest
import torch

import jepsen_tpu.models as ref_models
from jepsen_tpu.history.packed import pack_history as ref_pack
from jepsen_tpu.ops import packing as ref_packing
from jepsen_tpu.ops.wgl import check_wgl_device as ref_device
from jepsen_tpu.ops.wgl_batched import check_wgl_batched as ref_batched
from jepsen_tpu.ops.wgl_stream import check_wgl_witness_stream as ref_stream
from jepsen_tpu.ops.wgl_witness import check_wgl_witness as ref_witness
from jepsen_tpu.utils.histgen import random_register_history as ref_gen
from jepsen_tpu_torch import convert
from jepsen_tpu_torch import models
from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.checker import Linearizable
from jepsen_tpu_torch.ops import degrade, packing, wgl
from jepsen_tpu_torch.ops.wgl import PACKED_ENV, check_wgl_device
from jepsen_tpu_torch.ops.wgl_batched import check_wgl_batched
from jepsen_tpu_torch.ops.wgl_stream import check_wgl_witness_stream
from jepsen_tpu_torch.ops.wgl_witness import check_wgl_witness
from jepsen_tpu_torch.telemetry import roofline
from jepsen_tpu_torch.utils.histgen import random_register_history

import torch_ported
from chip_smoke import packed_bfs_bound

PORTED = torch_ported.load("test_wgl_packed")
APPEND_MANY = ("test_append_many_byte_parity_fuzz",
               "test_append_many_snapshot_parity",
               "test_append_many_edge_pairings",
               "test_append_many_int32_overflow_guard")

#: One model pair per kind for the file (the JAX side compiles per
#: step function).
_REF_CAS = ref_models.cas_register().packed()
_CAS = models.cas_register().packed()

#: The JAX witness at the port's knobs (its defaults pick the same
#: block shape on the CPU; the Pallas sweep is TPU-only).
REF_WITNESS = dict(bars_per_block=2048, blocks_per_call=32, pallas="off")


@pytest.fixture(autouse=True)
def _default_packing(monkeypatch):
    """Packing at its default (on) on both sides, no fault injection,
    and one torch thread (the suite runs several test processes at
    once)."""
    monkeypatch.delenv(PACKED_ENV, raising=False)
    monkeypatch.delenv(degrade.FAULT_ENV, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", torch_ported.cases(PORTED,
                                                    exclude=APPEND_MANY))
def test_packed_cases_through_the_port(case, request):
    torch_ported.run(PORTED, case, request)


# -- primitives --------------------------------------------------------------


@pytest.mark.parametrize("W", [1, 31, 32, 33, 100])
def test_primitives_equal_the_reference(W):
    rng = np.random.default_rng(7 + W)
    x = rng.random((6, W)) < 0.5
    ok = rng.random((6, W)) < 0.4
    slots = rng.integers(0, W, size=6).astype(np.int32)
    want = np.asarray(ref_packing.pack_bits(x))
    got = packing.pack_bits(torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert got.shape == want.shape == (6, packing.n_words(W))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(packing.unpack_bits(got, W).numpy(),
                                  np.asarray(ref_packing.unpack_bits(want, W)))
    ok_w = packing.pack_bits(torch.from_numpy(ok))
    np.testing.assert_array_equal(
        packing.covers(got, ok_w).numpy(),
        np.asarray(ref_packing.covers(want, ref_packing.pack_bits(ok))))
    np.testing.assert_array_equal(
        packing.set_bit(got, torch.from_numpy(slots)).numpy().view(np.uint32),
        np.asarray(ref_packing.set_bit(want, slots)))
    np.testing.assert_array_equal(packing.popcount(got).numpy(),
                                  np.asarray(ref_packing.popcount(want)))
    np.testing.assert_array_equal(packing.np_pack_bits(x),
                                  ref_packing.np_pack_bits(x))


@pytest.mark.parametrize("Wp", [1, 2, 33])
@pytest.mark.parametrize("stream", [0, 1, 2, 3])
def test_hash_words_bit_exact(Wp, stream):
    rng = np.random.default_rng(100 * Wp + stream)
    words = (rng.integers(0, 1 << 32, size=(64, Wp), dtype=np.uint32)
             | np.uint32(1 << 31))
    consts = packing.hash_consts(Wp, stream)
    np.testing.assert_array_equal(consts, ref_packing.hash_consts(Wp, stream))
    want = np.asarray(ref_packing.hash_words(words, consts))
    got = packing.hash_words(torch.from_numpy(words.view(np.int32)), consts)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # State lanes (int32, negative values included) hash as the
    # reference's uint32 relabel does.
    states = rng.integers(-2**31, 2**31, size=(64, Wp), dtype=np.int32)
    np.testing.assert_array_equal(
        packing.hash_words(torch.from_numpy(states), consts).numpy(),
        np.asarray(ref_packing.hash_words(
            ref_packing.as_u32(states), consts)).astype(np.int64))


# -- engines at the default packing ------------------------------------------


def _register_packs(n, seeds, procs=8, info=0.06, bad=()):
    ref = [ref_pack(ref_gen(n, procs=procs, info_rate=info, seed=s,
                            bad_at=0.2 if s in bad else None),
                    _REF_CAS.encode) for s in seeds]
    return ref, convert.packs_across(ref)


@pytest.mark.parametrize("seed", range(6))
def test_bfs_equals_the_reference(seed):
    ref, port = _register_packs(140, [seed], bad=(1, 3, 5))
    want = ref_device(ref[0], _REF_CAS, witness=False)
    got = check_wgl_device(port[0], _CAS, witness=False, device="cpu")
    assert (got.valid, got.configs_explored, got.reason) == (
        want.valid, want.configs_explored, want.reason)


@pytest.mark.parametrize("procs", [40])
def test_bfs_wide_window_equals_the_reference(procs):
    """Windows past 32 ops and off the 32-lane boundary."""
    ref, port = _register_packs(120, [11, 12], procs=procs, info=0.1,
                                bad=(12,))
    for r, p in zip(ref, port):
        want = ref_device(r, _REF_CAS, witness=False)
        got = check_wgl_device(p, _CAS, witness=False, device="cpu")
        assert (got.valid, got.configs_explored) == (
            want.valid, want.configs_explored)


def test_device_route_equals_the_reference():
    """Witness then BFS through `check_wgl_device` at its defaults."""
    ref, port = _register_packs(400, [2, 3], bad=(3,))
    for r, p in zip(ref, port):
        want = ref_device(r, _REF_CAS)
        got = check_wgl_device(p, _CAS, device="cpu")
        assert (got.valid, got.configs_explored) == (
            want.valid, want.configs_explored)


@pytest.mark.parametrize("seed", [1, 3])
def test_packed_bfs_counts_its_live_rows(seed, monkeypatch):
    """With telemetry on, each packed BFS level counts the bytes and
    operations its live rows need (`roofline.packed_level_cost`), which
    `chip_smoke.packed_bfs_bound` reads for B9's bound: the totals are
    the per-level costs of the rows the expansion was given, the live
    children it made and the rows the dedup kept."""
    _, port = _register_packs(140, [seed], bad=(seed,))
    levels = []
    expand, dedup = wgl._expand_level_packed, wgl._dedup_sort

    def counted_expand(member, states, alive, tables, n_slots, pm):
        out = expand(member, states, alive, tables, n_slots, pm)
        levels.append([tables["ret_w"].shape[0], states.shape[1],
                       int(alive.sum()), int(out[2].sum())])
        return out

    def counted_dedup(*a):
        out = dedup(*a)
        levels[-1].append(min(int(out[3]), 1024))  # the default beam
        return out

    monkeypatch.setattr(wgl, "_expand_level_packed", counted_expand)
    monkeypatch.setattr(wgl, "_dedup_sort", counted_dedup)
    got = packed_bfs_bound(torch, port[0], _CAS, dev="cpu")
    costs = [roofline.packed_level_cost(*lv) for lv in levels]
    assert got["levels"] == len(levels) > 0
    assert got["bytes"] == sum(c["bytes_accessed"] for c in costs)
    assert got["operations"] == sum(c["flops"] for c in costs)
    assert (got["bound_ms"], got["bound_by"]) == roofline.bound(
        got["operations"], got["bytes"])


def test_batched_equals_the_reference():
    ref, port = _register_packs(60, range(10), procs=4, info=0.1,
                                bad=(0, 3, 6, 9))
    want = ref_batched(ref, _REF_CAS)
    got = check_wgl_batched(port, _CAS, device="cpu")
    assert got.valid == want.valid
    np.testing.assert_array_equal(got.explored, want.explored)
    assert got.beam_used == want.beam_used


@pytest.mark.parametrize("seed,bad", [(0, False), (1, True), (2, True)])
def test_witness_equals_the_reference(seed, bad):
    ref, port = _register_packs(3000, [seed], bad=(seed,) if bad else ())
    info_r, info_p = {}, {}
    want = ref_witness(ref[0], _REF_CAS, out_info=info_r, **REF_WITNESS)
    got = check_wgl_witness(port[0], _CAS, out_info=info_p, device="cpu")
    assert (got is None) == (want is None)
    assert info_p == info_r
    if want is not None:
        assert got.configs_explored == want.configs_explored


def test_stream_equals_the_reference():
    ref, port = _register_packs(100, range(16), procs=4, info=0.05,
                                bad=(4, 5, 11))
    want = ref_stream(ref, _REF_CAS, **REF_WITNESS)
    got = check_wgl_witness_stream(port, _CAS, device="cpu")
    assert got == want
    assert [i for i, v in enumerate(got) if v is not True] == [4, 5, 11]


# -- the degradation ladder --------------------------------------------------


def test_bfs_sheds_packing_then_halves_and_never_settles(monkeypatch):
    """Every BFS block faults: the first rung sheds the packed lanes at
    the same beam, the second halves it, and the search ends "unknown"
    with reason "device-resource-error" — never a CPU verdict."""
    _, port = _register_packs(140, [0])
    monkeypatch.setenv(degrade.FAULT_ENV, "device")
    with degrade.capture() as steps:
        res = check_wgl_device(port[0], _CAS, witness=False, device="cpu")
    actions = [s["action"] for s in steps if s["tier"] == "device"]
    assert actions == ["packed-fallback", "retry-halved", "fall-through"]
    assert (res.valid, res.reason) == ("unknown", "device-resource-error")


def test_witness_and_batched_shed_packing_first(monkeypatch):
    _, port = _register_packs(400, [9, 10], procs=6, info=0.02)
    monkeypatch.setenv(degrade.FAULT_ENV, "witness,batched")
    prior = telemetry.enabled()
    telemetry.enable(True)
    try:
        before = telemetry.counter_value("wgl.packed.fallbacks")
        with degrade.capture() as steps:
            assert check_wgl_witness(port[0], _CAS, device="cpu") is None
            res = check_wgl_batched(port, _CAS, device="cpu")
        after = telemetry.counter_value("wgl.packed.fallbacks")
    finally:
        telemetry.enable(prior)
    for tier in ("witness", "batched"):
        actions = [s["action"] for s in steps if s["tier"] == tier]
        assert actions[0] == "packed-fallback", (tier, actions)
        assert "retry-halved" in actions[1:], (tier, actions)
    assert res.valid == ["unknown", "unknown"]
    assert after - before == 2


def test_linearizable_faults_raise_after_shedding_packing(monkeypatch):
    """Through `Linearizable` with every tier faulting: the ladder sheds
    the packed lanes first and ends in `CardExhausted`, not a CPU
    verdict."""
    h = random_register_history(200, procs=8, info_rate=0.06, seed=4)
    monkeypatch.setenv(degrade.FAULT_ENV, "all")
    with degrade.capture() as steps:
        with pytest.raises(degrade.CardExhausted):
            Linearizable(models.cas_register(), device="cpu").check({}, h,
                                                                   {})
    actions = [(s["tier"], s["action"]) for s in steps]
    assert ("device", "packed-fallback") in actions
    first = actions.index(("device", "packed-fallback"))
    assert all(first < i for i, a in enumerate(actions)
               if a == ("device", "retry-halved"))
