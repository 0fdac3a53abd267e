"""Port parity for online checking (streaming/): the frontier carry
against the JAX package's `FrontierCarry` after every advance, online
against one-shot witness runs, the streaming session's verdicts and
their consumption by digest, and that a fault of the card or a kernel
raises out of the online path instead of becoming a dead frontier or a
broken session."""

import threading
import time

import numpy as np
import pytest
import torch

import jepsen_tpu.history.packed as ref_packed
import jepsen_tpu.models as ref_models
from jepsen_tpu.streaming.frontier import FrontierCarry as RefFrontier
from jepsen_tpu.utils.histgen import random_register_history as ref_gen
from jepsen_tpu_torch import device as D
from jepsen_tpu_torch.checker import Linearizable
from jepsen_tpu_torch.device import DeviceUnavailable
from jepsen_tpu_torch.history.core import History, Op, history
from jepsen_tpu_torch.history.packed import PackedBuilder, pack_history
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops import degrade, wgl_witness
from jepsen_tpu_torch.ops.packing import unpack_bits
from jepsen_tpu_torch.ops.kernels import KernelLaunchError
from jepsen_tpu_torch.ops.wgl_witness import (_plan_blocks,
                                              check_wgl_witness,
                                              compact_width, initial_carry,
                                              plan_width, run_chunks)
from jepsen_tpu_torch.parallel import (KV, IndependentChecker,
                                       clear_settle_memo, subhistories)
from jepsen_tpu_torch.parallel.independent import (_memo_get, _memo_put,
                                                   _settle_digest,
                                                   invalidate_settle_memo)
from jepsen_tpu_torch.streaming import (FrontierCarry, StreamingSession,
                                        maybe_session, streaming_enabled)
from jepsen_tpu_torch.streaming import pipeline
from jepsen_tpu_torch.utils.histgen import random_register_history

#: A session that ingests only when finish() wakes it: one batch, so a
#: test sees the same proofs on every run.
ONE_BATCH = dict(swap_ops=1 << 30, swap_interval_s=3600.0, device="cpu")

#: One model pair for the file: the JAX frontier compiles its chunk
#: program per model; both packages see the same ops in the same order,
#: so their interners stay equal.
_PAIR = {}


def _pair():
    if not _PAIR:
        _PAIR["pm"] = (cas_register().packed(),
                       ref_models.cas_register().packed())
    return _PAIR["pm"]


@pytest.fixture(autouse=True)
def _fresh_state():
    clear_settle_memo()
    yield
    clear_settle_memo()


def _same_carry(fr, rf):
    assert (fr.dead, fr.blocks_done, fr.bars_done, fr.chunks) == (
        rf.dead, rf.blocks_done, rf.bars_done, rf.chunks)
    if fr.dead or rf._member is None:
        assert fr._member is None
        return
    assert fr._W == rf._W
    # The port carries the window packed into words by default
    # (JEPSEN_WGL_PACKED); the reference's frontier carries it as bools.
    np.testing.assert_array_equal(
        unpack_bits(fr._member, fr.B).numpy() if fr.packed
        else fr._member.numpy(), np.asarray(rf._member))
    np.testing.assert_array_equal(fr._states.numpy(),
                                  np.asarray(rf._states))
    np.testing.assert_array_equal(fr._alive.numpy(), np.asarray(rf._alive))
    np.testing.assert_array_equal(fr._prev_active, rf._prev_active)


@pytest.mark.parametrize("n,info,bad_at,every", [
    (3000, 0.05, None, 300),   # valid: finalize True
    (1200, 0.0, 0.5, 200),     # an impossible read halfway: dies
    (0, 0.0, None, 1),         # empty: trivially True
])
def test_frontier_equals_the_jax_frontier(n, info, bad_at, every):
    """The same stream advanced in the same slices (K = 64) through
    both frontiers: member, states and alive, block, barrier and chunk
    counts, and life or death equal after every advance, and the
    finalize result too."""
    pm, ref_pm = _pair()
    kw = dict(procs=6, info_rate=info, seed=13, bad_at=bad_at)
    ops = list(random_register_history(n, **kw)) if n else []
    ref_ops = list(ref_gen(n, **kw)) if n else []
    b = PackedBuilder(pm.encode)
    rb = ref_packed.PackedBuilder(ref_pm.encode)
    fr = FrontierCarry(pm, bars_per_block=64, device="cpu")
    rf = RefFrontier(ref_pm, bars_per_block=64)
    for i, (o, ro) in enumerate(zip(ops, ref_ops)):
        b.append(o)
        rb.append(ro)
        if i % every == every - 1:
            packed, s = b.snapshot()
            rpacked, rs = rb.snapshot()
            fr.advance(packed, s)
            rf.advance(rpacked, rs)
            _same_carry(fr, rf)
    got = fr.finalize(b.finish())
    want = rf.finalize(rb.finish())
    assert got == want
    _same_carry(fr, rf)
    assert got is (None if bad_at is not None else True)
    if n:
        assert fr.chunks > 1  # the carry crossed advances


def _counting_sweeps(monkeypatch):
    calls = []
    real = wgl_witness.sweep

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(wgl_witness, "sweep", counting)
    return calls


def test_online_equals_one_shot_with_a_narrower_window(monkeypatch):
    """A stream whose window grows 256 -> 1024 while it arrives: the
    online run's early blocks run at a narrower W (and compact tile)
    than the one-shot run's, yet both make the same sweeps and chain
    rounds and prove the stream."""
    pm = cas_register().packed()
    h = random_register_history(4000, procs=8, info_rate=0.3, seed=11)
    sweeps = _counting_sweeps(monkeypatch)
    b = PackedBuilder(pm.encode)
    fr = FrontierCarry(pm, bars_per_block=64, device="cpu")
    widths = []
    D.counters.clear()
    for i, op in enumerate(h):
        b.append(op)
        if i % 500 == 499:
            fr.advance(*b.snapshot())
            widths.append(fr._W)
    final = b.finish()
    assert fr.finalize(final) is True
    online = (len(sweeps), D.counters["heavy_rounds"])
    sweeps.clear()
    D.counters.clear()
    res = check_wgl_witness(final, pm, bars_per_block=64, blocks_per_call=8,
                            device="cpu")
    assert res.valid is True
    assert online == (len(sweeps), D.counters["heavy_rounds"])
    assert online[1] > 0
    assert widths[0] < plan_width(final, 64) == fr._W == 1024


def test_compact_tile_selects_the_full_tiles_children():
    """The chain rounds' compact tile against the full (W, B) tile on
    the same blocks: identical carries after every chunk."""
    pm = cas_register().packed()
    packed = pack_history(random_register_history(
        3000, procs=8, info_rate=0.3, seed=5), pm.encode)
    plan = _plan_blocks(packed, 64, 512)
    W = plan_width(packed, 64, 512)
    dev = torch.device("cpu")
    runs = []
    for compact in (compact_width(W, 512), 64, 0):
        D.counters.clear()
        runs.append([(c, failed) for c, _, failed, _ in run_chunks(
            pm, packed, plan, plan[4], initial_carry(pm, W, 8, dev),
            K=64, NB=4, D=5, compact=compact, dev=dev)])
        assert D.counters["heavy_rounds"] > 0
    for other in runs[1:]:
        assert len(other) == len(runs[0])
        for (c1, f1), (c2, f2) in zip(runs[0], other):
            assert f1 == f2
            for t1, t2 in zip(c1[:3], c2[:3]):
                assert torch.equal(t1, t2)


def test_frontier_incremental_matches_oneshot():
    pm = cas_register().packed()
    h = random_register_history(3000, procs=8, info_rate=0.05, seed=11)
    b = PackedBuilder(pm.encode)
    fr = FrontierCarry(pm, bars_per_block=64, device="cpu")
    for i, op in enumerate(h):
        b.append(op)
        if i % 400 == 399:
            fr.advance(*b.snapshot())
    assert fr.blocks_done > 0, "no mid-run progress"
    final = b.finish()
    assert fr.finalize(final) is True
    assert check_wgl_witness(final, pm, bars_per_block=64,
                             device="cpu").valid is True


def test_frontier_dies_on_invalid_stream():
    pm = cas_register().packed()
    h = random_register_history(1200, procs=6, info_rate=0.0, seed=13,
                                bad_at=0.5)
    b = PackedBuilder(pm.encode)
    fr = FrontierCarry(pm, bars_per_block=64, device="cpu")
    D.counters.clear()
    for i, op in enumerate(h):
        b.append(op)
        if i % 300 == 299:
            fr.advance(*b.snapshot())
    assert fr.finalize(b.finish()) is None
    assert fr.dead and D.counters["frontier_deaths"] == 1
    assert D.counters["online_advances"] >= 1


def test_frontier_empty_stream_trivially_true():
    pm = cas_register().packed()
    fr = FrontierCarry(pm, device="cpu")
    assert fr.finalize(PackedBuilder(pm.encode).finish()) is True


def test_frontier_window_past_max_dies():
    pm = cas_register().packed()
    h = random_register_history(2000, procs=8, info_rate=0.3, seed=3)
    fr = FrontierCarry(pm, bars_per_block=64, info_window=None,
                       max_window=256, device="cpu")
    assert fr.finalize(pack_history(h, pm.encode)) is None
    assert fr.dead and "exceeds max" in fr.dead_reason


def test_snapshot_is_prefix_of_final():
    pm = cas_register().packed()
    h = random_register_history(800, procs=8, info_rate=0.05, seed=17)
    b = PackedBuilder(pm.encode)
    cuts = []
    for i, op in enumerate(h):
        b.append(op)
        if i % 200 == 199:
            cuts.append(b.snapshot())
    final = b.finish()
    for packed, s in cuts:
        n = packed.n
        assert (packed.inv < s).all()
        assert (packed.inv == final.inv[:n]).all()
        assert (packed.ret == final.ret[:n]).all()
        assert (packed.f == final.f[:n]).all()
        assert not packed.preds.any()  # witness-only


# ---------------------------------------------------------------------------
# Sessions


def _keyed_streams(gen, kv, shapes, seed):
    """One register stream per (ops, bad) shape, each op's value wrapped
    as key k<i>'s; processes disjoint per key."""
    streams = []
    for i, (n, bad) in enumerate(shapes):
        sub = gen(n, procs=2, info_rate=0.0, cas=False, seed=seed + i,
                  bad=bad)
        streams.append([o.replace(value=kv(f"k{i}", o.value),
                                  process=i * 4 + o.process) for o in sub])
    return streams


def _keyed_mixed_history(n_keys, ops_per_key, *, bad_every=7,
                         seed=45100) -> History:
    """n_keys register streams, every `bad_every`-th with an impossible
    read, merged round-robin."""
    return history(_round_robin(_keyed_streams(
        random_register_history, KV,
        [(ops_per_key, i % bad_every == 0) for i in range(n_keys)], seed)))


def _round_robin(streams) -> list:
    merged = []
    pos = [0] * len(streams)
    remaining = sum(len(s) for s in streams)
    while remaining:
        for i, s in enumerate(streams):
            if pos[i] < len(s):
                merged.append(s[pos[i]])
                pos[i] += 1
                remaining -= 1
    return merged


def _feed_all(sess, h) -> dict:
    for op in h:
        sess.feed(op)
    return sess.finish()


def _wait_until(cond, timeout_s: float = 20.0) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def test_parity_200_key_mixed_validity():
    """Online and post-hoc checking give identical per-key verdicts on
    200 keys; every valid key is proven online and consumed."""
    pm = cas_register().packed()
    h = _keyed_mixed_history(200, 14)
    sess = StreamingSession(pm, recheck_min_rows=4, **ONE_BATCH)
    D.counters.clear()
    stats = _feed_all(sess, h)
    assert not sess.broken, sess.broken_reason
    assert stats["mode"] == "keyed" and stats["keys"] == 200
    n_bad = len(range(0, 200, 7))
    assert stats["proven-online"] == 200 - n_bad

    online = IndependentChecker(Linearizable(cas_register(), device="cpu"),
                                device="cpu").check(
        {"streaming-session": sess}, h, {})
    clear_settle_memo()  # the post-hoc run must not replay online memos
    posthoc = IndependentChecker(Linearizable(cas_register(), device="cpu"),
                                 streaming=False, device="cpu").check({}, h, {})
    assert set(online["results"]) == set(posthoc["results"])
    for k, r in posthoc["results"].items():
        assert online["results"][k]["valid"] == r["valid"], k
    assert sorted(online["failures"]) == sorted(posthoc["failures"])
    assert online["valid"] == posthoc["valid"] is False
    consumed = [k for k, r in online["results"].items()
                if r.get("algorithm") == "wgl-online"]
    assert len(consumed) == online["tiers"]["online"] == 200 - n_bad
    assert D.counters["online_consumed"] == 200 - n_bad
    assert "online" not in posthoc["tiers"]


def test_big_keys_run_frontiers_as_in_the_jax_session(monkeypatch):
    """Keys past FRONTIER_ROWS leave the batched stream proofs for a
    FrontierCarry each, advanced while the batch is ingested and
    concluded at finish().  Both packages' sessions give the same keys
    frontiers that run the same blocks and die alike, and prove the same
    keys online; every online verdict is the exact post-hoc one."""
    import jepsen_tpu.history.core as ref_hc
    from jepsen_tpu.parallel.independent import KV as RefKV
    from jepsen_tpu.streaming.pipeline import StreamingSession as RefSession

    monkeypatch.setenv("JEPSEN_PLAN", "0")
    monkeypatch.setattr(pipeline, "FRONTIER_ROWS", 512)
    pm, ref_pm = _pair()
    # Three keys past 512 rows (one bad) and three small ones (one bad).
    shapes = [(3000, False), (2600, True), (2400, False), (60, False),
              (60, True), (80, False)]
    h = history(_round_robin(_keyed_streams(
        random_register_history, KV, shapes, 700)))
    ref_h = ref_hc.history(_round_robin(_keyed_streams(
        ref_gen, RefKV, shapes, 700)))
    sess = StreamingSession(pm, advance_rows=256, recheck_min_rows=4,
                            **ONE_BATCH)
    ref = RefSession(ref_pm, swap_ops=1 << 30, swap_interval_s=3600.0,
                     frontier_rows=512, advance_rows=256,
                     recheck_min_rows=4)
    D.counters.clear()
    stats = _feed_all(sess, h)
    ref_stats = _feed_all(ref, ref_h)
    assert not sess.broken and not ref.broken
    assert sorted(sess._frontiers) == sorted(ref._frontiers) == [
        "k0", "k1", "k2"]
    assert stats["key-frontiers"] == ref_stats["key-frontiers"] == 3
    for k, fr in sess._frontiers.items():
        rf = ref._frontiers[k]
        assert (fr.dead, fr.blocks_done, fr.bars_done) == (
            rf.dead, rf.blocks_done, rf.bars_done), k
    assert sess._frontiers["k1"].dead
    assert D.counters["online_advances"] == 3  # one per big key, mid-ingest
    assert ({k: v["res"] for k, v in sess._verdicts.items()}
            == {k: v["res"] for k, v in ref._verdicts.items()})
    assert sorted(sess._verdicts) == ["k0", "k2", "k3", "k5"]

    online = IndependentChecker(Linearizable(cas_register(), device="cpu"),
                                device="cpu").check(
        {"streaming-session": sess}, h, {})
    clear_settle_memo()
    posthoc = IndependentChecker(Linearizable(cas_register(), device="cpu"),
                                 streaming=False, device="cpu").check({}, h, {})
    for k, r in posthoc["results"].items():
        assert online["results"][k]["valid"] == r["valid"], k
    assert sorted(online["failures"]) == sorted(posthoc["failures"]) == [
        "k1", "k4"]
    assert sorted(k for k, r in online["results"].items()
                  if r.get("algorithm") == "wgl-online") == [
        "k0", "k2", "k3", "k5"]


def test_single_stream_consumed_by_linearizable():
    pm = cas_register().packed()
    h = random_register_history(1500, procs=8, info_rate=0.02, seed=3)
    sess = StreamingSession(pm, advance_rows=256, **ONE_BATCH)
    D.counters.clear()
    stats = _feed_all(sess, h)
    assert not sess.broken, sess.broken_reason
    assert stats["mode"] == "single" and stats["proven-online"] == 1
    assert stats["frontier"]["chunks"] >= 1 and stats["verdict-lag-s"] >= 0
    assert D.counters["online_advances"] >= 1
    res = Linearizable(cas_register(), device="cpu").check(
        {"streaming-session": sess}, h, {})
    assert res["valid"] is True and res["algorithm"] == "wgl-online"


def test_single_stream_fed_live_by_a_producer_thread():
    """A producer thread feeds while the checker thread advances the
    frontier mid-run; the verdict is consumed afterwards."""
    pm = cas_register().packed()
    h = random_register_history(3000, procs=8, info_rate=0.05, seed=21)
    sess = StreamingSession(pm, swap_ops=128, swap_interval_s=0.01,
                            advance_rows=200, device="cpu")

    def produce():
        for i, op in enumerate(h):
            sess.feed(op)
            if i % 500 == 499:
                time.sleep(0.05)

    t = threading.Thread(target=produce)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    stats = sess.finish()
    assert not sess.broken and stats["swaps"] > 1
    assert Linearizable(cas_register(), device="cpu").check(
        {"streaming-session": sess}, h, {})["algorithm"] == "wgl-online"


def test_streaming_false_ignores_session():
    pm = cas_register().packed()
    h = random_register_history(400, procs=4, info_rate=0.0, seed=5)
    sess = StreamingSession(pm, **ONE_BATCH)
    _feed_all(sess, h)
    res = Linearizable(cas_register(), streaming=False, device="cpu").check(
        {"streaming-session": sess}, h, {})
    assert res["valid"] is True
    assert res.get("algorithm") != "wgl-online"


def test_session_of_another_model_is_not_consumed():
    from jepsen_tpu_torch.models import register

    h = random_register_history(400, procs=4, info_rate=0.0, cas=False,
                                seed=5)
    sess = StreamingSession(register().packed(), **ONE_BATCH)
    _feed_all(sess, h)
    assert sess.proven == 1
    res = Linearizable(cas_register(), device="cpu").check(
        {"streaming-session": sess}, h, {})
    assert res["valid"] is True and res["algorithm"] != "wgl-online"


def test_regrown_key_invalidates_and_reproves():
    pm = cas_register().packed()
    key_ops = [("invoke", "write", 1), ("ok", "write", 1),
               ("invoke", "read", None), ("ok", "read", 1)]

    def kops(start):
        return [Op(type=t, f=f, value=KV("a", v), process=0,
                   index=start + i)
                for i, (t, f, v) in enumerate(key_ops)]

    sess = StreamingSession(pm, swap_ops=1, recheck_min_rows=1,
                            device="cpu")
    D.counters.clear()
    for op in kops(0):
        sess.feed(op)
    assert _wait_until(lambda: sess.proven == 1), sess.stats()
    first = sess._verdicts["a"]["digest"]
    assert _memo_get(first) is not None
    # More ops for the key: the verdict (and its memo entry) is dropped,
    # then proven again by finish().
    for op in kops(100):
        sess.feed(op)
    assert _wait_until(lambda: sess.stats()["rechecks"] >= 1)
    stats = sess.finish()
    assert not sess.broken, sess.broken_reason
    assert stats["proven-online"] == 1
    assert D.counters["online_rechecks"] >= 1
    assert _memo_get(first) is None
    # The verdict covers the whole history's digest, not the half's.
    full = history(kops(0) + kops(100))
    sub = subhistories(full)["a"]
    d = _settle_digest(pack_history(History(sub), pm.encode), pm)
    assert sess.consume("a", d) is not None
    assert sess.consume("a", "bogus") is None


def test_invalidate_settle_memo_is_keyed():
    _memo_put("d1", {"valid": True})
    _memo_put("d2", {"valid": True})
    invalidate_settle_memo("d1")
    assert _memo_get("d1") is None
    assert _memo_get("d2") == {"valid": True}
    invalidate_settle_memo("never-existed")  # no-op


def test_online_digest_uses_the_sessions_code_space():
    """The session interned values in journal order; a checker with a
    fresh model interns them in its own order.  The digest is taken in
    the session's code space, so the proof is still consumed."""
    h = random_register_history(300, procs=3, info_rate=0.0, seed=9)
    sess = StreamingSession(cas_register().packed(), **ONE_BATCH)
    _feed_all(sess, h)
    fresh = cas_register().packed()
    fresh.encode(Op(type="invoke", f="write", value=4, process=0),
                 Op(type="ok", f="write", value=4, process=0))
    assert (_settle_digest(pack_history(h, fresh.encode), fresh)
            != sess._verdicts[None]["digest"])
    from jepsen_tpu_torch.parallel.independent import _online_digest

    d = _online_digest(sess, fresh, h)
    assert sess.consume(None, d)["algorithm"] == "wgl-online"


def test_streaming_enabled_and_maybe_session(monkeypatch):
    monkeypatch.delenv("JEPSEN_STREAMING", raising=False)
    assert not streaming_enabled({})
    assert streaming_enabled({"streaming": True})
    monkeypatch.setenv("JEPSEN_STREAMING", "1")
    assert streaming_enabled({})
    assert maybe_session({}) is None
    sess = maybe_session({"model": cas_register()}, device="cpu")
    assert isinstance(sess, StreamingSession)
    sess.finish()


# ---------------------------------------------------------------------------
# Faults: a device fault raises; out of memory ends a frontier


def _raising_sweep(monkeypatch, exc):
    def sweep(*a, **kw):
        raise exc

    monkeypatch.setattr(wgl_witness, "sweep", sweep)


def test_no_card_raises_at_once(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pm = cas_register().packed()
    with pytest.raises(DeviceUnavailable):
        FrontierCarry(pm)
    with pytest.raises(DeviceUnavailable):
        StreamingSession(pm)


def test_kernel_fault_raises_out_of_advance(monkeypatch):
    pm = cas_register().packed()
    b = PackedBuilder(pm.encode)
    for op in random_register_history(500, procs=4, info_rate=0.0, seed=1):
        b.append(op)
    _raising_sweep(monkeypatch, KernelLaunchError("witness_sweep: launch"))
    fr = FrontierCarry(pm, bars_per_block=64, device="cpu")
    with pytest.raises(KernelLaunchError):
        fr.advance(*b.snapshot())
    assert not fr.dead and isinstance(fr.fault, KernelLaunchError)
    with pytest.raises(KernelLaunchError):
        fr.finalize(b.finish())


def _fault_from_the_second_chunk(monkeypatch):
    """The sweep raises from the second chunk of each run of chunks on:
    the fault lands after the carry has moved."""
    from jepsen_tpu_torch.streaming import frontier as frontier_mod

    real = frontier_mod.run_chunks

    def sweep(*a, **kw):
        raise KernelLaunchError("witness_sweep: lost hand-off (death -1)")

    def run_chunks(*a, **kw):
        it = real(*a, **kw)
        yield next(it)
        monkeypatch.setattr(wgl_witness, "sweep", sweep)
        yield from it

    monkeypatch.setattr(frontier_mod, "run_chunks", run_chunks)


def test_a_fault_after_a_chunk_stops_the_frontier_for_good(monkeypatch):
    """A fault after the first chunk of an advance: the frontier keeps
    it, and every later advance or finalize raises it again, even once
    the card works: the carry never resumes past the fault, and the
    frontier never reports True."""
    pm = cas_register().packed()
    b = PackedBuilder(pm.encode)
    for op in random_register_history(3000, procs=4, info_rate=0.0, seed=2):
        b.append(op)
    _fault_from_the_second_chunk(monkeypatch)
    fr = FrontierCarry(pm, bars_per_block=64, blocks_per_call=2,
                       device="cpu")
    with pytest.raises(KernelLaunchError):
        fr.advance(*b.snapshot())
    assert (fr.chunks, fr.blocks_done, fr.dead) == (1, 2, False)
    monkeypatch.undo()  # the card works again
    with pytest.raises(KernelLaunchError):
        fr.advance(*b.snapshot())
    with pytest.raises(KernelLaunchError):
        fr.finalize(b.finish())
    assert (fr.chunks, fr.blocks_done) == (1, 2)


@pytest.mark.parametrize("where", ["checker-thread", "finalize", "keyed"])
def test_kernel_fault_raises_out_of_finish(monkeypatch, where):
    """A kernel fault on the checker thread (an advance, or a keyed
    stream pass) or in the final proofs: finish() raises it, and feed()
    takes no more ops."""
    pm = cas_register().packed()
    if where == "keyed":
        h = _keyed_mixed_history(6, 10)
    else:
        # Past one 1,024-barrier block, so an advance runs a block.
        h = random_register_history(3000, procs=4, info_rate=0.0, seed=2)
    _raising_sweep(monkeypatch, KernelLaunchError("witness_sweep: launch"))
    sess = StreamingSession(
        pm, advance_rows=64 if where == "checker-thread" else 1 << 30,
        swap_ops=len(h), swap_interval_s=3600.0, device="cpu")
    for op in h:
        sess.feed(op)
    if where != "finalize":
        assert _wait_until(lambda: sess.fault is not None)
        sess.feed(h[0])
        assert sess._buf.take() == []
    with pytest.raises(KernelLaunchError):
        sess.finish()
    assert not sess.broken
    with pytest.raises(KernelLaunchError):
        sess.finish()


def test_out_of_memory_ends_the_frontier_and_is_recorded(monkeypatch):
    pm = cas_register().packed()
    h = random_register_history(500, procs=4, info_rate=0.0, seed=1)
    b = PackedBuilder(pm.encode)
    for op in h:
        b.append(op)
    _raising_sweep(monkeypatch, torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    fr = FrontierCarry(pm, bars_per_block=64, device="cpu")
    D.counters.clear()
    with degrade.capture() as steps:
        fr.advance(*b.snapshot())
    assert fr.dead and "out of memory" in fr.dead_reason
    assert [(s["tier"], s["action"]) for s in steps] == [("frontier", "die")]
    assert D.counters["frontier_deaths"] == 1
    assert fr.finalize(b.finish()) is None


def test_out_of_memory_in_a_session_falls_back_post_hoc(monkeypatch):
    pm = cas_register().packed()
    h = random_register_history(3000, procs=4, info_rate=0.0, seed=4)
    real = wgl_witness.sweep
    _raising_sweep(monkeypatch, torch.cuda.OutOfMemoryError("out of memory"))
    sess = StreamingSession(pm, advance_rows=64, **ONE_BATCH)
    stats = _feed_all(sess, h)
    assert not sess.broken and stats["proven-online"] == 0
    assert stats["frontier"]["dead"].startswith("device out of memory")
    monkeypatch.setattr(wgl_witness, "sweep", real)
    res = Linearizable(cas_register(), device="cpu").check(
        {"streaming-session": sess}, h, {})
    assert res["valid"] is True and res["algorithm"] != "wgl-online"


def test_kv_op_in_single_mode_breaks_the_session():
    pm = cas_register().packed()
    ops = list(random_register_history(50, procs=2, info_rate=0.0, seed=6))
    ops.append(Op(type="invoke", f="write", value=KV("a", 1), process=0))
    sess = StreamingSession(pm, **ONE_BATCH)
    stats = _feed_all(sess, history(ops))
    assert sess.broken and "KV op" in stats["broken"]
    assert stats["proven-online"] == 0


def test_finish_raises_when_the_checker_thread_does_not_stop(monkeypatch):
    pm = cas_register().packed()
    release = threading.Event()
    entered = threading.Event()

    def stuck(batch):
        entered.set()
        release.wait(30)

    monkeypatch.setattr(pipeline, "JOIN_TIMEOUT_S", 0.2)
    sess = StreamingSession(pm, swap_ops=1, device="cpu")
    monkeypatch.setattr(sess, "_ingest", stuck)
    sess.feed(Op(type="invoke", f="write", value=1, process=0))
    assert entered.wait(10)
    with pytest.raises(RuntimeError, match="still running"):
        sess.finish()
    assert not sess.finished
    release.set()
    sess._thread.join(10)
    assert not sess._thread.is_alive()
