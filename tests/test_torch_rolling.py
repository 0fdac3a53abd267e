"""Port parity for rolling-window online checking (monitor/rolling.py):
with discards the per-key verdicts equal the undiscarded run's and the
JAX package's `RollingChecker`'s on the same stream, resident history
stays bounded, a dead epoch is "unknown", and `FrontierCarry.rebase`
refuses a misaligned shift."""

import pytest

from jepsen_tpu.models import cas_register as ref_cas_register
from jepsen_tpu.monitor.loop import _OpSource
from jepsen_tpu.monitor.rolling import RollingChecker as RefRolling
from jepsen_tpu_torch import device as D
from jepsen_tpu_torch.history.core import Op
from jepsen_tpu_torch.history.packed import PackedBuilder
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.monitor import RollingChecker
from jepsen_tpu_torch.ops import wgl_witness
from jepsen_tpu_torch.ops.kernels import KernelLaunchError
from jepsen_tpu_torch.streaming import FrontierCarry

#: One model pair for the file (the JAX frontier compiles per model).
_PAIR = {}


def _pms():
    if not _PAIR:
        _PAIR["pm"] = (cas_register().packed(),
                       ref_cas_register().packed())
    return _PAIR["pm"]


def _port_op(o) -> Op:
    return Op(type=o.type, f=o.f, value=o.value, process=o.process,
              index=o.index)


def _events(n, *, keys=3, info_rate=0.0, seed=11):
    """The JAX monitor's keyed register source: n (key, op) events."""
    src = _OpSource(keys, 3, seed, info_rate)
    return [src.next_event() for _ in range(n)]


def _kw(**kw):
    kw.setdefault("bars_per_block", 16)
    kw.setdefault("blocks_per_call", 2)
    kw.setdefault("beam", 6)
    kw.setdefault("advance_rows", 300)  # misaligned with K * NB = 32
    return kw


def _drive(checker, events, port=True):
    for i, (key, op) in enumerate(events):
        checker.feed(key, _port_op(op) if port else op, float(i))
    return checker.finish(), checker.status()


def test_discard_parity_all_ok():
    """All-OK streams discard often; the verdicts equal the undiscarded
    run's, and at least one discard lands mid-chunk (not on a K * NB
    advance boundary)."""
    pm, _ = _pms()
    events = _events(9000)
    c1 = RollingChecker(pm, discard=True, device="cpu", **_kw())
    mid_chunk = False
    seen = set()
    for i, (key, op) in enumerate(events):
        c1.feed(key, _port_op(op), float(i))
        for ks in c1._keys.values():
            if ks.discarded_bars and ks.discarded_bars not in seen:
                seen.add(ks.discarded_bars)
                mid_chunk |= ks.discarded_bars % (16 * 2) != 0
    v1, s1 = c1.finish(), c1.status()
    v2, s2 = _drive(RollingChecker(pm, discard=False, device="cpu",
                                   **_kw()), events)
    assert v1 == v2 == {0: True, 1: True, 2: True}
    assert s1["discarded-rows"] > 0 and s2["discarded-rows"] == 0
    assert s1["resident-rows"] < s2["resident-rows"]
    assert mid_chunk, "no discard landed mid-chunk"


@pytest.mark.parametrize("info_rate,seed", [(0.0, 11), (0.15, 5)])
@pytest.mark.parametrize("discard", [True, False])
def test_rolling_equals_the_jax_rolling_checker(info_rate, seed, discard):
    """The same keyed stream through both packages: the verdicts and
    the status (resident, discarded and processed rows, epoch restarts)
    are equal."""
    pm, ref_pm = _pms()
    events = _events(6000, info_rate=info_rate, seed=seed)
    got = _drive(RollingChecker(pm, discard=discard, device="cpu", **_kw()),
                 events)
    want = _drive(RefRolling(ref_pm, discard=discard, **_kw()), events,
                  port=False)
    assert got[0] == want[0]
    for k in ("keys", "resident-rows", "discarded-rows", "blocks-done",
              "epoch-restarts"):
        assert got[1][k] == want[1][k], k


def test_discard_parity_with_info():
    """Info ops pin the all-OK prefix, so discards may be rare, but the
    verdicts still match."""
    pm, _ = _pms()
    events = _events(8000, info_rate=0.15, seed=5)
    v1, _ = _drive(RollingChecker(pm, discard=True, device="cpu", **_kw()),
                   events)
    v2, _ = _drive(RollingChecker(pm, discard=False, device="cpu", **_kw()),
                   events)
    assert v1 == v2


def test_discard_parity_invalid_prefix():
    """A non-linearizable prefix kills the frontier; with history gone
    there is no escalation, so both modes settle on "unknown"."""
    pm, _ = _pms()

    def run(discard):
        c = RollingChecker(pm, discard=discard, device="cpu",
                           **_kw(advance_rows=200))
        bad = [
            Op(type="invoke", f="write", value=1, process=0, index=1),
            Op(type="ok", f="write", value=1, process=0, index=2),
            Op(type="invoke", f="read", value=None, process=1, index=3),
            Op(type="ok", f="read", value=2, process=1, index=4),
        ]
        for op in bad:
            c.feed(0, op, 0.0)
        for i, (_, op) in enumerate(_events(2000, keys=1, seed=23)):
            c.feed(0, _port_op(op), float(i))
        return c.finish(), c.status()

    D.counters.clear()
    v1, s1 = run(True)
    v2, s2 = run(False)
    assert v1 == v2 == {0: "unknown"}
    assert s1["epoch-restarts"] >= 1 and s2["epoch-restarts"] >= 1
    assert D.counters["frontier_deaths"] >= 2


def test_resident_rows_stay_bounded():
    """A long all-OK run: resident rows stay a small share of the
    stream's rows."""
    pm, _ = _pms()
    c = RollingChecker(pm, discard=True, device="cpu", **_kw())
    peak = 0
    for i, (key, op) in enumerate(_events(30000)):
        c.feed(key, _port_op(op), float(i))
        if i % 500 == 0:
            peak = max(peak, c.resident_rows())
    st = c.status()
    total = st["discarded-rows"] + st["resident-rows"]
    assert c.finish() == {0: True, 1: True, 2: True}
    assert st["discarded-rows"] > 0.7 * total
    assert peak < 0.3 * total
    assert c.verdict_lag_s(now=30000.0) >= 0.0
    assert c.proven_rows() > 0
    assert all(e["unknown"] == 0 for e in c.epochs().values())


def test_feed_many_and_pump():
    pm, _ = _pms()
    c = RollingChecker(pm, discard=True, device="cpu", **_kw())
    by_key = {}
    for key, op in _events(3000):
        by_key.setdefault(key, []).append(_port_op(op))
    for key, ops in by_key.items():
        for i in range(0, len(ops), 400):
            c.feed_many(key, ops[i:i + 400])
    c.pump()
    assert all(ks.rows_at_advance == ks.packer.n_rows
               for ks in c._keys.values())
    assert c.finish() == {0: True, 1: True, 2: True}


def test_kernel_fault_raises_out_of_the_monitor(monkeypatch):
    pm, _ = _pms()

    def sweep(*a, **kw):
        raise KernelLaunchError("witness_sweep: launch")

    monkeypatch.setattr(wgl_witness, "sweep", sweep)
    c = RollingChecker(pm, discard=True, device="cpu", **_kw())
    with pytest.raises(KernelLaunchError):
        for i, (key, op) in enumerate(_events(3000)):
            c.feed(key, _port_op(op), float(i))
    assert c.status()["epoch-restarts"] == 0


def test_a_fault_mid_advance_never_yields_a_verdict(monkeypatch):
    """A fault after the first chunk of an advance, caught by a monitor
    loop that keeps feeding: every later advance of that key raises it
    again, and finish() raises it instead of a verdict, even once the
    card works."""
    from jepsen_tpu_torch.streaming import frontier as frontier_mod

    pm, _ = _pms()
    real = frontier_mod.run_chunks

    def sweep(*a, **kw):
        raise KernelLaunchError("witness_sweep: lost hand-off (death -1)")

    def run_chunks(*a, **kw):
        it = real(*a, **kw)
        yield next(it)
        monkeypatch.setattr(wgl_witness, "sweep", sweep)
        yield from it

    monkeypatch.setattr(frontier_mod, "run_chunks", run_chunks)
    c = RollingChecker(pm, discard=True, device="cpu", **_kw())
    faults = 0
    for i, (key, op) in enumerate(_events(3000)):
        try:
            c.feed(key, _port_op(op), float(i))
        except KernelLaunchError:
            faults += 1
    assert faults > len(c._keys) == 3  # each key, and again after
    blocks = {k: ks.frontier.blocks_done for k, ks in c._keys.items()}
    monkeypatch.undo()
    with pytest.raises(KernelLaunchError):
        c.pump()
    with pytest.raises(KernelLaunchError):
        c.finish()
    assert blocks == {k: ks.frontier.blocks_done for k, ks in c._keys.items()}
    assert c.status()["epoch-restarts"] == 0


def _serial_builder(pm, n_pairs):
    """n_pairs sequential writes: row i has inv 2i, ret 2i+1."""
    b = PackedBuilder(pm.encode)
    for i in range(n_pairs):
        b.append(Op(type="invoke", f="write", value=i % 5, process=0,
                    index=2 * i + 1))
        b.append(Op(type="ok", f="write", value=i % 5, process=0,
                    index=2 * i + 2))
    return b


def test_rebase_dies_on_misalignment():
    pm, _ = _pms()
    f = FrontierCarry(pm, beam=4, bars_per_block=4, blocks_per_call=2,
                      device="cpu")
    f.advance(*_serial_builder(pm, 64).snapshot())
    assert not f.dead and f.blocks_done >= 2
    f.rebase(3, 3)  # 3 bars is not a whole block of 4
    assert f.dead


def test_rebase_shifts_the_carry():
    pm, _ = _pms()
    f = FrontierCarry(pm, beam=4, bars_per_block=4, blocks_per_call=2,
                      device="cpu")
    b = _serial_builder(pm, 64)
    f.advance(*b.snapshot())
    done, prev = f.blocks_done, f._prev_active.copy()
    rows, bars, _ = b.discard_stable_prefix(bars_per_block=4,
                                            blocks_done=done)
    assert rows == bars == (done - 1) * 4
    f.rebase(rows, bars)
    assert not f.dead and f.blocks_done == 1
    assert (f._prev_active == prev - rows).all()
    # Dropping every processed block is refused.
    f.rebase(8, 8)
    assert f.dead
