"""Port parity for the incremental packer (history/packed.py
`PackedBuilder`): `finish()` gives pack_history's bytes under any
chunking, `snapshot()` gives the JAX PackedBuilder's stable prefixes and
bounds, `discard_stable_prefix` its tuples; the register model's
batched encoder gives encode()'s codes; `random_register_packed` the
JAX generator's columns for one seed."""

import numpy as np
import pytest

import jepsen_tpu.history.packed as ref_packed
import jepsen_tpu.models as ref_models
from jepsen_tpu.utils.histgen import random_register_history as ref_gen
from jepsen_tpu.utils.histgen import random_register_packed as ref_gen_packed
from jepsen_tpu_torch.history.core import History, Op, history
from jepsen_tpu_torch.history.packed import (NO_RET, PACKED_COLUMNS,
                                             PackedBuilder, pack_history)
from jepsen_tpu_torch.models import cas_register, register
from jepsen_tpu_torch.utils.histgen import (random_register_history,
                                            random_register_packed)


def packed_bytes(p) -> bytes:
    """The pack's columns in the reference's serialization order."""
    out = [np.int64(p.n).tobytes()]
    for name, dtype in PACKED_COLUMNS:
        col = np.ascontiguousarray(getattr(p, name), dtype=dtype)
        assert col.shape == (p.n,), name
        out.append(col.tobytes())
    return b"".join(out)


def _chunked(h, pm, sizes, snapshots=False):
    b = PackedBuilder(pm.encode)
    ops = list(h)
    i = si = 0
    while i < len(ops):
        size = sizes[si % len(sizes)]
        si += 1
        b.append_many(ops[i:i + size])  # size 0: an empty chunk
        i += size
        if snapshots:
            b.snapshot()  # snapshots must not change finish()
    return b.finish()


@pytest.mark.parametrize("sizes", [[1], [7, 0, 3], [100], [1, 50, 0, 2]])
def test_chunked_finish_equals_pack_history(sizes):
    pm = cas_register().packed()
    h = random_register_history(600, procs=8, info_rate=0.1, seed=23)
    want = packed_bytes(pack_history(h, pm.encode))
    assert packed_bytes(_chunked(h, pm, sizes)) == want


def test_snapshots_do_not_change_finish():
    pm = cas_register().packed()
    h = random_register_history(600, procs=8, info_rate=0.1, seed=29)
    want = packed_bytes(pack_history(h, pm.encode))
    assert packed_bytes(_chunked(h, pm, [37], snapshots=True)) == want


def test_scalar_and_chunked_fuzz():
    """append() per op and append_many over random chunks, including
    chunks under the numpy path's threshold and chunks that split
    invoke/completion pairs."""
    pm = cas_register().packed()
    rng = np.random.default_rng(29)
    for trial in range(12):
        h = random_register_history(
            int(rng.integers(1, 300)), procs=int(rng.integers(1, 7)),
            info_rate=float(rng.uniform(0, 0.3)),
            seed=int(rng.integers(0, 1 << 30)))
        ops = list(h)
        want = packed_bytes(pack_history(h, pm.encode))
        scalar = PackedBuilder(pm.encode)
        for o in ops:
            scalar.append(o)
        assert packed_bytes(scalar.finish()) == want, trial
        chunked = PackedBuilder(pm.encode)
        i = 0
        while i < len(ops):
            c = int(rng.integers(1, 80))
            chunked.append_many(ops[i:i + c])
            i += c
        assert packed_bytes(chunked.finish()) == want, trial


def test_edge_pairings():
    """Double invokes, a completion with no invocation, a failure,
    nemesis ops and an unfinished invoke, also straddling a chunk
    boundary on the numpy path."""
    pm = cas_register().packed()
    ops = [
        Op(type="invoke", f="write", value=1, process=0),
        Op(type="invoke", f="write", value=9, process="nemesis"),
        Op(type="invoke", f="write", value=2, process=0),
        Op(type="ok", f="write", value=2, process=0),
        Op(type="ok", f="write", value=3, process=1),
        Op(type="invoke", f="write", value=4, process=1),
        Op(type="fail", f="write", value=4, process=1),
        Op(type="invoke", f="read", value=None, process=2),
    ]
    h = history(ops)
    want = packed_bytes(pack_history(h, pm.encode))
    b = PackedBuilder(pm.encode)
    b.append_many(list(h))
    assert packed_bytes(b.finish()) == want
    pad = [Op(type="invoke", f="noise", value=None, process="nemesis")
           ] * PackedBuilder._MANY_MIN
    b2 = PackedBuilder(pm.encode)
    b2.append_many(list(h)[:2] + pad)
    b2.append_many(pad + list(h)[2:])
    assert packed_bytes(b2.finish()) == want


def test_empty_builder_and_finish_twice():
    pm = cas_register().packed()
    b = PackedBuilder(pm.encode)
    b.append_many([])
    assert packed_bytes(b.finish()) == packed_bytes(
        pack_history(History([]), pm.encode))
    with pytest.raises(RuntimeError):
        b.finish()
    with pytest.raises(RuntimeError):
        b.append(Op(type="invoke", f="read", process=0))


def test_int32_guard_on_the_numpy_path():
    def encode(inv, comp):
        return (1, 2 ** 31, 0)

    b = PackedBuilder(encode)
    ops = []
    for p in range(PackedBuilder._MANY_MIN):
        ops += [Op(type="invoke", f="write", value=1, process=p),
                Op(type="ok", f="write", value=1, process=p)]
    b.append_many(ops)
    with pytest.raises(OverflowError):
        b.finish()


@pytest.mark.parametrize("seed", [3, 31, 47])
def test_snapshots_and_finish_equal_the_jax_builder(seed):
    """The same ops through both packages' PackedBuilders, in the same random
    append_many chunks: every snapshot's columns and stable bound, and
    the finished pack, are the JAX PackedBuilder's."""
    ref_pm = ref_models.cas_register().packed()
    pm = cas_register().packed()
    ops = list(random_register_history(900, procs=6, info_rate=0.1,
                                       seed=seed))
    ref_ops = list(ref_gen(900, procs=6, info_rate=0.1, seed=seed))
    ref_b = ref_packed.PackedBuilder(ref_pm.encode)
    b = PackedBuilder(pm.encode)
    rng = np.random.default_rng(seed)
    i = 0
    while i < len(ops):
        c = int(rng.integers(1, 120))
        ref_b.append_many(ref_ops[i:i + c])
        b.append_many(ops[i:i + c])
        i += c
        want, ref_s = ref_b.snapshot()
        got, s = b.snapshot()
        assert s == ref_s
        assert packed_bytes(got) == packed_bytes(want)
        assert b.n_rows == ref_b.n_rows and b.in_flight == ref_b.in_flight
    assert packed_bytes(b.finish()) == packed_bytes(ref_b.finish())


@pytest.mark.parametrize("case", [
    lambda: test_chunked_finish_equals_pack_history([7, 0, 3]),
    lambda: test_chunked_finish_equals_pack_history([1, 50, 0, 2]),
    test_snapshots_do_not_change_finish,
    test_scalar_and_chunked_fuzz,
    test_edge_pairings,
    test_empty_builder_and_finish_twice,
    lambda: test_snapshots_and_finish_equal_the_jax_builder(31),
    lambda: test_discards_equal_the_jax_builder(0.05),
], ids=["chunked", "chunked-small", "snapshots", "fuzz", "edges", "empty",
        "jax-snapshots", "jax-discards"])
def test_numpy_pairing_on_every_chunk(case, monkeypatch):
    """The chunk tests above, with append_many's numpy pairing taking
    every chunk, down to one op and the empty chunk (the builders fall
    back to append() below `_MANY_MIN` client ops; the JAX builder's
    threshold moves with the port's, as the two must pick the same
    pairing to intern values in the same order)."""
    monkeypatch.setattr(PackedBuilder, "_MANY_MIN", 0)
    monkeypatch.setattr(ref_packed.PackedBuilder, "_MANY_MIN", 0)
    case()


def _serial(n_pairs, pm):
    """n_pairs sequential writes: row i has inv 2i, ret 2i+1."""
    b = PackedBuilder(pm.encode)
    for i in range(n_pairs):
        b.append(Op(type="invoke", f="write", value=i % 5, process=0,
                    index=2 * i + 1))
        b.append(Op(type="ok", f="write", value=i % 5, process=0,
                    index=2 * i + 2))
    return b


def test_discard_prefix_renumbers_events():
    pm = cas_register().packed()
    b = _serial(200, pm)
    b.snapshot()
    # The cap is (blocks_done - 1) * K = 36, a multiple of 4.
    assert b.discard_stable_prefix(bars_per_block=4, blocks_done=10) == (
        36, 36, 72)
    assert b.n_rows == 164
    assert b._stable[0][:2] == (0, 1)  # old row 36 (inv 72, ret 73)
    packed, _ = b.snapshot()
    assert packed.n == 164


def test_discard_prefix_bails_safely():
    pm = cas_register().packed()
    b = _serial(50, pm)
    b.snapshot()
    # blocks_done = 1: the newest processed block stays resident.
    assert b.discard_stable_prefix(bars_per_block=4,
                                   blocks_done=1) == (0, 0, 0)
    # An invocation pending at the very front pins everything.
    b2 = PackedBuilder(pm.encode)
    b2.append(Op(type="invoke", f="write", value=9, process=7, index=1))
    for i in range(50):
        b2.append(Op(type="invoke", f="write", value=i % 5, process=0,
                     index=2 * i + 2))
        b2.append(Op(type="ok", f="write", value=i % 5, process=0,
                     index=2 * i + 3))
    b2.snapshot()
    assert b2.discard_stable_prefix(bars_per_block=4,
                                    blocks_done=10) == (0, 0, 0)
    assert NO_RET in {r[1] for r in b2._rows} or b2._pending


@pytest.mark.parametrize("info_rate", [0.0, 0.05])
def test_discards_equal_the_jax_builder(info_rate):
    """A stream fed in chunks, snapshotted and discarded after each:
    every (rows, bars, shift) tuple, stable bound and snapshot equal
    the JAX PackedBuilder's."""
    ref_pm = ref_models.cas_register().packed()
    pm = cas_register().packed()
    ops = list(random_register_history(3000, procs=4, info_rate=info_rate,
                                       cas=False, seed=5))
    ref_ops = list(ref_gen(3000, procs=4, info_rate=info_rate, cas=False,
                           seed=5))
    ref_b = ref_packed.PackedBuilder(ref_pm.encode)
    b = PackedBuilder(pm.encode)
    dropped = 0
    for i in range(0, len(ops), 250):
        ref_b.append_many(ref_ops[i:i + 250])
        b.append_many(ops[i:i + 250])
        want, ref_s = ref_b.snapshot()
        got, s = b.snapshot()
        assert s == ref_s and packed_bytes(got) == packed_bytes(want)
        blocks = got.n_ok // 16
        t = b.discard_stable_prefix(bars_per_block=16, blocks_done=blocks)
        assert t == ref_b.discard_stable_prefix(bars_per_block=16,
                                                blocks_done=blocks)
        dropped += t[0]
    if info_rate == 0.0:
        assert dropped > 0
    assert packed_bytes(b.finish()) == packed_bytes(ref_b.finish())


@pytest.mark.parametrize("make", [cas_register, register])
def test_encode_many_equals_encode(make):
    """The batched encoder: the same drops and codes as encode(), in
    the same interning order (a fresh model each side)."""
    h = random_register_history(400, procs=5, info_rate=0.2, seed=11,
                                cas=make is cas_register)
    ops = list(h)
    pairs = [(ops[i], ops[i + 1] if i + 1 < len(ops) else None)
             for i in range(0, len(ops), 1) if ops[i].type == "invoke"]
    pairs += [(Op(type="invoke", f="write", value=[1, 2], process=0),
               None)]
    one, many = make().packed(), make().packed()
    want = [one.encode(i, c) for i, c in pairs]
    assert many.encode.many(pairs) == want
    assert one.interner.values == many.interner.values


@pytest.mark.parametrize("n,procs,info,seed", [
    (5_000, 16, 0.05, 45100), (777, 3, 0.3, 7), (10, 32, 0.0, 1)])
def test_random_register_packed_equals_the_jax_generator(n, procs, info,
                                                         seed):
    got = random_register_packed(n, procs=procs, info_rate=info, seed=seed)
    want = ref_gen_packed(n, procs=procs, info_rate=info, seed=seed)
    assert packed_bytes(got) == packed_bytes(want)


def test_random_register_packed_is_valid_and_packs_like_pack_history():
    """Its reads and writes pack as pack_history would (the codes are
    learned from sample encodings) and the exact engine finds it
    linearizable."""
    from jepsen_tpu_torch.checker.wgl_event import check_wgl_event

    pm = cas_register().packed()
    p = random_register_packed(400, procs=4, info_rate=0.1, seed=2,
                               model=pm)
    assert p.n > 300 and (np.diff(p.inv) > 0).all()
    assert check_wgl_event(p, pm).valid is True
