"""The witness sweep kernel (csrc/witness_sweep.cu) against its plain
PyTorch version on the card, and the CPU-side contract of its wrapper.

This file imports only the port (no jax), so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py

The `cuda`-marked tests skip without a card: a CUDA kernel has no CPU
mode.  `sweep_tables` and `model_tables` are shared with
tests/test_torch_witness_sweep.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.models import (cas_register, fifo_queue, multi_register,
                                     mutex, unordered_queue)
from jepsen_tpu_torch.ops import kernels
from jepsen_tpu_torch.ops.wgl_stream import F_RESET, stream_model
from jepsen_tpu_torch.ops.wgl_witness import sweep, sweep_plain

K, W, SW = 64, 16, 1


def sweep_tables(B, kind, seed, start_k=0):
    """Random sweep inputs (bars (6, K), member (W, B), states (B, SW),
    alive (B,), as numpy).  kind: "death" plants a barrier no lane
    survives at K/2; "padding" leaves no real barrier after K/4 and
    plants the death in the padding, where it must not count; "clean"
    lets lane 0 pass every barrier; "dead+N" plants the death at
    start_k + N, an offset of N within the kernel's 32-barrier batches
    (N = 32 is offset 0 of the second batch); "no-alive" is "padding"
    with no lane alive at the start.  Lane 0 passes every real barrier
    but the planted one in all kinds but "death"."""
    rng = np.random.default_rng(seed)
    member = rng.random((W, B)) < 0.3
    states = rng.integers(0, 4, size=(B, SW)).astype(np.int32)
    alive = rng.random(B) < 0.7
    alive[0] = True
    bars = np.zeros((6, K), dtype=np.int32)
    bars[0] = rng.integers(0, W - 1, size=K)
    bars[1] = np.arange(K)
    bars[2] = 1
    bars[3] = rng.integers(0, 3, size=K)
    bars[4] = rng.integers(0, 4, size=K)
    bars[5] = rng.integers(0, 4, size=K)
    member[W - 1] = False
    if B == 32:
        member[: W - 1, 31] = rng.random(W - 1) < 0.8  # bit 31 in use
    if kind != "death":
        member[: W - 1, 0] = True  # lane 0 passes every real barrier
    if kind == "clean":
        member[W - 1, 0] = True
    if kind.startswith("dead+"):
        planted = start_k + int(kind[len("dead+"):])
    else:
        planted = K // 2 if kind == "death" else 3 * K // 4
    bars[0, planted] = W - 1  # no lane has this member bit
    bars[3, planted] = 0      # a read ...
    bars[4, planted] = 77     # ... of a value no lane holds
    if kind in ("padding", "no-alive"):
        bars[2, K // 4:] = 0
    if kind == "no-alive":
        alive[:] = False
    return bars, member, states, alive


def expected_death(kind, start_k, death):
    """Whether `death` is what the case was built to give: the planted
    barrier for "dead+N", at most the planted K/2 for "death" started
    before it, the first real barrier for "no-alive", and K (the block
    completes) for "clean" and "padding"."""
    if kind.startswith("dead+"):
        return death == start_k + int(kind[len("dead+"):])
    if kind == "death":
        return start_k > K // 2 or death <= K // 2
    if kind == "no-alive":  # the first real barrier, if any
        return death == (start_k if start_k < K // 4 else K)
    return death == K


KINDS = ("death", "padding", "clean")
#: The kernel sweeps 32-barrier batches from start_k: starts 31 and 33
#: straddle a batch edge, "dead+0/31/32" put the death at batch offsets
#: 0 and 31 and at the start of the second batch, and B = 1 leaves 31
#: lanes outside the beam.  "padding" at start 0 begins inside a batch;
#: "no-alive" has every lane dead before a padding stretch.
CASES = ([(B, start, kind)
          for B in (8, 32) for start in (0, K // 2 - 5) for kind in KINDS]
         + [(1, start, kind) for start in (0, K // 2 - 5) for kind in KINDS]
         + [(B, start, kind)
            for B in (1, 8, 32) for start in (31, 33) for kind in KINDS]
         + [(B, start, f"dead+{off}")
            for B in (1, 8, 32) for start in (0, 31) for off in (0, 31, 32)]
         + [(B, start, "no-alive") for B in (1, 8, 32) for start in (0, 31)])


def case_tables(B, start_k, kind):
    """`sweep_tables` for one entry of CASES, with its seed."""
    return sweep_tables(B, kind, seed=B * 100 + start_k, start_k=start_k)


# ---------------------------------------------------------------------------
# Every model's instantiation, plain and stream.

#: The sweep kernel's models as the tests name them; "+stream" selects
#: the stream model (ops/wgl_stream.py), which knows RESET.
MODEL_FACTORIES = {
    "register": lambda: cas_register(),
    "mutex": lambda: mutex(),
    "multi3": lambda: multi_register({f"r{i}": 0 for i in range(3)}),
    "multi5": lambda: multi_register({f"r{i}": 0 for i in range(5)}),
    "fifo": lambda: fifo_queue(),
    "unordered": lambda: unordered_queue(),
}

MODEL_NAMES = [m + s for m in MODEL_FACTORIES for s in ("", "+stream")]

_pms = {}


def model_pm(name):
    """The packed model for a MODEL_NAMES entry (one per name)."""
    pm = _pms.get(name)
    if pm is None:
        base, _, stream = name.partition("+")
        pm = MODEL_FACTORIES[base]().packed()
        if stream:
            pm = stream_model(pm)
        _pms[name] = pm
    return pm


def _random_ops(base, rng, n, sw):
    """(f, a0, a1) rows of `n` random ops for the model: mostly legal
    shapes, with codes a model never packs (f = 2 for the mutex, a0
    outside the registers, a0 = 0 for the queues) mixed in."""
    if base == "register":
        return (rng.integers(0, 3, n), rng.integers(0, 4, n),
                rng.integers(0, 4, n))
    if base == "mutex":
        return rng.choice([0, 1, 1, 0, 2], n), np.zeros(n), np.zeros(n)
    if base.startswith("multi"):
        return (rng.integers(0, 2, n), rng.choice(
            list(range(sw)) * 3 + [-1, sw, 7], n), rng.integers(0, 4, n))
    return (rng.choice([0, 0, 1], n), rng.integers(0, 7, n), np.zeros(n))


def _random_states(base, rng, B, sw):
    if base in ("register", "mutex"):
        return rng.integers(0, 2 if base == "mutex" else 4, (B, sw))
    if base.startswith("multi"):
        return rng.integers(0, 4, (B, sw))
    states = np.zeros((B, sw), dtype=np.int64)
    for b in range(B):
        # Lanes 0 and 1: an empty and a full queue; others in between.
        n = (0, sw)[b] if b < 2 else int(rng.integers(0, sw + 1))
        vals = rng.integers(1, 7, n)
        if base == "fifo":
            states[b, :n] = vals
        else:
            states[b, rng.permutation(sw)[:n]] = vals
    return states


#: An op no lane survives, for a planted death: a read of a value no
#: lane holds; a dequeue of one; for the mutex an acquire of a held
#: lock (planted twice in a row: the first leaves every survivor
#: holding it).
_KILLERS = {"register": (0, 77, 0), "mutex": (0, 0, 0),
            "multi": (0, 0, 77), "fifo": (1, 99, 0),
            "unordered": (1, 99, 0)}


def model_tables(name, B, kind, seed, start_k=0):
    """Random sweep inputs for one model (bars (6, K), member (W, B),
    states (B, SW), alive (B,), as numpy): the kinds of `sweep_tables`,
    with the model's ops and states, and for a "+stream" model a RESET
    barrier every 7th."""
    base = name.partition("+")[0]
    pm = model_pm(name)
    sw = pm.state_width
    rng = np.random.default_rng(seed)
    member = rng.random((W, B)) < 0.3
    states = _random_states(base, rng, B, sw).astype(np.int32)
    alive = rng.random(B) < 0.7
    alive[0] = True
    bars = np.zeros((6, K), dtype=np.int32)
    bars[0] = rng.integers(0, W - 1, size=K)
    bars[1] = np.arange(K)
    bars[2] = 1
    bars[3], bars[4], bars[5] = _random_ops(base, rng, K, sw)
    if pm.stream:
        bars[3, 3::7] = F_RESET
    member[W - 1] = False
    if B == 32:
        member[: W - 1, 31] = rng.random(W - 1) < 0.8  # bit 31 in use
    if kind != "death":
        member[: W - 1, 0] = True  # lane 0 passes every real barrier
    if kind == "clean":
        member[W - 1, 0] = True
    if kind.startswith("dead+"):
        planted = start_k + int(kind[len("dead+"):])
    else:
        planted = K // 2 if kind == "death" else 3 * K // 4
    killer = _KILLERS["multi" if base.startswith("multi") else base]
    for k in ((planted - 1, planted) if base == "mutex" else (planted,)):
        if k >= 0:
            bars[0, k] = W - 1  # no lane has this member bit
            bars[3:, k] = killer
    if kind in ("padding", "no-alive"):
        bars[2, K // 4:] = 0
    if kind == "no-alive":
        alive[:] = False
    return bars, member, states, alive


#: (model, B, start, kind) cases of every model at B = 1, 8 and 32,
#: with the kernel's batch edges: starts 1, 31 and 33, deaths at batch
#: offsets 0 and 31 and at the start of the second batch.
MODEL_CASES = [(m, B, start, kind) for m in MODEL_NAMES for B in (1, 8, 32)
               for start, kind in ((0, "death"), (0, "clean"),
                                   (33, "padding"), (31, "dead+0"),
                                   (1, "dead+31"), (0, "dead+32"))]


def model_case_tables(name, B, start_k, kind):
    """`model_tables` for one entry of MODEL_CASES, with its seed."""
    return model_tables(name, B, kind, seed=B * 100 + start_k + len(name),
                        start_k=start_k)


def model_init(name, dev):
    """The init tensor a stream model's sweep takes, or None."""
    pm = model_pm(name)
    if not pm.stream:
        return None
    return torch.tensor(pm.init_state, dtype=torch.int32, device=dev)


def test_sweep_routes_cpu_tensors_to_plain():
    pm = cas_register().packed()
    args = tuple(torch.from_numpy(a) for a in sweep_tables(8, "death", 1))
    before = kernels.launches["witness_sweep"]
    got = sweep(pm, 0, *args)
    want = sweep_plain(0, *args, pm.torch_step_rows)
    assert got[2] == want[2] <= K // 2
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernels.launches["witness_sweep"] == before


def test_kernel_wrapper_refuses_cpu_tensors():
    before = kernels.launches["witness_sweep"]
    with pytest.raises(ValueError, match="CUDA"):
        kernels.witness_sweep(1, 0, *_good_args())
    assert kernels.launches["witness_sweep"] == before


def test_sweep_off_the_cpu_never_takes_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel or raises: a
    model with no device step, and a beam the kernel takes (any width:
    33, 65, 200 lanes) but on tensors it cannot launch on, are errors
    there, not a route to the plain sweep.  ("meta" tensors stand in
    for the card: they reach the same checks.)"""
    pm = cas_register().packed()
    no_step = dataclasses.replace(pm, kernel_model=None)
    before = kernels.launches["witness_sweep"]
    for B, model, match in ((8, no_step, "no device step"),
                            (65, pm, "CUDA tensors"),
                            (200, pm, "CUDA tensors"),
                            (33, pm, "CUDA tensors")):
        bars, member, states, alive = (
            torch.from_numpy(a).to("meta")
            for a in sweep_tables(min(B, 32), "clean", 2))
        member = torch.zeros((W, B), dtype=torch.bool, device="meta")
        states = torch.zeros((B, SW), dtype=torch.int32, device="meta")
        alive = torch.zeros(B, dtype=torch.bool, device="meta")
        with pytest.raises(ValueError, match=match):
            sweep(model, 0, bars, member, states, alive)
    assert kernels.launches["witness_sweep"] == before


@pytest.mark.parametrize("B", [33, 64])
def test_sweep_refuses_a_beam_wider_than_one_member_word(B):
    """A beam of B > 32 lanes spans more than one member word: the
    kernel sweeps it as ceil(B / 32) 32-lane blocks joined by a second
    kernel, so the sweep passes it on to the kernel's wrapper (which
    refuses these "meta" tensors only for not being on a card), and so
    a beam of B + 32 and of 4 B lanes too: no beam width is refused
    before the kernel is reached."""
    pm = cas_register().packed()

    def tables(b):
        return (torch.zeros((6, K), dtype=torch.int32, device="meta"),
                torch.zeros((W, b), dtype=torch.bool, device="meta"),
                torch.zeros((b, SW), dtype=torch.int32, device="meta"),
                torch.zeros(b, dtype=torch.bool, device="meta"))

    before = kernels.launches["witness_sweep"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        sweep(pm, 0, *tables(B))
    for wider in (B + 32, 4 * B):
        with pytest.raises(ValueError, match="CUDA tensors"):
            sweep(pm, 0, *tables(wider))
    assert kernels.launches["witness_sweep"] == before


def _good_args():
    bars, member, states, alive = sweep_tables(8, "clean", 3)
    return [torch.from_numpy(a) for a in (bars, member, states, alive)]


@pytest.mark.parametrize("bad,match", [
    (lambda a: a.__setitem__(1, a[1].to(torch.int32)), "member must be"),
    (lambda a: a.__setitem__(3, a[3].to(torch.int32)), "alive must be"),
    (lambda a: a.__setitem__(2, a[2].to(torch.int64)), "states must be"),
    (lambda a: a.__setitem__(0, a[0].T.contiguous().T), "bars must be"),
    (lambda a: a.__setitem__(1, a[1].T.contiguous().T), "member must be"),
    (lambda a: a.__setitem__(0, a[0][:5]), "bad shapes"),
    (lambda a: a.__setitem__(3, a[3][:4]), "bad shapes"),
    (lambda a: a.__setitem__(1, torch.zeros((W, 0), dtype=torch.bool)),
     "bad shapes"),
    (lambda a: None, "CUDA"),
])
def test_kernel_wrapper_checks_its_arguments(bad, match):
    """kernels.witness_sweep takes the port's own layout — (6, K) int32
    bars, (W, B) bool member, (B, SW) int32 states, (B,) bool alive,
    contiguous, B >= 1, on the card — and raises on anything else
    without launching."""
    args = _good_args()
    bad(args)
    before = kernels.launches["witness_sweep"]
    with pytest.raises(ValueError, match=match):
        kernels.witness_sweep(1, 0, *args)
    assert kernels.launches["witness_sweep"] == before


def test_kernel_wrapper_checks_start_k():
    before = kernels.launches["witness_sweep"]
    with pytest.raises(ValueError, match="start_k"):
        kernels.witness_sweep(1, K + 1, *_good_args())
    assert kernels.launches["witness_sweep"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,start_k,kind", CASES)
def test_cuda_kernel_matches_plain(B, start_k, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernel has no CPU mode")
    dev = torch.device("cuda")
    pm = cas_register().packed()
    bars, member, states, alive = (
        torch.from_numpy(a).to(dev) for a in case_tables(B, start_k, kind))
    before = kernels.launches["witness_sweep"]
    got = sweep(pm, start_k, bars, member, states, alive)
    want = sweep_plain(start_k, bars, member, states, alive,
                       pm.torch_step_rows)
    torch.cuda.synchronize()
    assert kernels.launches["witness_sweep"] == before + 1
    assert got[2] == want[2]
    assert expected_death(kind, start_k, got[2])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_kernel_rejects_a_misaligned_member_window():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernel has no CPU mode")
    dev = torch.device("cuda")
    bars, member, states, alive = (
        torch.from_numpy(a).to(dev) for a in sweep_tables(8, "clean", 4))
    shifted = torch.zeros(member.numel() + 1, dtype=torch.bool,
                          device=dev)[1:].view(member.shape)
    with pytest.raises(ValueError, match="aligned"):
        kernels.witness_sweep(1, 0, bars, shifted, states, alive)


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,start_k,kind", MODEL_CASES)
def test_cuda_kernel_matches_plain_every_model(name, B, start_k, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernel has no CPU mode")
    dev = torch.device("cuda")
    pm = model_pm(name)
    bars, member, states, alive = (
        torch.from_numpy(a).to(dev)
        for a in model_case_tables(name, B, start_k, kind))
    key = f"witness_sweep[{pm.name}]".replace("cas-register", "register")
    before = kernels.launches[key]
    got = sweep(pm, start_k, bars, member, states, alive,
                model_init(name, dev))
    want = sweep_plain(start_k, bars, member, states, alive,
                       pm.torch_step_rows)
    torch.cuda.synchronize()
    assert kernels.launches[key] == before + 1
    assert got[2] == want[2]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if kind.startswith("dead+") and not name.startswith("mutex"):
        assert got[2] == start_k + int(kind[len("dead+"):])


#: Every model at beams of G = ceil(B / 32) blocks: the death in the
#: first group, at batch edges, from a start past 0.
G_CASES = [(m, B, start, kind) for m in MODEL_NAMES for B in (96, 128, 200)
           for start, kind in ((0, "death"), (0, "clean"), (33, "padding"),
                               (31, "dead+0"), (1, "dead+31"))]


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,start_k,kind", G_CASES)
def test_cuda_kernel_matches_plain_in_g_lane_groups(name, B, start_k, kind):
    """Every model's instantiation over a beam of 3, 4 and 7 blocks
    equals the plain sweep of the whole beam, and the launch took the
    join."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernel has no CPU mode")
    dev = torch.device("cuda")
    pm = model_pm(name)
    host = tuple(torch.from_numpy(a)
                 for a in model_case_tables(name, B, start_k, kind))
    before = kernels.launches["witness_sweep[join]"]
    got = sweep(pm, start_k, *(t.to(dev) for t in host),
                model_init(name, dev))
    torch.cuda.synchronize()
    want = sweep_plain(start_k, *host, pm.torch_step_rows)
    assert kernels.launches["witness_sweep[join]"] == before + 1
    assert got[2] == want[2]
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_kernel_wrapper_checks_model_and_width():
    """An unknown model id, a width the model is not compiled for, and
    an init of the wrong shape are refused before any launch."""
    bars, member, states, alive = (torch.from_numpy(a)
                                   for a in sweep_tables(8, "clean", 5))
    before = kernels.launches["witness_sweep"]
    with pytest.raises(ValueError, match="no device step"):
        kernels.witness_sweep(9, 0, bars, member, states, alive)
    with pytest.raises(ValueError, match="state widths"):
        kernels.witness_sweep(4, 0, bars, member, states, alive)
    # Past 32 words the multi-register takes the wide instantiation at
    # any width (fewer lanes a block, or its rows in global memory): a
    # width past what 8 lanes' rows in shared memory hold is refused
    # only for these tensors not being on a card.
    for n in (6_891, 55_133):
        wide = torch.zeros((8, n), dtype=torch.int32)
        with pytest.raises(ValueError, match="CUDA"):
            kernels.witness_sweep(3, 0, bars, member, wide, alive)
    with pytest.raises(ValueError, match="init"):
        kernels.witness_sweep(1, 0, bars, member, states, alive,
                              torch.zeros(2, dtype=torch.int32))
    assert kernels.launches["witness_sweep"] == before


def test_sweep_refuses_a_stream_model_without_its_initial_state():
    pm = model_pm("mutex+stream")
    bars, member, states, alive = (
        torch.from_numpy(a).to("meta")
        for a in model_tables("mutex+stream", 8, "clean", 6))
    with pytest.raises(ValueError, match="initial state"):
        sweep(pm, 0, bars, member, states, alive)


#: The models of the recorded cases: chip_smoke.py's seeded histories,
#: at a test's size.
RECORDED_MODELS = ["register", "mutex", "multi5", "fifo", "unordered"]


def _recorded_history(name, n_keys, n_ops, bad):
    """A keyed history of `name` (keys `bad` bad) and its model."""
    from chip_smoke import (keyed_history, multi_register_ops, mutex_ops,
                            queue_ops)
    from jepsen_tpu_torch.history.core import Op, history
    from jepsen_tpu_torch.parallel import kv
    from jepsen_tpu_torch.utils.histgen import random_register_history

    def register_ops(n, seed, bad, info=0.05):
        return [dict(type=o.type, f=o.f, value=o.value, process=o.process)
                for o in random_register_history(n, procs=4, info_rate=info,
                                                 seed=seed, bad=bad)]

    gen, kw = {"register": (register_ops, {}), "mutex": (mutex_ops, {}),
               "multi5": (multi_register_ops, {}),
               "fifo": (queue_ops, {"procs": 3, "info": 0.0}),
               "unordered": (queue_ops, {})}[name]
    h = keyed_history(gen, n_keys, n_ops, bad, Op=Op, kv=kv,
                      history=history, **kw)
    return MODEL_FACTORIES[name](), h


@pytest.mark.cuda
@pytest.mark.parametrize("name", RECORDED_MODELS)
def test_cuda_recorded_sweeps_match_plain(name, monkeypatch):
    """Every sweep a many-key check (stream instantiation) and a single
    long history (plain instantiation) make on the card equals the plain
    version on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernel has no CPU mode")
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.ops import wgl_witness
    from jepsen_tpu_torch.parallel import IndependentChecker, subhistories

    real = wgl_witness.sweep
    calls = []

    def recording(pm, start_k, bars, member, states, alive, init=None):
        args = tuple(t.clone() for t in (bars, member, states, alive))
        out = real(pm, start_k, bars, member, states, alive, init)
        calls.append((pm, start_k, args, out))
        return out

    monkeypatch.setattr(wgl_witness, "sweep", recording)
    model, h = _recorded_history(name, 12, 40, {0, 4, 8})
    res = IndependentChecker(Linearizable(model, time_limit_s=60)).check(
        {}, h, {})
    assert res["failure-count"] == 3
    streamed = len(calls)
    _, long_h = _recorded_history(name, 1, 400, set())
    (single,) = subhistories(long_h).values()
    Linearizable(MODEL_FACTORIES[name](), "wgl-tpu",
                 time_limit_s=60).check({}, single, {})
    assert 0 < streamed < len(calls)
    assert any(pm.stream for pm, *_ in calls)
    assert any(not pm.stream for pm, *_ in calls)
    for pm, start_k, args, (s2, al2, d) in calls:
        want = sweep_plain(start_k, *(t.cpu() for t in args),
                           pm.torch_step_rows)
        assert d == want[2]
        assert torch.equal(s2.cpu(), want[0])
        assert torch.equal(al2.cpu(), want[1])


@pytest.mark.cuda
def test_cuda_frontier_carry_equals_the_cpu_carry():
    """A 20k-op stream advanced in the same slices by a frontier on the
    card (the sweep kernel) and one on the CPU (the plain sweep): the
    carries are equal after every advance, and both prove the stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernel has no CPU mode")
    from jepsen_tpu_torch.history.packed import PackedBuilder
    from jepsen_tpu_torch.streaming import FrontierCarry
    from jepsen_tpu_torch.utils.histgen import random_register_history

    pm = cas_register().packed()
    h = random_register_history(20_000, procs=16, info_rate=0.05, seed=77)
    b = PackedBuilder(pm.encode)
    on_card = FrontierCarry(pm, bars_per_block=256, device="cuda")
    on_cpu = FrontierCarry(pm, bars_per_block=256, device="cpu")
    before = kernels.launches["witness_sweep"]

    def same():
        assert (on_card.blocks_done, on_card.chunks, on_card.dead) == (
            on_cpu.blocks_done, on_cpu.chunks, on_cpu.dead)
        assert on_card._W == on_cpu._W
        for a, c in ((on_card._member, on_cpu._member),
                     (on_card._states, on_cpu._states),
                     (on_card._alive, on_cpu._alive)):
            assert torch.equal(a.cpu(), c)
        assert np.array_equal(on_card._prev_active, on_cpu._prev_active)

    for i, op in enumerate(h):
        b.append(op)
        if i % 2500 == 2499:
            packed, s = b.snapshot()
            on_card.advance(packed, s)
            on_cpu.advance(packed, s)
            if on_cpu.blocks_done:
                same()
    final = b.finish()
    assert on_card.finalize(final) is True
    assert on_cpu.finalize(final) is True
    same()
    assert kernels.launches["witness_sweep"] > before


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_scc_screen_and_extraction_equal_the_cpu(seed):
    """The Elle closure screen and the witness-cycle extraction on the
    card (bfloat16 products) equal the CPU's (float32) on the same
    batches: flags, and found, u, v, parent and scc_size element for
    element; and the layered records of a 1,000-vertex ring."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chip_smoke import random_dep_graphs
    from jepsen_tpu_torch.checker.elle.graph import DepGraph
    from jepsen_tpu_torch.ops import scc

    graphs = random_dep_graphs(96, seed, DepGraph)
    assert np.array_equal(scc.screen_cycles(graphs, device="cuda"),
                          scc.screen_cycles(graphs, device="cpu"))
    layers = [x for g in graphs[:8] for x in scc.layer_entries(g)]
    a_all, a_req, _ = scc.pack_required([x[0] for x in layers],
                                        [x[1] for x in layers])
    cpu = scc.extract_batch(torch.from_numpy(a_all),
                            torch.from_numpy(a_req), torch.float32)
    card = scc.extract_batch(torch.from_numpy(a_all).cuda(),
                             torch.from_numpy(a_req).cuda(), torch.bfloat16)
    for name, c, g in zip(("found", "u", "v", "parent", "scc_size"),
                          cpu, card):
        assert torch.equal(g.cpu(), c), name

    ring = DepGraph()
    for i in range(1000):
        ring.add_edge(i, (i + 1) % 1000, "ww")
    rng = np.random.default_rng(seed)
    for _ in range(2000):
        a, b = sorted(rng.integers(0, 1000, size=2))
        if a != b:
            ring.add_edge(int(a), int(b), "wr" if rng.random() < 0.5 else "rw")
    assert (scc.check_cycles_layered_device(ring, device="cuda")
            == scc.check_cycles_layered_device(ring, device="cpu"))
