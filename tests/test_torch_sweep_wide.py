"""The witness sweep kernel past one 32-lane block and past 32 words of
state: beams of any width and multi-register states of any width
(csrc/witness_sweep.cu), against the plain version.

* On the CPU: the wrapper's limits (the shapes it passes on to the card,
  any beam and any width, and the ValueError before any launch for the
  rest), and the decomposition the kernel relies on for a beam that
  spans more than one block, in plain PyTorch: each group of L lanes
  swept alone and joined (the latest death; a group that died earlier
  all dead, its states as it left them) equals the joint sweep, for two
  32-lane groups, for G of them (B = 65-200), and for the narrow blocks
  of a wide state (L = 1-13).
* On the card (`cuda`, skipped without one): the kernel equals the
  plain version exactly for every model at B = 33, 48, 64, 96, 128 and
  200, and for the wide multi-register at widths 33, 40 and 64 from
  B = 1 to 64 and past 1,722 words (fewer lanes a block, and rows in
  global memory past 55,132 words), with the kernel's batch edges and
  lane groups dead from the start.

Like tests/test_torch_kernels_cuda.py, whose table builders it shares,
this file imports no jax, so it also runs on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_sweep_wide.py
"""

import numpy as np
import pytest
import torch

import test_torch_kernels_cuda as kc
from jepsen_tpu_torch.models import multi_register
from jepsen_tpu_torch.ops import kernels
from jepsen_tpu_torch.ops.wgl_stream import stream_model
from jepsen_tpu_torch.ops.wgl_witness import sweep, sweep_plain

K, W = kc.K, kc.W

#: Wide multi-register widths; their packed models by test name.
WIDTHS = (33, 40, 64)
_wide_pms = {}


def wide_pm(name):
    """"multi<n>" or "multi<n>+stream" -> its packed model."""
    pm = _wide_pms.get(name)
    if pm is None:
        base, _, stream = name.partition("+")
        n = int(base[len("multi"):])
        pm = multi_register({f"r{i}": 0 for i in range(n)}).packed()
        if stream:
            pm = stream_model(pm)
        _wide_pms[name] = pm
    return pm


def pm_of(name):
    base = name.partition("+")[0]
    return kc.model_pm(name) if base in kc.MODEL_FACTORIES else wide_pm(name)


WIDE_NAMES = [f"multi{n}{s}" for n in WIDTHS for s in ("", "+stream")]


def tables(name, B, kind, seed, start_k=0, L=32):
    """`model_tables` at any beam, with the sign bit of each 32-lane
    member word in use, and three more kinds past one block of L lanes:
    "high-dead" (lanes L.. dead from the start), "low-dead" (lanes
    0..L-1 dead, lane L alive and passing every real barrier but the
    death's) and "last-alive" (every group but the last dead, the last
    one's first lane passing as lane L of "low-dead"), so the lane
    groups die at different barriers."""
    kc._pms.setdefault(name, pm_of(name))
    extra = ("high-dead", "low-dead", "last-alive")
    base_kind = "death" if kind in extra else kind
    bars, member, states, alive = kc.model_tables(name, B, base_kind, seed,
                                                  start_k)
    rng = np.random.default_rng(seed + 1)
    for lane in range(31, B, 32):
        member[: W - 1, lane] = rng.random(W - 1) < 0.8
    if kind == "high-dead":
        alive[L:] = False
    elif kind in ("low-dead", "last-alive"):
        first = L if kind == "low-dead" else (B - 1) // L * L
        alive[:first] = False
        alive[first] = True
        member[: W - 1, first] = True
    return bars, member, states, alive


def grouped_plain(start_k, bars, member, states, alive, step_rows, L=32):
    """The kernel's decomposition of a beam that spans more than one
    block of L lanes, in plain PyTorch: each L-lane group sweeps alone;
    the sweep dies at the latest group death, and a group that died
    before it is left all dead with the states it returned."""
    outs = [sweep_plain(start_k, bars, member[:, lo:lo + L].contiguous(),
                        states[lo:lo + L], alive[lo:lo + L], step_rows)
            for lo in range(0, member.shape[1], L)]
    death = max(d for _, _, d in outs)
    s = torch.cat([o[0] for o in outs])
    a = torch.cat([o[1] if o[2] >= death else torch.zeros_like(o[1])
                   for o in outs])
    return s, a, death


KINDS = ("clean", "death", "padding", "dead+0", "dead+31", "high-dead",
         "low-dead")


@pytest.mark.parametrize("name", ["register", "mutex+stream", "multi5",
                                  "fifo", "unordered+stream", "multi40"])
@pytest.mark.parametrize("B", [33, 48, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_two_lane_groups_joined_equal_the_joint_sweep(name, B, kind):
    """What the kernel does for B > 32, checked on the CPU: the joined
    group sweeps equal the plain sweep of the whole beam."""
    start = 1 if kind.startswith("dead+") else 0
    pm = pm_of(name)
    args = tuple(torch.from_numpy(a) for a in tables(
        name, B, kind, seed=B + len(name) + len(kind), start_k=start))
    want = sweep_plain(start, *args, pm.torch_step_rows)
    got = grouped_plain(start, *args, pm.torch_step_rows)
    assert got[2] == want[2]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


G_KINDS = ("death", "dead+31", "high-dead", "low-dead", "last-alive")


@pytest.mark.parametrize("name", ["register", "mutex+stream", "fifo",
                                  "unordered+stream", "multi40+stream"])
@pytest.mark.parametrize("B", [65, 96, 128, 200])
@pytest.mark.parametrize("kind", G_KINDS)
def test_g_lane_groups_joined_equal_the_joint_sweep(name, B, kind):
    """What the kernel does for a beam of G = ceil(B / 32) blocks,
    checked on the CPU: the joined group sweeps equal the plain sweep
    of the whole beam."""
    start = 1 if kind.startswith("dead+") else 0
    pm = pm_of(name)
    args = tuple(torch.from_numpy(a) for a in tables(
        name, B, kind, seed=B + 3 * len(name) + len(kind), start_k=start))
    want = sweep_plain(start, *args, pm.torch_step_rows)
    got = grouped_plain(start, *args, pm.torch_step_rows)
    assert got[2] == want[2]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", ["multi40", "multi64+stream"])
@pytest.mark.parametrize("B,L", [(8, 1), (8, 3), (33, 7), (40, 13),
                                 (64, 31)])
@pytest.mark.parametrize("kind", G_KINDS)
def test_narrow_blocks_of_a_wide_state_equal_the_joint_sweep(name, B, L,
                                                             kind):
    """A wide state sweeps in blocks of L < 32 lanes (as many as have
    rows that fit the block's shared memory): the joined L-lane groups
    equal the plain sweep of the whole beam, on the CPU."""
    start = 1 if kind.startswith("dead+") else 0
    pm = pm_of(name)
    args = tuple(torch.from_numpy(a) for a in tables(
        name, B, kind, seed=B + L + len(kind), start_k=start, L=L))
    want = sweep_plain(start, *args, pm.torch_step_rows)
    got = grouped_plain(start, *args, pm.torch_step_rows, L=L)
    assert got[2] == want[2]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wrapper_limits():
    """What the wrapper passes on to the card (it refuses these CPU
    tensors only for not being on a card): any beam, and a
    multi-register state of any width (fewer lanes a block, or rows in
    global memory); and what it refuses before any launch: an empty
    beam, a wide state for a model without the wide instantiation."""
    before = kernels.launches["witness_sweep"]

    def call(model, B, sw):
        bars = torch.zeros((6, K), dtype=torch.int32)
        member = torch.zeros((W, B), dtype=torch.bool)
        states = torch.zeros((B, sw), dtype=torch.int32)
        alive = torch.zeros(B, dtype=torch.bool)
        kernels.witness_sweep(model, 0, bars, member, states, alive)

    for model, B, sw in ((1, 33, 1), (1, 64, 1), (3, 64, 33), (3, 8, 40),
                         (3, 32, 1722), (3, 8, 1722), (3, 1, 55132),
                         (4, 64, 32), (1, 65, 1), (1, 200, 1), (5, 96, 32),
                         (3, 32, 1723), (3, 64, 1723), (3, 1, 55133),
                         (3, 40, 70_000)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call(model, B, sw)
    for model, B, sw, match in (
            (1, 0, 1, "bad shapes"),
            (4, 8, 33, "state widths"),
            (1, 8, 2, "state widths")):
        with pytest.raises(ValueError, match=match):
            call(model, B, sw)
    assert kernels.launches["witness_sweep"] == before


def test_instantiation_names():
    assert kernels.instantiation_name(3, 32, False) == \
        "witness_sweep[multi-register]"
    assert kernels.instantiation_name(3, 33, False) == \
        "witness_sweep[multi-register-wide]"
    assert kernels.instantiation_name(3, 40, True) == \
        "witness_sweep[multi-register-wide+stream]"
    assert kernels.instantiation_name(1, 1, True) == \
        "witness_sweep[register+stream]"
    assert kernels.instantiation_name(3, 40, True, 32) == \
        "witness_sweep[multi-register-wide+stream]"
    for model, sw in ((1, 1), (3, 40)):
        assert kernels.instantiation_name(model, sw, False, 33) == \
            "witness_sweep[beam>32]"


def test_sweep_checks_the_width_at_its_beam():
    """`sweep` passes a state past what 32 lanes' rows in shared memory
    hold (1,722 words) on to the wrapper, which takes it at any beam
    and refuses these "meta" tensors (standing in for the card) only
    for not being on one."""
    n = 1723
    pm = multi_register({f"r{i}": 0 for i in range(n)}).packed()
    for B in (32, 96):
        args = (torch.zeros((6, K), dtype=torch.int32, device="meta"),
                torch.zeros((W, B), dtype=torch.bool, device="meta"),
                torch.zeros((B, n), dtype=torch.int32, device="meta"),
                torch.zeros(B, dtype=torch.bool, device="meta"))
        with pytest.raises(ValueError, match="CUDA tensors"):
            sweep(pm, 0, *args)


#: (model, B, start, kind) cases on the card: every model at the wide
#: beams, the wide multi-register from one lane to two blocks.
CUDA_CASES = (
    [(m, B, s, k) for m in kc.MODEL_NAMES for B in (33, 48, 64, 96, 128, 200)
     for s, k in ((0, "death"), (33, "padding"), (31, "dead+0"),
                  (1, "dead+31"), (0, "high-dead"), (0, "low-dead"))
     + (((0, "last-alive"),) if B > 64 else ())]
    + [(m, B, s, k) for m in WIDE_NAMES for B in (1, 8, 32, 33, 64)
       for s, k in ((0, "clean"), (0, "death"), (33, "padding"),
                    (31, "dead+0"), (1, "dead+31"), (0, "dead+32"))
       + (((0, "high-dead"), (0, "low-dead")) if B > 32 else ())])


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,start_k,kind", CUDA_CASES)
def test_cuda_wide_kernel_matches_plain(name, B, start_k, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernel has no CPU mode")
    dev = torch.device("cuda")
    pm = pm_of(name)
    host = tuple(torch.from_numpy(a) for a in tables(
        name, B, kind, seed=B * 100 + start_k + len(name), start_k=start_k))
    init = (torch.tensor(pm.init_state, dtype=torch.int32, device=dev)
            if pm.stream else None)
    key = kernels.instantiation_name(pm.kernel_model, pm.state_width,
                                     pm.stream, B)
    before = kernels.launches[key]
    got = sweep(pm, start_k, *(t.to(dev) for t in host), init)
    torch.cuda.synchronize()
    want = sweep_plain(start_k, *host, pm.torch_step_rows)
    assert kernels.launches[key] == before + 1
    assert got[2] == want[2]
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    if kind.startswith("dead+") and not name.startswith("mutex"):
        assert got[2] == start_k + int(kind[len("dead+"):])


#: Shared memory the wide kernel's rows may fill (232,448 bytes a block
#: less its 11,920 bytes of static rings, as ptxas counts them): 1,722
#: words at 32 lanes a block, 55,132 at one.
WIDE_ROOM = 232_448 - 11_920


@pytest.mark.cuda
@pytest.mark.parametrize("sw", [1722, 1723, 6891, 55132, 55133])
@pytest.mark.parametrize("B", [1, 32, 96])
def test_cuda_wide_kernel_at_the_width_limit(sw, B):
    """At the widths where a block's lanes change (1,722 words fill 32
    lanes' shared memory to the byte, 1,723 take 31 lanes, 6,891 eight,
    55,132 one) and past them (55,133: the rows stay in global memory,
    32 lanes a block), the built kernel lays the sweep out as the
    shared-memory budget says, launches, joins its lane groups, and
    equals the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernel has no CPU mode")
    dev = torch.device("cuda")
    lanes, blocks, rows_global = kernels.sweep_geometry(3, sw, B)
    fit = min(32, WIDE_ROOM // (4 * sw))
    assert rows_global == (fit == 0)
    assert lanes == (fit or 32)
    assert blocks == -(-B // lanes)
    name = f"multi{sw}"
    pm = kc._pms.setdefault(name, wide_pm(name))
    kind = "low-dead" if B > lanes else "death"
    host = tuple(torch.from_numpy(a)
                 for a in tables(name, B, kind, seed=B + sw, L=lanes))
    before = dict(kernels.launches)
    got = sweep(pm, 0, *(t.to(dev) for t in host))
    torch.cuda.synchronize()
    want = sweep_plain(0, *host, pm.torch_step_rows)
    assert got[2] == want[2]
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    grew = {k for k, n in kernels.launches.items() if n > before.get(k, 0)}
    assert ("witness_sweep[join]" in grew) == (blocks > 1)
    assert ("witness_sweep[multi-register-wide-global]" in grew) == \
        rows_global
    assert ("witness_sweep[multi-register-wide-narrow]" in grew) == \
        (not rows_global and lanes < 32)
