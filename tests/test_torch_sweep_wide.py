"""The witness sweep kernel past one 32-lane block and past 32 words of
state: beams of 33-64 lanes and multi-register states wider than 32
words (csrc/witness_sweep.cu), against the plain version.

* On the CPU: the wrapper's limits (the shapes it passes on to the card
  and the ValueError before any launch above them), and the
  decomposition the kernel relies on for a wide beam, in plain
  PyTorch: each 32-lane group swept alone and joined (the later death;
  a group that died earlier all dead, its states as it left them)
  equals the joint sweep.
* On the card (`cuda`, skipped without one): the kernel equals the
  plain version exactly for every model at B = 33, 48 and 64, and for
  the wide multi-register at widths 33, 40 and 64 from B = 1 to 64,
  with the kernel's batch edges and one lane group dead from the start.

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
from jepsen_tpu_torch.ops.wgl_witness import (MAX_KERNEL_BEAM,
                                              MAX_KERNEL_STATE, sweep,
                                              sweep_plain)

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
    return wide_pm(name) if name in WIDE_NAMES else kc.model_pm(name)


WIDE_NAMES = [f"multi{n}{s}" for n in WIDTHS for s in ("", "+stream")]


def tables(name, B, kind, seed, start_k=0):
    """`model_tables` at any beam, with the sign bit of each 32-lane
    member word in use, and two more kinds past 32 lanes: "high-dead"
    (lanes 32.. dead from the start) and "low-dead" (lanes 0-31 dead,
    lane 32 alive and passing every real barrier but the death's), so
    the two lane groups die at different barriers."""
    if name in WIDE_NAMES:
        kc._pms.setdefault(name, wide_pm(name))
    base_kind = "death" if kind in ("high-dead", "low-dead") else kind
    bars, member, states, alive = kc.model_tables(name, B, base_kind, seed,
                                                  start_k)
    rng = np.random.default_rng(seed + 1)
    for lane in (31, 63):
        if lane < B:
            member[: W - 1, lane] = rng.random(W - 1) < 0.8
    if kind == "high-dead":
        alive[32:] = False
    elif kind == "low-dead":
        alive[:32] = False
        alive[32] = True
        member[: W - 1, 32] = True
    return bars, member, states, alive


def grouped_plain(start_k, bars, member, states, alive, step_rows):
    """The kernel's decomposition of a beam past 32 lanes, in plain
    PyTorch: each 32-lane group sweeps alone; the sweep dies at the
    later group death, and a group that died before it is left all
    dead with the states it returned."""
    outs = [sweep_plain(start_k, bars, member[:, lo:lo + 32].contiguous(),
                        states[lo:lo + 32], alive[lo:lo + 32], step_rows)
            for lo in range(0, member.shape[1], 32)]
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


def test_wrapper_limits():
    """What the wrapper passes on to the card (it refuses these CPU
    tensors only for not being on a card) and what it refuses before
    any launch: a beam past two 32-lane blocks, a multi-register state
    whose rows overflow the block's shared memory, a wide state for a
    model without the wide instantiation."""
    assert MAX_KERNEL_BEAM == kernels.MAX_SWEEP_BEAM == 64
    assert MAX_KERNEL_STATE == kernels.max_sweep_width(64) == 1722
    assert kernels.max_sweep_width(32) == kernels.max_sweep_width(64)
    assert kernels.max_sweep_width(1) == 55132  # (232,448 - 11,920) // 4
    before = kernels.launches["witness_sweep"]

    def call(model, B, sw):
        bars = torch.zeros((6, K), dtype=torch.int32)
        member = torch.zeros((W, B), dtype=torch.bool)
        states = torch.zeros((B, sw), dtype=torch.int32)
        alive = torch.zeros(B, dtype=torch.bool)
        kernels.witness_sweep(model, 0, bars, member, states, alive)

    for model, B, sw in ((1, 33, 1), (1, 64, 1), (3, 64, 33), (3, 8, 40),
                         (3, 32, 1722), (3, 8, 1722), (3, 1, 55132),
                         (4, 64, 32)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call(model, B, sw)
    for model, B, sw, match in (
            (1, 65, 1, "B must be 1..64"),
            (3, 32, 1723, "1723 > 1722"),
            (3, 64, 1723, "shared memory"),
            (3, 1, 55133, "55133 > 55132"),
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
    """`sweep` passes a state the kernel cannot hold at this beam to
    the wrapper, which refuses it before the kernel is reached ("meta"
    tensors stand in for the card)."""
    n = kernels.max_sweep_width(32) + 1
    pm = multi_register({f"r{i}": 0 for i in range(n)}).packed()
    args = (torch.zeros((6, K), dtype=torch.int32, device="meta"),
            torch.zeros((W, 32), dtype=torch.bool, device="meta"),
            torch.zeros((32, n), dtype=torch.int32, device="meta"),
            torch.zeros(32, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="shared memory"):
        sweep(pm, 0, *args)


#: (model, B, start, kind) cases on the card: every model at the wide
#: beams, the wide multi-register from one lane to two blocks.
CUDA_CASES = (
    [(m, B, s, k) for m in kc.MODEL_NAMES for B in (33, 48, 64)
     for s, k in ((0, "death"), (33, "padding"), (31, "dead+0"),
                  (1, "dead+31"), (0, "high-dead"), (0, "low-dead"))]
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


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 32, 64])
def test_cuda_wide_kernel_at_the_width_limit(B):
    """The widest state the wrapper passes on at this beam
    (`max_sweep_width(B)`: the rows fill the block's shared memory to
    the byte) launches and equals the plain version, so the Python
    limit is not above what the built kernel takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernel has no CPU mode")
    dev = torch.device("cuda")
    name = f"multi{kernels.max_sweep_width(B)}"
    pm = kc._pms.setdefault(name, wide_pm(name))
    host = tuple(torch.from_numpy(a)
                 for a in kc.model_tables(name, B, "death", seed=B))
    got = sweep(pm, 0, *(t.to(dev) for t in host))
    torch.cuda.synchronize()
    want = sweep_plain(0, *host, pm.torch_step_rows)
    assert got[2] == want[2]
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
