"""The witness sweep kernel (csrc/witness_sweep.cu) against its plain
PyTorch version on the card, and the CPU-side contract of its wrapper.

This file imports only the port (no jax), so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py

The `cuda`-marked tests skip without a card: a CUDA kernel has no CPU
mode.  `sweep_tables` is shared with tests/test_torch_witness_sweep.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops import kernels
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
    model with no device step and a beam wider than one member word
    are errors there, not a route to the plain sweep.  ("meta" tensors
    stand in for the card: they reach the same checks.)"""
    pm = cas_register().packed()
    no_step = dataclasses.replace(pm, kernel_model=None)
    before = kernels.launches["witness_sweep"]
    for B, model, match in ((8, no_step, "no device step"),
                            (33, pm, "one 32-bit member word")):
        bars, member, states, alive = (
            torch.from_numpy(a).to("meta")
            for a in sweep_tables(min(B, 32), "clean", 2))
        member = torch.zeros((W, B), dtype=torch.bool, device="meta")
        with pytest.raises(ValueError, match=match):
            sweep(model, 0, bars, member, states, alive)
    assert kernels.launches["witness_sweep"] == before


@pytest.mark.parametrize("B", [33, 64])
def test_sweep_refuses_a_beam_wider_than_one_member_word(B):
    """The sweep itself refuses B > 32 before the kernel is reached."""
    pm = cas_register().packed()
    bars = torch.zeros((6, K), dtype=torch.int32, device="meta")
    member = torch.zeros((W, B), dtype=torch.bool, device="meta")
    states = torch.zeros((B, SW), dtype=torch.int32, device="meta")
    alive = torch.zeros(B, dtype=torch.bool, device="meta")
    before = kernels.launches["witness_sweep"]
    with pytest.raises(ValueError, match="32-bit member word"):
        sweep(pm, 0, bars, member, states, alive)
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
    contiguous, 1 <= B <= 32, on the card — and raises on anything else
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
