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


def sweep_tables(B, kind, seed):
    """Random sweep inputs (bars (6, K), member (W, B), states (B, SW),
    alive (B,), as numpy).  kind: "death" plants a barrier no lane
    survives at K/2; "padding" leaves no real barrier after K/4 and
    plants the death in the padding, where it must not count; "clean"
    lets lane 0 pass every barrier.  Lane 0 passes every real barrier
    but the planted one in "padding" and "clean"."""
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
    planted = K // 2 if kind == "death" else 3 * K // 4
    bars[0, planted] = W - 1  # no lane has this member bit
    bars[3, planted] = 0      # a read ...
    bars[4, planted] = 77     # ... of a value no lane holds
    if kind == "padding":
        bars[2, K // 4:] = 0
    return bars, member, states, alive


CASES = [(B, start, kind)
         for B in (8, 32) for start in (0, K // 2 - 5)
         for kind in ("death", "padding", "clean")]


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
    z = torch.zeros((6, 8), dtype=torch.int32)
    before = kernels.launches["witness_sweep"]
    with pytest.raises(ValueError, match="CUDA"):
        kernels.witness_sweep(1, 0, z, z[0], z[:1], z[0])
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


@pytest.mark.cuda
@pytest.mark.parametrize("B,start_k,kind", CASES)
def test_cuda_kernel_matches_plain(B, start_k, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernel has no CPU mode")
    dev = torch.device("cuda")
    pm = cas_register().packed()
    bars, member, states, alive = (
        torch.from_numpy(a).to(dev)
        for a in sweep_tables(B, kind, seed=B * 100 + start_k))
    before = kernels.launches["witness_sweep"]
    got = sweep(pm, start_k, bars, member, states, alive)
    want = sweep_plain(start_k, bars, member, states, alive,
                       pm.torch_step_rows)
    torch.cuda.synchronize()
    assert kernels.launches["witness_sweep"] == before + 1
    assert got[2] == want[2]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
