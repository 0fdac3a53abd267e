"""The witness barrier sweep: the port's plain version against the JAX
package's Pallas kernel in interpret mode — exact integer equality of
states, alive and death — and the member bit packing at B = 32 (the
sign bit).  The CUDA kernel itself is held against the plain version
on the card in tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

from jepsen_tpu.models import cas_register as ref_cas_register
from jepsen_tpu.ops.wgl_witness import _make_pallas_sweep
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops.wgl_witness import pack_member_bits, sweep_plain
from test_torch_kernels_cuda import CASES, SW, K, W, sweep_tables

_ref_sweeps = {}


def _ref_sweep(B):
    fn = _ref_sweeps.get(B)
    if fn is None:
        fn = _make_pallas_sweep(B, W, SW, K,
                                ref_cas_register().packed().jax_step_rows,
                                interpret=True)
        _ref_sweeps[B] = fn
    return fn


@pytest.mark.parametrize("B,start_k,kind", CASES)
def test_sweep_plain_matches_pallas_interpret(B, start_k, kind):
    bars, member, states, alive = sweep_tables(B, kind,
                                               seed=B * 100 + start_k)
    ref_s, ref_a, ref_d = _ref_sweep(B)(start_k, bars, member, states, alive)
    got_s, got_a, got_d = sweep_plain(
        start_k, torch.from_numpy(bars), torch.from_numpy(member),
        torch.from_numpy(states), torch.from_numpy(alive),
        cas_register().packed().torch_step_rows)
    assert got_d == int(ref_d)
    assert np.array_equal(got_s.numpy(), np.asarray(ref_s))
    assert np.array_equal(got_a.numpy(), np.asarray(ref_a))
    if kind == "death":
        assert got_d <= K // 2
    else:
        assert got_d == K


@pytest.mark.parametrize("B", [1, 8, 31, 32])
def test_pack_member_bits_sign_bit(B):
    rng = np.random.default_rng(B)
    member = rng.random((50, B)) < 0.5
    member[0] = True  # all lanes: bit 31 set at B = 32
    member[1] = False
    got = pack_member_bits(torch.from_numpy(member))
    assert got.dtype == torch.int32
    want = (member.astype(np.uint64) << np.arange(B, dtype=np.uint64)).sum(
        axis=1).astype(np.uint32).view(np.int32)
    assert np.array_equal(got.numpy(), want)
    # The kernel reads lane l as (word >> l) & 1 with an arithmetic shift.
    lanes = torch.arange(B, dtype=torch.int32)
    back = ((got[:, None] >> lanes[None, :]) & 1).bool()
    assert torch.equal(back, torch.from_numpy(member))
    if B == 32:
        assert int(got[0]) == -1


def test_pack_member_bits_rejects_wide_beam():
    with pytest.raises(ValueError, match="32-bit"):
        pack_member_bits(torch.zeros((4, 33), dtype=torch.bool))
