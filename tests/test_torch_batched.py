"""Port parity for the batched per-key WGL search (ops/wgl_batched.py):
the port's host loop of per-level batches against the JAX package's
`vmap` of a `while_loop`, on identical packed input (numpy arrays
carried across), JAX side with bool member bitsets (no packed lanes)
and no mesh.  The padded table, every key's verdict and its explored
count must match exactly."""

import numpy as np
import pytest

import jepsen_tpu.models as ref_models
from jepsen_tpu.history.core import Op as RefOp
from jepsen_tpu.history.core import history as ref_history
from jepsen_tpu.history.packed import pack_history as ref_pack
from jepsen_tpu.ops.wgl_batched import check_wgl_batched as ref_batched
from jepsen_tpu.ops.wgl_batched import pack_batch as ref_pack_batch
from jepsen_tpu.utils.histgen import random_register_history as ref_gen
from jepsen_tpu_torch import convert
from jepsen_tpu_torch import device as D
from jepsen_tpu_torch import models
from jepsen_tpu_torch.ops.wgl_batched import (BatchedPack, check_wgl_batched,
                                              nonzero_rows, pack_batch)

from chip_smoke import mutex_ops, queue_ops

_REF_CAS = ref_models.cas_register().packed()
_CAS = models.cas_register().packed()


def _cas_packs(n_keys, n_ops, bad_keys, info=0.1, procs=4):
    ref = [ref_pack(ref_gen(n_ops, procs=procs, info_rate=info, seed=i,
                            bad=i in bad_keys), _REF_CAS.encode)
           for i in range(n_keys)]
    return ref, convert.packs_across(ref)


def _both(ref, port, ref_pm, pm, **kw):
    want = ref_batched(ref, ref_pm, packed_lanes=False, **kw)
    D.counters.clear()
    got = check_wgl_batched(port, pm, device="cpu", **kw)
    return got, want


def test_pack_batch_arrays_equal():
    ref, port = _cas_packs(6, 30, bad_keys=(2,))
    ref = ref + [ref[0]]
    port = convert.packs_across(ref)
    want = convert.batched_to_arrays(ref_pack_batch(ref))
    got = convert.batched_to_arrays(pack_batch(port))
    assert got.keys() == want.keys()
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name], want[name]), name
    again = convert.batched_from_arrays(want)
    assert isinstance(again, BatchedPack) and again.K == 7
    with pytest.raises(ValueError):
        convert.batched_from_arrays({**want, "f": want["f"][:, :3]})


@pytest.mark.parametrize("beam,max_beam", [(32, 16384), (32, 32)])
def test_batched_cas_matches_reference(beam, max_beam):
    """Valid and bad keys, with :info ops; at max_beam 32 some keys
    overflow and report "unknown" on both sides."""
    ref, port = _cas_packs(10, 40, bad_keys=(1, 6))
    got, want = _both(ref, port, _REF_CAS, _CAS, beam=beam,
                      max_beam=max_beam)
    assert got.valid == want.valid
    assert np.array_equal(got.explored, np.asarray(want.explored))
    assert got.beam_used == want.beam_used
    if max_beam > beam:
        assert got.valid[1] is False and got.valid[6] is False
    else:
        assert "unknown" in got.valid
    assert D.counters["bfs_levels"] > 0


def _model_packs(gen, ref_pm, n_keys, n_ops, bad_keys, **kw):
    ref = [ref_pack(ref_history([RefOp(**d) for d in gen(
        n_ops, seed=i, bad=i in bad_keys, **kw)]), ref_pm.encode)
        for i in range(n_keys)]
    return ref, convert.packs_across(ref)


@pytest.mark.parametrize("name,gen,kw", [
    ("mutex", mutex_ops, {}),
    ("fifo", queue_ops, {"procs": 3, "info": 0.0}),
    ("unordered", queue_ops, {}),
])
def test_batched_other_models_match_reference(name, gen, kw):
    pm = getattr(models, {"fifo": "fifo_queue", "unordered":
                          "unordered_queue"}.get(name, name))().packed()
    ref_pm = getattr(ref_models, {"fifo": "fifo_queue", "unordered":
                                  "unordered_queue"}.get(name, name))(
    ).packed()
    ref, port = _model_packs(gen, ref_pm, 6, 24, (0, 4), **kw)
    got, want = _both(ref, port, ref_pm, pm, beam=32)
    assert got.valid == want.valid
    assert np.array_equal(got.explored, np.asarray(want.explored))
    assert got.valid[0] is False and got.valid[4] is False


def test_empty_keys_accept_at_once():
    ref, port = _cas_packs(3, 20, bad_keys=())
    empty = ref_pack(ref_history([]), _REF_CAS.encode)
    ref = [empty] + ref
    got, want = _both(ref, convert.packs_across(ref), _REF_CAS, _CAS,
                      beam=32)
    assert got.valid == want.valid == [True] * 4
    assert np.array_equal(got.explored, np.asarray(want.explored))


@pytest.mark.parametrize("size", [1, 4, 9])
def test_nonzero_rows_pads_like_jnp(size):
    import jax.numpy as jnp
    import torch

    mask = np.random.default_rng(size).random((5, 12)) < 0.4
    want = np.stack([np.asarray(jnp.nonzero(row, size=size, fill_value=0)[0])
                     for row in mask])
    got = nonzero_rows(torch.from_numpy(mask), size)
    assert np.array_equal(got.numpy(), want)
