"""The port's witness checkpoints (jepsen_tpu_torch/ops/wgl_witness.py),
on the CPU.

* Every case of tests/test_wgl_checkpoint.py through the port
  (tests/torch_ported.py): a budget-expired run leaves one
  `wgl-witness-<key>.ckpt.npz`, the next call resumes from its cursor
  and removes it, a concluded search leaves none, and foreign, corrupt
  and torn files are ignored.
* The file holds the bool member window whichever packing saved it: a
  save made with the packed lanes on resumes with them off, skips the
  saved blocks, and reaches the verdict of a fresh run.
* `Linearizable` hands the store directory (`opts["dir"]`) to the
  witness, which saves there."""

import glob
import os

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.checker import Linearizable
from jepsen_tpu_torch.history.packed import pack_history
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops import wgl_witness
from jepsen_tpu_torch.ops.wgl_witness import check_wgl_witness, plan_width
from jepsen_tpu_torch.utils.histgen import random_register_history

import torch_ported

PORTED = torch_ported.load("test_wgl_checkpoint")
PM = cas_register().packed()


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", torch_ported.cases(PORTED))
def test_checkpoint_cases_through_the_port(case, request):
    torch_ported.run(PORTED, case, request)


def _ckpts(d):
    return sorted(glob.glob(os.path.join(str(d), "wgl-witness-*.ckpt.npz")))


def _sweeps(monkeypatch):
    """Counts the witness's sweep calls."""
    real = wgl_witness.sweep
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(wgl_witness, "sweep", counted)
    return calls


def test_packed_save_resumes_wide(tmp_path, monkeypatch):
    packed = pack_history(random_register_history(
        5000, procs=8, info_rate=0.05, seed=3), PM.encode)
    kw = dict(bars_per_block=64, blocks_per_call=4, device="cpu")
    calls = _sweeps(monkeypatch)
    fresh = check_wgl_witness(packed, PM, packed_lanes=False, **kw)
    n_fresh = len(calls)
    assert fresh is not None and fresh.valid is True

    # The budget runs out after the first chunk: the packed run saves.
    assert check_wgl_witness(packed, PM, packed_lanes=True,
                             time_limit_s=1e-9,
                             checkpoint_dir=str(tmp_path), **kw) is None
    (path,) = _ckpts(tmp_path)
    W = plan_width(packed, 64)
    with np.load(path) as z:
        assert int(z["c0"]) == 4
        assert z["member"].dtype == bool and z["member"].shape == (W, 8)
        assert z["states"].shape == (8, PM.state_width)

    # Resumed with the packed lanes off: the saved window is read as
    # the bool window it is, the four saved blocks are not swept again,
    # and the verdict is the fresh run's.
    del calls[:]
    res = check_wgl_witness(packed, PM, packed_lanes=False,
                            checkpoint_dir=str(tmp_path), **kw)
    assert res is not None
    assert (res.valid, res.configs_explored) == (True,
                                                 fresh.configs_explored)
    assert 0 < len(calls) < n_fresh
    assert not _ckpts(tmp_path)


def test_linearizable_saves_in_the_store_dir(tmp_path, monkeypatch):
    """With `opts["dir"]` the witness saves its carry there (every chunk,
    with the minimum elapsed time set to 0), and removes the file when
    the check concludes."""
    monkeypatch.setattr(wgl_witness, "CKPT_MIN_ELAPSED_S", 0.0)
    real = wgl_witness._ckpt_save
    saved = []

    def save(path, *a):
        real(path, *a)
        saved.append((path, os.path.exists(path)))

    monkeypatch.setattr(wgl_witness, "_ckpt_save", save)
    h = random_register_history(2000, procs=8, info_rate=0.05, seed=8)
    out = Linearizable(cas_register(), device="cpu").check(
        {}, h, {"dir": str(tmp_path)})
    assert (out["valid"], out["algorithm"]) == (True, "wgl-tpu")
    assert saved and all(os.path.dirname(p) == str(tmp_path) and there
                         for p, there in saved)
    assert not _ckpts(tmp_path)
