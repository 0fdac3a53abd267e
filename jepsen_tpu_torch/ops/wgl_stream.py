"""Key-concatenated stream witness checking for many small keys.

The port of `jepsen_tpu/ops/wgl_stream.py`.  All keys of a
`jepsen.independent` workload ride the witness engine as ONE history:
the per-key packed histories are concatenated on a disjoint timeline,
with a synthetic always-legal RESET barrier after each key that returns
the model to its initial state.  One witness pass then decides every
key.  Per-key isolation comes from three pieces:

  1. Disjoint timelines: key i's events occupy [seg_i, seg_i + E_i), so
     no op of one key overlaps another's in real time.
  2. RESET barriers: an ok op with f = F_RESET, (any state) -> initial
     state.  Every surviving lane steps to the initial state before the
     next key's first barrier.  On the card the sweep kernel's stream
     instantiation runs it (csrc/witness_sweep.cu STREAM).
  3. Rank fencing (`rank_override` of ops/wgl_witness.py): a key's
     indeterminate ops take the rank of their key's RESET, so once it
     passes they can neither linearize into a later key nor linger in
     its windows.

A stream verdict of True proves every key.  On a death, the witness's
death rank names the first key it could not decide: keys before it are
proven, the dead key stays None (the caller settles it exactly), and
the stream resumes after it, in segments of about K/8 keys once any key
has died.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Optional, Union

import numpy as np
import torch

from .. import device as _device
from ..history.packed import NO_RET, ST_OK, PackedOps
from ..models.base import PackedModel
from . import degrade
from .wgl_witness import INF, check_wgl_witness

#: Synthetic f-code of the inter-key RESET barrier: far above any op
#: code a model assigns, well inside int32.
F_RESET = 1 << 20

log = logging.getLogger(__name__)


def stream_model(pm: PackedModel) -> PackedModel:
    """`pm` with every transition taught the RESET op: f == F_RESET maps
    any state to the initial state and is always legal.  The base step
    sees f = 0 in RESET's place, so a model switching on f never meets
    the synthetic code."""
    init = tuple(int(v) for v in pm.init_state)
    base_py = pm.py_step
    base_step = pm.torch_step
    base_rows = pm.torch_step_rows

    def py_step(s, f, a0, a1):
        if f == F_RESET:
            return init, True
        return base_py(s, f, a0, a1)

    def torch_step(states, f, a0, a1):
        # (N, SW) rows; f a Python int or an (N,) int32 tensor.
        dev = states.device
        if not isinstance(f, torch.Tensor):
            if f != F_RESET:
                return base_step(states, f, a0, a1)
            f = torch.full((states.shape[0],), f, dtype=torch.int32,
                           device=dev)
        is_reset = f == F_RESET
        ns, legal = base_step(states, torch.where(is_reset, 0, f), a0, a1)
        init_row = torch.tensor(init, dtype=torch.int32, device=dev)
        return (torch.where(is_reset[:, None], init_row, ns),
                legal | is_reset)

    def torch_step_rows(states, f, a0, a1):
        # Lane-major (SW, B), one barrier op with Python-int codes.
        if f != F_RESET:
            return base_rows(states, f, a0, a1)
        init_col = torch.tensor(init, dtype=torch.int32,
                                device=states.device)[:, None]
        return (init_col.expand_as(states).clone(),
                torch.ones(states.shape[1], dtype=torch.bool,
                           device=states.device))

    return dataclasses.replace(
        pm,
        name=f"{pm.name}+stream",
        py_step=py_step,
        torch_step=torch_step,
        torch_step_rows=torch_step_rows,
        stream=True,
    )


def stream_timeline_len(packs: list[PackedOps]) -> int:
    """The combined timeline length `concat_packs` produces (an
    exclusive bound on every event index): per key, one past its
    largest event index, plus the RESET's two slots.  The witness's
    tables are int32, so a stream past INF goes to per-key checking."""
    total = 0
    for p in packs:
        if p.n:
            okm = p.status == ST_OK
            e_max = int(p.inv.max())
            if okm.any():
                e_max = max(e_max, int(p.ret[okm].max()))
            total += e_max + 3  # E = e_max + 1, plus the RESET's 2 slots
        else:
            total += 2
    return total


def concat_packs(
    packs: list[PackedOps],
) -> tuple[PackedOps, np.ndarray, np.ndarray]:
    """Concatenates per-key packs onto one disjoint timeline.

    Returns (combined, rank_override, key_of_bar):
      - combined: one PackedOps with a RESET row appended per key;
      - rank_override: (n,) int64, the key's RESET barrier rank for its
        indeterminate rows, -1 elsewhere (see check_wgl_witness);
      - key_of_bar: (n_bars,) int32 mapping global barrier rank -> key
        index (each key contributes its ok rows and its RESET).
    """
    K = len(packs)
    N = sum(p.n for p in packs) + K
    inv = np.empty(N, dtype=np.int64)
    ret = np.empty(N, dtype=np.int64)
    process = np.empty(N, dtype=np.int32)
    status = np.empty(N, dtype=np.int32)
    f = np.empty(N, dtype=np.int32)
    a0 = np.zeros(N, dtype=np.int32)
    a1 = np.zeros(N, dtype=np.int32)
    src_index = np.full(N, -1, dtype=np.int64)
    rank_override = np.full(N, -1, dtype=np.int64)

    kob_parts = []
    seg = 0          # current timeline offset
    row = 0          # current output row
    n_bars_cum = 0   # barriers emitted so far (ok rows + resets)
    for i, p in enumerate(packs):
        n = p.n
        okm = p.status == ST_OK
        n_ok = int(okm.sum())
        if n:
            # Segment width: one past the largest event index used.
            e_max = int(p.inv.max())
            if n_ok:
                e_max = max(e_max, int(p.ret[okm].max()))
            E = e_max + 1
            sl = slice(row, row + n)
            inv[sl] = p.inv + seg
            ret[sl] = np.where(okm, p.ret + seg, NO_RET)
            process[sl] = p.process
            status[sl] = p.status
            f[sl] = p.f
            a0[sl] = p.a0
            a1[sl] = p.a1
            src_index[sl] = p.src_index
            # Fence this key's indeterminate ops at its RESET's rank.
            rank_override[sl][~okm] = n_bars_cum + n_ok
        else:
            E = 0
        # The RESET barrier row.
        j = row + n
        inv[j] = seg + E
        ret[j] = seg + E + 1
        process[j] = -1
        status[j] = ST_OK
        f[j] = F_RESET
        kob_parts.append(np.full(n_ok + 1, i, dtype=np.int32))
        n_bars_cum += n_ok + 1
        seg += E + 2
        row += n + 1

    key_of_bar = (np.concatenate(kob_parts) if kob_parts
                  else np.empty(0, dtype=np.int32))
    combined = PackedOps(
        inv=inv, ret=ret, process=process, status=status, f=f, a0=a0,
        a1=a1, src_index=src_index,
        # Witness-only pack: the BFS's preds/horizon are never read on
        # this path (keys escalate one by one, not as the combined
        # history).
        preds=np.zeros(N, dtype=np.int64),
        horizon=np.full(N, N - 1, dtype=np.int64),
    )
    return combined, rank_override, key_of_bar


def check_wgl_witness_stream(
    packs: list[PackedOps],
    pm: PackedModel,
    *,
    time_limit_s: Optional[float] = None,
    device: Union[str, torch.device, None] = "cuda",
) -> list[Any]:
    """Per-key verdicts via the concatenated stream: True (proven
    linearizable) or None (undecided: settle exactly); never False.

    The first pass concatenates every key; after a death the stream
    resumes in segments of max(8, ceil(K / 8)) keys, so a dead key
    costs a re-plan of its segment, not of everything after it.  Past
    max(8, K // 2) restarts the rest stay None.  A device resource error on a pass leaves
    the remaining keys None for the per-key tiers on the same device;
    any other error, a kernel's included, raises.  Counts
    "stream_passes", "stream_restarts" and "stream_keys_proven" in
    `device.counters`."""
    dev = _device.resolve(device)
    K = len(packs)
    verdicts: list[Any] = [None] * K
    if K == 0:
        return verdicts
    if stream_timeline_len(packs) >= INF:
        # The witness clamps event indices to int32; per-key checking
        # stays in int64.
        log.info("stream witness: combined timeline exceeds int32; "
                 "per-key checking for %d keys", K)
        return verdicts
    spm = stream_model(pm)
    t0 = time.monotonic()
    max_restarts = max(8, K // 2)
    seg = max(8, -(-K // 8))
    start = 0
    restarts = 0
    span = K  # the first pass spans every key
    while start < K:
        remaining = None
        if time_limit_s is not None:
            remaining = time_limit_s - (time.monotonic() - t0)
            if remaining <= 0:
                break
        end = min(K, start + span)
        combined, override, key_of_bar = concat_packs(packs[start:end])
        info: dict = {}
        _device.count("stream_passes")
        try:
            r = check_wgl_witness(combined, spm, rank_override=override,
                                  out_info=info, time_limit_s=remaining,
                                  device=dev)
        except Exception as e:  # noqa: BLE001 — only resource errors
            if not degrade.is_resource_error(e):
                raise
            # The concatenated stream is too big for the device: leave
            # the remaining keys to the per-key tiers.
            degrade.record("stream", "fall-through", e)
            log.warning("stream witness exhausted device resources; "
                        "per-key tiers for %d keys", K - start,
                        exc_info=True)
            break
        if r is not None and r.valid is True:
            for k in range(start, end):
                verdicts[k] = True
            start = end
            continue
        died = info.get("died_at_rank")
        if died is None:
            break  # budget blown or not localized: the rest stay None
        bad = int(key_of_bar[died])
        # Every barrier of the keys before the dead one was linearized
        # before the death: those keys are proven.
        for k in range(bad):
            verdicts[start + k] = True
        start += bad + 1
        span = seg
        restarts += 1
        _device.count("stream_restarts")
        if restarts >= max_restarts:
            log.info("stream witness: %d restarts (max %d); %d keys left "
                     "for the exact engines", restarts, max_restarts,
                     K - start)
            break
    _device.count("stream_keys_proven",
                  sum(1 for v in verdicts if v is True))
    return verdicts
