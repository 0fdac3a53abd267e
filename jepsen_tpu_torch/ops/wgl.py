"""Device Wing–Gong–Lowe linearizability search, in PyTorch.

The port of `jepsen_tpu/ops/wgl.py`.  Two tiers: the just-in-time
witness search (ops/wgl_witness.py), exact for valid verdicts, with a
narrow and then a wide info window; when it finds no witness, the
level-synchronous frontier BFS below settles the verdict:

* BFS by linearized-count level: every frontier config has |S| = n, so
  the member set needs bits only for the *active window* — ops neither
  guaranteed members (horizon < n) nor guaranteed non-members (preds >=
  n + block).  The window is recomputed on the host every `block`
  levels and the frontier re-gathered on the device.
* The candidate rule (op a appendable iff inv(a) < min ret over the
  other non-members) is two masked min-reductions per config.
* Candidate (config, op) pairs are compacted to a fixed number of
  slots, the model step runs over them, and children are deduplicated
  by a float-hash lexsort plus exact adjacent compare — equal configs
  always hash equal, so dedup is exact.
* Beam or candidate overflow retries the block with a doubled beam
  from its start; past `max_beam` an invalid verdict degrades to
  "unknown" (valid stays sound).

The JAX package runs each block as one jitted while-loop; here the
level loop runs on the host with one device read per level
(`device.counters["host_syncs"]`).
"""

from __future__ import annotations

import time
from typing import Optional, Union

import numpy as np
import torch

from .. import device as _device
from ..checker.wgl_cpu import WGLResult
from ..history.packed import ST_OK, PackedOps
from ..models.base import PackedModel

#: int32 "never" sentinel (ret of indeterminate ops, padding).  A
#: Python int so torch ops against int32 tensors stay int32.
INF = 2**31 - 1

#: Candidate (config, op) slots per beam row in each BFS level.
CAND_FACTOR = 4

#: Widest active window the BFS takes on; wider returns "unknown".
MAX_WINDOW = 16384


def _bucket(x: int, lo: int = 256) -> int:
    w = lo
    while w < x:
        w *= 2
    return w


def nonzero_static(mask: torch.Tensor, size: int,
                   fill_value: int = 0) -> torch.Tensor:
    """Indices of the True entries of 1-d `mask`, ascending, padded with
    `fill_value` (or cut) to exactly `size` entries — the reference's
    `jnp.nonzero(mask, size=size, fill_value=fill_value)`, with the same
    padding, which callers use.  Built from a cumsum and a scatter, so
    it never waits for the device as `torch.nonzero` does."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    dest = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), fill_value, dtype=torch.int64,
                     device=mask.device)
    # Entries that are not kept all land in the spare slot `size`.
    out.scatter_(0, dest, torch.arange(n, device=mask.device))
    return out[:size]


def _hash_vectors(w: int, sw: int, seed: int = 0x5EED) -> tuple[np.ndarray, ...]:
    rng = np.random.default_rng(seed)
    return (
        rng.uniform(1.0, 2.0, size=(w,)).astype(np.float32),
        rng.uniform(1.0, 2.0, size=(w,)).astype(np.float32),
        rng.uniform(1.0, 2.0, size=(sw,)).astype(np.float32),
        rng.uniform(1.0, 2.0, size=(sw,)).astype(np.float32),
    )


def window_regather(prev_active: np.ndarray, active: np.ndarray):
    """(perm, present) mapping a new window layout onto the previous
    one: new column j reads old column perm[j] where present[j].  Shared
    by the BFS and witness paths."""
    pos = np.searchsorted(prev_active, active)
    pos_clip = np.clip(pos, 0, len(prev_active) - 1)
    present = (pos < len(prev_active)) & (prev_active[pos_clip] == active)
    perm = np.where(present, pos_clip, 0)
    return perm, present


def _window_tables(packed: PackedOps, n0: int, K: int, max_window: int):
    """Host-side window computation for levels [n0, n0+K)."""
    preds = packed.preds
    horizon = packed.horizon
    active = np.nonzero((preds < n0 + K) & (horizon >= n0))[0]
    if len(active) > max_window:
        return None  # window overflow
    future = np.nonzero(preds >= n0 + K)[0]
    ret = np.minimum(packed.ret, np.int64(INF)).astype(np.int32)
    if len(future):
        fmin1 = int(ret[future].min())
        f_has_ok = bool((packed.status[future] == ST_OK).any())
    else:
        fmin1 = INF
        f_has_ok = False
    W = _bucket(max(len(active), 1))
    pad = W - len(active)

    def pad_to(arr, fill):
        return np.concatenate([arr, np.full(pad, fill, dtype=arr.dtype)])

    tables = dict(
        ret_w=pad_to(ret[active], INF),
        inv_w=pad_to(packed.inv[active].astype(np.int32), INF),
        f_w=pad_to(packed.f[active], 0),
        a0_w=pad_to(packed.a0[active], 0),
        a1_w=pad_to(packed.a1[active], 0),
        ok_w=pad_to(packed.status[active] == ST_OK, False),
        fmin1=fmin1,
        f_has_ok=f_has_ok,
    )
    return active, W, tables


def _expand_level(member, states, alive, tables, n_slots, pm: PackedModel):
    """One frontier level's expansion: candidate rule, fixed-size
    compaction, model step, child bitsets, acceptance and dedup hashes.
    member (B, W) bool, states (B, SW) i32, alive (B,) bool.

    Returns (child, new_states, live_c, h1, h2, accepted_any,
    overflow), the last two as 0-d device tensors."""
    ret_w, inv_w, f_w, a0_w, a1_w, ok_w = (
        tables[k] for k in ("ret_w", "inv_w", "f_w", "a0_w", "a1_w", "ok_w"))
    fmin1, f_has_ok = tables["fmin1"], tables["f_has_ok"]
    h1v, h2v, sh1v, sh2v = tables["hash"]
    B, W = member.shape
    dev = member.device
    rows = torch.arange(B, device=dev)

    # --- candidate rule ---------------------------------------------
    nm_ret = torch.where(member | ~alive[:, None], INF, ret_w[None, :])
    m1w, am1 = nm_ret.min(dim=1)  # first index of the minimum
    nm_ret2 = nm_ret.clone()
    nm_ret2[rows, am1] = INF
    m2w = nm_ret2.min(dim=1).values
    # Merge with the host-precomputed min over "future" ops outside the
    # window — they are non-members of every config.
    is_w_min = m1w <= fmin1
    total_m1 = torch.clamp(m1w, max=fmin1)
    second_for_argmin = torch.clamp(m2w, max=fmin1)
    bound = torch.where(
        (torch.arange(W, device=dev)[None, :] == am1[:, None])
        & is_w_min[:, None],
        second_for_argmin[:, None],
        total_m1[:, None],
    )
    order_ok = (~member) & alive[:, None] & (inv_w[None, :] < bound)

    # --- compact candidate (config, op) pairs ------------------------
    flat = order_ok.reshape(-1)
    count = flat.sum()
    cand_idx = nonzero_static(flat, n_slots, 0)
    valid_c = torch.arange(n_slots, device=dev) < count
    overflow = count > n_slots
    parent = cand_idx // W
    a = cand_idx % W

    # --- model transition over the candidates -------------------------
    new_states, legal = pm.torch_step(states[parent], f_w[a], a0_w[a], a1_w[a])
    live_c = valid_c & legal

    child = member[parent]
    child[torch.arange(n_slots, device=dev), a] = True

    # --- acceptance: some live child covers every :ok op -------------
    cover = (child | ~ok_w[None, :]).all(dim=1)
    accepted_any = (live_c & cover).any() & (not f_has_ok)

    # --- dedup hashes (full float32: equal configs hash equal) --------
    cf = child.to(torch.float32)
    sf = new_states.to(torch.float32)
    big = torch.tensor(3.0e38, dtype=torch.float32, device=dev)
    with _device.exact_float32():
        h1 = torch.where(live_c, cf @ h1v + sf @ sh1v, big)
        h2 = torch.where(live_c, cf @ h2v + sf @ sh2v, big)
    return child, new_states, live_c, h1, h2, accepted_any, overflow


def _dedup_sort(child, new_states, live_c, h1, h2):
    """Hash lexsort + exact adjacent compare over candidates.  The sort
    is stable on (h1, h2) — sort by the second key, then stably by the
    first — matching `lax.sort(num_keys=2)`, whose tie order decides
    which children fill the beam.  Returns (child_s, states_s, uniq,
    n_uniq) in sort order."""
    p2 = torch.sort(h2, stable=True).indices
    p1 = torch.sort(h1[p2], stable=True).indices
    perm = p2[p1]
    h1s, h2s = h1[perm], h2[perm]
    child_s = child[perm]
    states_s = new_states[perm]
    live_s = live_c[perm]
    same_h = (h1s == h1s.roll(1)) & (h2s == h2s.roll(1))
    same_h[0] = False
    same_full = (
        same_h
        & (child_s == child_s.roll(1, dims=0)).all(dim=1)
        & (states_s == states_s.roll(1, dims=0)).all(dim=1)
    )
    uniq = live_s & ~same_full
    return child_s, states_s, uniq, uniq.sum()


def _run_block(member, states, alive, iters: int, tables, B: int,
               Cmax: int, pm: PackedModel):
    """Up to `iters` BFS levels from one frontier: the reference's
    jitted `block` while-loop, driven from the host with one device
    read per level.  An overflow does not stop the block: a truncated
    frontier that reaches acceptance still proves the history valid.

    Returns (member, states, alive, accepted, incomplete, explored,
    levels)."""
    accepted = incomplete = False
    explored = it = 0
    dev = member.device
    while it < iters:
        child, new_states, live_c, h1, h2, acc, overflow = _expand_level(
            member, states, alive, tables, Cmax, pm)
        child_s, states_s, uniq, n_uniq = _dedup_sort(
            child, new_states, live_c, h1, h2)
        n_keep = torch.clamp(n_uniq, max=B)
        sel = nonzero_static(uniq, B, 0)
        member = child_s[sel]
        states = states_s[sel]
        alive = torch.arange(B, device=dev) < n_keep
        acc_h, inc_h, n_keep_h = _device.host(
            torch.stack([acc, overflow | (n_uniq > B), n_keep]))
        _device.count("bfs_levels")
        it += 1
        explored += n_keep_h
        accepted = accepted or bool(acc_h)
        incomplete = incomplete or bool(inc_h)
        if accepted or n_keep_h == 0:
            break
    return member, states, alive, accepted, incomplete, explored, it


def check_wgl_device(
    packed: PackedOps,
    pm: PackedModel,
    *,
    beam: int = 1024,
    max_beam: int = 4096,
    block: int = 256,
    time_limit_s: Optional[float] = None,
    witness: bool = True,
    width_hint: int = 0,
    device: Union[str, torch.device, None] = "cuda",
) -> WGLResult:
    """Decides linearizability of one packed history on `device` (the
    card by default; raises when CUDA is asked for but missing).

    First the witness search (valid verdicts) with the narrow info
    window, then — only when that plan dropped info columns — the wide
    one; each rung gets the budget that remains.  If no witness is
    found, the frontier BFS settles the verdict: exact until
    `max_beam`/`MAX_WINDOW` overflow, after which invalid degrades to
    "unknown"."""
    dev = _device.resolve(device)
    t0 = time.monotonic()
    N = packed.n
    if N == 0 or packed.n_ok == 0:
        return WGLResult(valid=True, configs_explored=1,
                         elapsed_s=time.monotonic() - t0)

    def remaining() -> Optional[float]:
        if time_limit_s is None:
            return None
        return time_limit_s - (time.monotonic() - t0)

    def timed_out() -> bool:
        r = remaining()
        return r is not None and r <= 0

    if witness:
        from .wgl_witness import (NARROW_INFO_WINDOW, WIDE_INFO_WINDOW,
                                  check_wgl_witness, plan_drops)

        wres = check_wgl_witness(
            packed, pm, info_window=NARROW_INFO_WINDOW,
            time_limit_s=remaining(), width_hint=width_hint, device=dev)
        if wres is None and not timed_out() and plan_drops(
                packed, info_window=NARROW_INFO_WINDOW):
            wres = check_wgl_witness(
                packed, pm, info_window=WIDE_INFO_WINDOW,
                time_limit_s=remaining(), width_hint=width_hint, device=dev)
        if wres is not None:
            return wres
        if timed_out():
            return WGLResult(valid="unknown", configs_explored=0,
                             reason="time-limit",
                             elapsed_s=time.monotonic() - t0)

    SW = pm.state_width
    n0 = 0
    B = _bucket(beam, lo=256)
    prev_active: Optional[np.ndarray] = None
    member = states = alive = None
    explored_total = 0
    soft_incomplete = False  # gave up on exactness somewhere

    while n0 < N:
        win = _window_tables(packed, n0, block, MAX_WINDOW)
        if win is None:
            return WGLResult(valid="unknown", configs_explored=explored_total,
                             reason="window-overflow",
                             elapsed_s=time.monotonic() - t0)
        active, W, tab_np = win
        tables = {k: torch.from_numpy(v).to(dev) for k, v in tab_np.items()
                  if isinstance(v, np.ndarray)}
        tables["fmin1"] = tab_np["fmin1"]
        tables["f_has_ok"] = tab_np["f_has_ok"]
        tables["hash"] = [torch.from_numpy(v).to(dev)
                          for v in _hash_vectors(W, SW)]

        if prev_active is None:
            member = torch.zeros((B, W), dtype=torch.bool, device=dev)
            states = torch.tensor(pm.init_state, dtype=torch.int32,
                                  device=dev).repeat(B, 1)
            alive = torch.zeros(B, dtype=torch.bool, device=dev)
            alive[0] = True
        else:
            # Re-gather the frontier's member bits onto the new window.
            perm, present = window_regather(prev_active, active)
            perm_d = torch.from_numpy(perm).to(dev)
            present_d = torch.from_numpy(present).to(dev)
            new_member = torch.zeros((member.shape[0], W), dtype=torch.bool,
                                     device=dev)
            new_member[:, : len(active)] = member[:, perm_d] & present_d[None, :]
            member = new_member

        iters = min(block, N - n0)
        snap = (member, states, alive)  # block start, for beam retries
        while True:
            (member, states, alive, accepted, incomplete, explored,
             it_done) = _run_block(member, states, alive, iters, tables, B,
                                   CAND_FACTOR * B, pm)
            if accepted:
                return WGLResult(valid=True,
                                 configs_explored=explored_total + explored,
                                 elapsed_s=time.monotonic() - t0)
            if timed_out():
                return WGLResult(valid="unknown",
                                 configs_explored=explored_total + explored,
                                 reason="time-limit",
                                 elapsed_s=time.monotonic() - t0)
            if incomplete and B < max_beam:
                # Retry this block with a doubled beam, exactly: the
                # snapshot's rows plus as many dead ones.
                B *= 2
                member, states, alive = (torch.cat([t, torch.zeros_like(t)])
                                         for t in snap)
                snap = (member, states, alive)
                continue
            if incomplete:
                soft_incomplete = True
            explored_total += explored
            break

        if not _device.host(alive.any()):
            return WGLResult(
                valid="unknown" if soft_incomplete else False,
                configs_explored=explored_total,
                reason="beam-overflow" if soft_incomplete else None,
                elapsed_s=time.monotonic() - t0,
            )
        n0 += it_done
        prev_active = active

    # Ran every level with live configs and never accepted: unreachable
    # for an exact search (a full linearization covers all oks).
    return WGLResult(
        valid="unknown" if soft_incomplete else False,
        configs_explored=explored_total,
        reason="exhausted",
        elapsed_s=time.monotonic() - t0,
    )
