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
  by a hash lexsort plus exact adjacent compare — equal configs always
  hash equal, so dedup is exact.
* By default (`JEPSEN_WGL_PACKED`, as in the reference) the member
  sets ride as 32-bit lane words (ops/packing.py): children are built
  by word-OR plus one hot bit, acceptance is a packed cover test and
  the dedup hashes are the reference's wrapping uint32 multiply-adds,
  bit for bit, so the sort keeps the same children.  With
  `JEPSEN_WGL_PACKED=0` the sets are bool rows hashed in float32.
* Beam or candidate overflow retries the block with a doubled beam
  from its start; past `max_beam` an invalid verdict degrades to
  "unknown" (valid stays sound).

The JAX package runs each block as one jitted while-loop; here the
level loop runs on the host with one device read per level
(`device.counters["host_syncs"]`).

With a `mesh` (parallel/mesh.py) the BFS frontier of this one search
is split over the mesh's devices (`_run_block_sharded`, the reference's
`_make_block_fn_sharded`): each device expands its B/n rows into its
Cmax/n candidate slots, the candidates are gathered on the first
entry's device for the stable hash sort and the exact dedup, and the
new frontier is split again.  The verdicts are the single-device
search's; candidate overflow is counted per shard, so a lopsided level
can take the (sound) wider-beam retry where the single search would
not.  The witness tier stays on `device`.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional, Union

import numpy as np
import torch

from .. import device as _device
from .. import telemetry
from ..checker.wgl_cpu import WGLResult
from ..history.packed import ST_OK, PackedOps
from ..models.base import PackedModel
from ..telemetry import profile, roofline
from . import degrade, packing

#: int32 "never" sentinel (ret of indeterminate ops, padding).  A
#: Python int so torch ops against int32 tensors stay int32.
INF = 2**31 - 1

#: Candidate (config, op) slots per beam row in each BFS level.
CAND_FACTOR = 4

#: Widest active window the BFS takes on; wider returns "unknown".
MAX_WINDOW = 16384

#: JEPSEN_WGL_PACKED=0 turns the 32-bit packed member lanes off: the
#: wide bool (B, W) tensors everywhere (the reference's switch).
PACKED_ENV = "JEPSEN_WGL_PACKED"


def packed_enabled(packed_lanes: Optional[bool] = None) -> bool:
    """The packed-lane switch: an explicit argument wins, then the
    JEPSEN_WGL_PACKED environment variable (default on)."""
    if packed_lanes is not None:
        return bool(packed_lanes)
    return os.environ.get(PACKED_ENV, "1") not in ("0", "false", "off")


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


def _candidates(member, states, alive, tables, n_slots, pm: PackedModel):
    """The candidate rule, fixed-size compaction and model step of one
    level, shared by the wide and packed expansions.  member (B, W)
    bool, states (B, SW) i32, alive (B,) bool.

    Returns (parent, a, new_states, live_c, overflow), the last a 0-d
    device tensor."""
    ret_w, inv_w, f_w, a0_w, a1_w = (
        tables[k] for k in ("ret_w", "inv_w", "f_w", "a0_w", "a1_w"))
    fmin1 = tables["fmin1"]
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
    return parent, a, new_states, valid_c & legal, overflow


def _expand_level(member, states, alive, tables, n_slots, pm: PackedModel):
    """One frontier level's expansion over wide bool member rows:
    candidates, child bitsets, acceptance and float32 dedup hashes.

    Returns (child, new_states, live_c, h1, h2, accepted_any,
    overflow), the last two as 0-d device tensors."""
    ok_w = tables["ok_w"]
    h1v, h2v, sh1v, sh2v = tables["hash"]
    parent, a, new_states, live_c, overflow = _candidates(
        member, states, alive, tables, n_slots, pm)
    dev = member.device

    child = member[parent]
    child[torch.arange(n_slots, device=dev), a] = True

    # --- acceptance: some live child covers every :ok op -------------
    cover = (child | ~ok_w[None, :]).all(dim=1)
    accepted_any = (live_c & cover).any() & (not tables["f_has_ok"])

    # --- dedup hashes (full float32: equal configs hash equal) --------
    cf = child.to(torch.float32)
    sf = new_states.to(torch.float32)
    big = torch.tensor(3.0e38, dtype=torch.float32, device=dev)
    with _device.exact_float32():
        h1 = torch.where(live_c, cf @ h1v + sf @ sh1v, big)
        h2 = torch.where(live_c, cf @ h2v + sf @ sh2v, big)
    return child, new_states, live_c, h1, h2, accepted_any, overflow


def _expand_level_packed(member_w, states, alive, tables, n_slots,
                         pm: PackedModel):
    """The packed twin of `_expand_level`: member_w (B, ceil(W/32))
    int32 words.  The candidate rule needs per-slot bools, so the
    member bits are unpacked once per level; children are built by
    word-OR plus one hot bit, acceptance is the packed cover test, and
    the dedup hashes are the reference's wrapping uint32 multiply-adds
    over the words and the states (int64 values in [0, 2^32); a dead
    candidate hashes 0xFFFFFFFF)."""
    W = tables["ret_w"].shape[0]
    hw1, hw2, shw1, shw2 = tables["hash"]
    member = packing.unpack_bits(member_w, W)
    parent, a, new_states, live_c, overflow = _candidates(
        member, states, alive, tables, n_slots, pm)

    child_w = packing.set_bit(member_w[parent], a)
    cover = packing.covers(child_w, tables["ok_w"])
    accepted_any = (live_c & cover).any() & (not tables["f_has_ok"])

    dead = packing.FULL_WORD.item()
    h1 = torch.where(live_c, (packing.hash_words(child_w, hw1)
                              + packing.hash_words(new_states, shw1))
                     & dead, dead)
    h2 = torch.where(live_c, (packing.hash_words(child_w, hw2)
                              + packing.hash_words(new_states, shw2))
                     & dead, dead)
    return child_w, new_states, live_c, h1, h2, accepted_any, overflow


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


def _note_level(W: int, SW: int, B: int, Cmax: int,
                rows: Optional[tuple] = None) -> None:
    """The accounting of one BFS level after its host read: with `rows`
    (alive rows, live candidates, kept rows; read for packed levels
    with telemetry on) the bytes and operations this data needs, then
    the level count and the level's cost record."""
    if rows is not None:
        cost = roofline.packed_level_cost(W, SW, *rows)
        telemetry.count("wgl.bfs.packed_bytes", cost["bytes_accessed"])
        telemetry.count("wgl.bfs.packed_ops", cost["flops"])
    _device.count("bfs_levels")
    if profile.cost_hooked():
        profile.note_cost(roofline.bfs_level_cost(W, B, SW, Cmax))


def _run_block(member, states, alive, iters: int, tables, B: int,
               Cmax: int, pm: PackedModel, packed_on: bool = False):
    """Up to `iters` BFS levels from one frontier: the reference's
    jitted `block` while-loop, driven from the host with one device
    read per level.  An overflow does not stop the block: a truncated
    frontier that reaches acceptance still proves the history valid.
    With `packed_on`, member is (B, ceil(W/32)) int32 words.

    Returns (member, states, alive, accepted, incomplete, explored,
    levels)."""
    accepted = incomplete = False
    explored = it = 0
    dev = member.device
    expand = _expand_level_packed if packed_on else _expand_level
    W = tables["ret_w"].shape[0]
    # With telemetry on, the packed levels also count what this data
    # needs (roofline.packed_level_cost): two more sums in the level's
    # one host read.
    count_rows = packed_on and telemetry.enabled()
    while it < iters:
        child, new_states, live_c, h1, h2, acc, overflow = expand(
            member, states, alive, tables, Cmax, pm)
        child_s, states_s, uniq, n_uniq = _dedup_sort(
            child, new_states, live_c, h1, h2)
        n_keep = torch.clamp(n_uniq, max=B)
        flags = [acc, overflow | (n_uniq > B), n_keep]
        if count_rows:
            flags += [alive.sum(), live_c.sum()]
        sel = nonzero_static(uniq, B, 0)
        member = child_s[sel]
        states = states_s[sel]
        alive = torch.arange(B, device=dev) < n_keep
        read = _device.host(torch.stack(flags))
        acc_h, inc_h, n_keep_h = read[:3]
        _note_level(W, states.shape[1], B, Cmax,
                    (read[3], read[4], n_keep_h) if count_rows else None)
        it += 1
        explored += n_keep_h
        accepted = accepted or bool(acc_h)
        incomplete = incomplete or bool(inc_h)
        if accepted or n_keep_h == 0:
            break
    return member, states, alive, accepted, incomplete, explored, it


def _run_block_sharded(member, states, alive, iters: int, tables: dict,
                       B: int, Cmax: int, pm: PackedModel,
                       packed_on: bool, shards: list):
    """`_run_block` with the frontier split over `shards` (one device
    per mesh entry; `tables` maps each device to its copy of the
    block's tables).  The frontier arrives and leaves whole on the
    first shard's device; inside the block shard d holds rows
    [d*B/n, (d+1)*B/n).  Per level each shard expands its rows into
    Cmax/n slots, the candidates are gathered in shard order for the
    dedup sort (the reference's all_gather), and the kept rows are
    split again, as the reference's per-device slice of the new
    frontier."""
    n = len(shards)
    if B % n or Cmax % n:
        raise ValueError(f"mesh size {n} must evenly divide the beam {B} "
                         f"and its candidate budget {Cmax}")
    B_l, C_l = B // n, Cmax // n
    home = shards[0]
    expand = _expand_level_packed if packed_on else _expand_level
    W = tables[home]["ret_w"].shape[0]

    def split(x):
        return [x[d * B_l:(d + 1) * B_l].to(dev)
                for d, dev in enumerate(shards)]

    def gather(xs):
        return torch.cat([x.to(home) for x in xs])

    mem, st, al = split(member), split(states), split(alive)
    accepted = incomplete = False
    explored = it = 0
    count_rows = packed_on and telemetry.enabled()
    while it < iters:
        outs = [expand(mem[d], st[d], al[d], tables[dev], C_l, pm)
                for d, dev in enumerate(shards)]
        child, new_states, live_c, h1, h2 = (
            gather([o[j] for o in outs]) for j in range(5))
        child_s, states_s, uniq, n_uniq = _dedup_sort(
            child, new_states, live_c, h1, h2)
        n_keep = torch.clamp(n_uniq, max=B)
        # Each shard's acceptance and overflow go to the host as they
        # are, in the level's one read: [acc x n, overflow x n, beam
        # overflow, kept rows, (alive rows x n, live candidates)].
        flags = ([o[5].to(home) for o in outs]
                 + [o[6].to(home) for o in outs] + [n_uniq > B, n_keep])
        if count_rows:
            flags += [a.sum().to(home) for a in al] + [live_c.sum()]
        sel = nonzero_static(uniq, B, 0)
        mem, st = split(child_s[sel]), split(states_s[sel])
        al = split(torch.arange(B, device=home) < n_keep)
        read = _device.host(torch.stack(flags))
        acc_h, inc_h = any(read[:n]), any(read[n:2 * n + 1])
        n_keep_h = read[2 * n + 1]
        _note_level(W, states.shape[1], B, Cmax,
                    (sum(read[2 * n + 2:-1]), read[-1], n_keep_h)
                    if count_rows else None)
        it += 1
        explored += n_keep_h
        accepted = accepted or bool(acc_h)
        incomplete = incomplete or bool(inc_h)
        if accepted or n_keep_h == 0:
            break
    return (gather(mem), gather(st), gather(al), accepted, incomplete,
            explored, it)


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
    mesh: Any = None,
    checkpoint_dir: Optional[str] = None,
    packed_lanes: Optional[bool] = None,
    device: Union[str, torch.device, None] = "cuda",
) -> WGLResult:
    """Decides linearizability of one packed history on `device` (the
    card by default; raises when CUDA is asked for but missing).

    First the witness search (valid verdicts) with the narrow info
    window, then — only when that plan dropped info columns — the wide
    one; each rung gets the budget that remains, and both save their
    carry to `checkpoint_dir` and resume from it (see
    `check_wgl_witness`).  If no witness is found, the frontier BFS
    settles the verdict: exact until `max_beam`/`MAX_WINDOW` overflow,
    after which invalid degrades to "unknown".  `packed_lanes` (None:
    `JEPSEN_WGL_PACKED`, default on) carries the BFS's member sets as
    32-bit lane words.

    A device resource error in a BFS block (an out-of-memory error, or
    the `JEPSEN_WGL_FAULT` hook's "device" tier) first sheds the packed
    lanes and retries the block wide at the same beam; then it retries
    the block once at half the beam on the same device, when the
    frontier fits in half; the search then stays at most that wide.
    Otherwise it returns "unknown" with reason
    "device-resource-error".

    `mesh` (parallel/mesh.py) splits the BFS frontier over its devices
    (see the module docstring); its size must evenly divide the beam
    bucket and the candidate budget, checked before any work, and it
    must hold this process's devices alone."""
    dev = _device.resolve(device)
    t0 = time.monotonic()
    shards = None
    if mesh is not None:
        n_dev = int(mesh.devices.size)
        b0 = _bucket(beam)
        if n_dev < 1 or b0 % n_dev or (CAND_FACTOR * b0) % n_dev:
            raise ValueError(
                f"mesh size {n_dev} must evenly divide the beam "
                f"bucket {b0} and its candidate budget")
        shards = mesh.shard_devices()
        if any(d is None for d in shards):
            raise ValueError("frontier sharding needs a mesh of this "
                             "process's own devices")
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

        with profile.capture("witness", device=dev, ops=int(N),
                             ok=int(packed.n_ok)) as _pw:
            _pw.knob(info_window=NARROW_INFO_WINDOW, width_hint=width_hint)
            with telemetry.span("wgl.witness"):
                wres = check_wgl_witness(
                    packed, pm, info_window=NARROW_INFO_WINDOW,
                    time_limit_s=remaining(), width_hint=width_hint,
                    checkpoint_dir=checkpoint_dir, device=dev)
                if wres is None and not timed_out() and plan_drops(
                        packed, info_window=NARROW_INFO_WINDOW):
                    _pw.knob(info_window=WIDE_INFO_WINDOW)
                    wres = check_wgl_witness(
                        packed, pm, info_window=WIDE_INFO_WINDOW,
                        time_limit_s=remaining(), width_hint=width_hint,
                        checkpoint_dir=checkpoint_dir, device=dev)
            _pw.outcome = "hit" if wres is not None else "miss"
        if wres is not None:
            telemetry.count("wgl.witness.hit")
            return wres
        telemetry.count("wgl.witness.miss")
        if timed_out():
            return WGLResult(valid="unknown", configs_explored=0,
                             reason="time-limit",
                             elapsed_s=time.monotonic() - t0)

    # The BFS pass record: the reference's shape features and knobs.
    packed_on = packed_enabled(packed_lanes)
    with profile.capture("bfs", device=dev, ops=int(N),
                         ok=int(packed.n_ok)) as _pb:
        _pb.knob(beam=int(_bucket(beam, lo=256)), block=int(block),
                 max_beam=int(max_beam), max_window=int(MAX_WINDOW),
                 mesh=mesh is not None, packed=packed_on)
        res = _bfs(packed, pm, beam, max_beam, block, t0, timed_out, dev,
                   packed_on, shards)
        _pb.outcome = (f"unknown:{res.reason}" if res.valid == "unknown"
                       else res.valid)
        _pb.feature(explored=int(res.configs_explored))
    return res


def _device_gave_out(error, explored: int, t0: float) -> WGLResult:
    """The BFS's last rung on device resource errors: "unknown" with
    reason "device-resource-error", which `Linearizable` retries once at
    half size and then raises on — never a CPU verdict."""
    degrade.record("device", "fall-through", error)
    return WGLResult(valid="unknown", configs_explored=explored,
                     reason="device-resource-error",
                     elapsed_s=time.monotonic() - t0)


def _block_tables(tab_np: dict, W: int, SW: int, packed_on: bool,
                  dev: torch.device) -> dict:
    """One block's device tables.  Packed: the ok-mask as words and the
    hash multipliers as int64 (word streams 0, 1; state streams 2, 3);
    wide: the ok-mask as bools and the float32 hash vectors."""
    tables = {k: torch.from_numpy(v).to(dev) for k, v in tab_np.items()
              if isinstance(v, np.ndarray)}
    tables["fmin1"] = tab_np["fmin1"]
    tables["f_has_ok"] = tab_np["f_has_ok"]
    if packed_on:
        Wp = packing.n_words(W)
        tables["ok_w"] = packing.pack_bits(tables["ok_w"], Wp)
        tables["hash"] = [
            torch.from_numpy(packing.hash_consts(n, stream).astype(
                np.int64)).to(dev)
            for n, stream in ((Wp, 0), (Wp, 1), (SW, 2), (SW, 3))]
    else:
        tables["hash"] = [torch.from_numpy(v).to(dev)
                          for v in _hash_vectors(W, SW)]
    return tables


def _bfs_tables(tab_np: dict, W: int, SW: int, packed_on: bool,
                dev: torch.device, shards: Optional[list]):
    """The block's tables on `dev`, or with `shards` a dict of them on
    each distinct device (read-only, so entries that name one device
    share them)."""
    if shards is None:
        return _block_tables(tab_np, W, SW, packed_on, dev)
    return {d: _block_tables(tab_np, W, SW, packed_on, d)
            for d in dict.fromkeys(shards)}


def _bfs(packed: PackedOps, pm: PackedModel, beam: int, max_beam: int,
         block: int, t0: float, timed_out, dev: torch.device,
         packed_on: bool, shards: Optional[list] = None) -> WGLResult:
    """The frontier BFS of `check_wgl_device`, block by block; with
    `shards`, the frontier split over them (`_run_block_sharded`) and
    kept whole between blocks on the first one."""
    if shards is not None:
        dev = shards[0]
    N = packed.n
    SW = pm.state_width
    n0 = 0
    B = _bucket(beam, lo=256)
    prev_active: Optional[np.ndarray] = None
    # member: (B, W) bool, or (B, ceil(W/32)) int32 words when packed.
    member = states = alive = None
    explored_total = 0
    soft_incomplete = False  # gave up on exactness somewhere
    device_retried = False  # one halved-beam retry on resource errors

    while n0 < N:
        win = _window_tables(packed, n0, block, MAX_WINDOW)
        if win is None:
            return WGLResult(valid="unknown", configs_explored=explored_total,
                             reason="window-overflow",
                             elapsed_s=time.monotonic() - t0)
        active, W, tab_np = win
        tables = _bfs_tables(tab_np, W, SW, packed_on, dev, shards)

        if prev_active is None:
            shape = (B, packing.n_words(W)) if packed_on else (B, W)
            member = torch.zeros(shape, dtype=torch.int32 if packed_on
                                 else torch.bool, device=dev)
            states = torch.tensor(pm.init_state, dtype=torch.int32,
                                  device=dev).repeat(B, 1)
            alive = torch.zeros(B, dtype=torch.bool, device=dev)
            alive[0] = True
        else:
            # Re-gather the frontier's member bits onto the new window.
            perm, present = window_regather(prev_active, active)
            perm_d = torch.from_numpy(perm).to(dev)
            present_d = torch.from_numpy(present).to(dev)
            old = (packing.unpack_bits(member, member.shape[1]
                                       * packing.LANES)
                   if packed_on else member)
            new_member = torch.zeros((old.shape[0], W), dtype=torch.bool,
                                     device=dev)
            new_member[:, : len(active)] = old[:, perm_d] & present_d[None, :]
            member = (packing.pack_bits(new_member) if packed_on
                      else new_member)

        iters = min(block, N - n0)
        snap = (member, states, alive)  # block start, for beam retries
        if telemetry.enabled():
            telemetry.gauge("wgl.bfs.beam", B)
            telemetry.gauge("wgl.bfs.window", W)
            if packed_on:
                telemetry.count("wgl.packed.blocks")
                telemetry.gauge("wgl.packed.words", packing.n_words(W))
        while True:
            try:
                degrade.maybe_fault("device")
                with telemetry.span("wgl.bfs.block"):
                    args = (member, states, alive, iters, tables, B,
                            CAND_FACTOR * B, pm, packed_on)
                    (member, states, alive, accepted, incomplete, explored,
                     it_done) = (_run_block(*args) if shards is None else
                                 _run_block_sharded(*args, shards))
            except Exception as e:  # noqa: BLE001 — only resource errors
                if not degrade.is_resource_error(e):
                    raise
                if packed_on:
                    # First rung: shed the packed lanes and retry the
                    # block wide at the same beam — packing is an
                    # optimisation, not a budget, so it goes before any
                    # beam width.
                    packed_on = False
                    degrade.record("device", "packed-fallback", e)
                    telemetry.count("wgl.packed.fallbacks")
                    tables = _bfs_tables(tab_np, W, SW, False, dev, shards)
                    snap = (packing.unpack_bits(snap[0], W),) + snap[1:]
                    member, states, alive = snap
                    continue
                # The device, not the search, gave out: retry the block
                # once at half the beam from its snapshot, when the
                # frontier fits in half (rows are packed alive-first).
                # Else leave "unknown" for the caller's halved retry:
                # cutting live rows would turn a refutation into a beam
                # overflow, which the CPU would settle.
                if (device_retried or B <= 64
                        or _device.host(snap[2][B // 2:].any())):
                    return _device_gave_out(e, explored_total, t0)
                device_retried = True
                degrade.record("device", "retry-halved", e)
                B //= 2
                member, states, alive = (t[:B] for t in snap)
                snap = (member, states, alive)
                continue
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
                if device_retried:
                    # Doubling back would undo the halving the device
                    # forced; the caller's halved retry decides.
                    return _device_gave_out(
                        "beam overflow after the halved retry",
                        explored_total, t0)
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
