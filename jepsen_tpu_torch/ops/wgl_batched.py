"""Batched per-key Wing–Gong–Lowe search: every key's frontier BFS at
once, on one device or with the keys split over a mesh.

The port of `jepsen_tpu/ops/wgl_batched.py`.  By default (`JEPSEN_WGL_PACKED`) the member
bitsets ride as 32-bit lane words between levels, with the reference's
word-OR children, packed cover test and uint32 dedup hashes
(ops/packing.py, ops/wgl.py); `JEPSEN_WGL_PACKED=0` gives bool rows.
K per-key histories are padded to one (K, N) table and each BFS level
advances every key's frontier as one (keys x B) batch.  The JAX package
runs one key's search (`_make_key_fn`) as a `while_loop` under `vmap`;
here one host loop runs the levels, with one device read per level
(`device.counters["bfs_levels"]` and `"host_syncs"`).  A key whose
search is over (accepted, dead, or past its op count) keeps its carry
from then on, as `vmap` of a `while_loop` does.

With a `mesh` (parallel/mesh.py) each retry round's keys are padded
to a multiple of the mesh size with keys of no ops and split into
contiguous shards, one per entry; each shard's level loop runs on its
entry's device, one host read a level for all of them, and the
verdicts come back in key order (across ranks through
`mesh.gather_shards`).  No shard waits on another: per-key searches
share nothing.

Per-key histories are short, so the whole history fits the member
bitset and no windowing is needed.  This is plain PyTorch: the JAX
package's version is an XLA program, not a Pallas kernel.

Soundness, as in ops/wgl.py: an accepted key is proven (a witness
linearization exists); a key is reported invalid only when its search
was exact (no beam or candidate overflow); an overflow retries wider,
and past `max_beam` reports "unknown" for the exact CPU settle.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Optional, Union

import numpy as np
import torch

from .. import device as _device
from .. import telemetry
from ..history.packed import ST_OK, PackedOps
from ..models.base import PackedModel
from ..parallel.mesh import gather_shards
from ..telemetry import profile, roofline
from . import degrade, packing
from .wgl import packed_enabled

#: int32 "never" sentinel (padding ops, info returns), a Python int so
#: torch ops against int32 tensors stay int32.
INF = 2**31 - 1

#: Candidate (config, op) slots per level, per beam lane.
CAND_FACTOR = 4


def _hash_vectors(n: int, sw: int, seed: int = 0x5EED) -> tuple[np.ndarray, ...]:
    rng = np.random.default_rng(seed)
    return (
        rng.uniform(1.0, 2.0, size=(n,)).astype(np.float32),
        rng.uniform(1.0, 2.0, size=(n,)).astype(np.float32),
        rng.uniform(1.0, 2.0, size=(sw,)).astype(np.float32),
        rng.uniform(1.0, 2.0, size=(sw,)).astype(np.float32),
    )


def _bucket(x: int, lo: int = 32) -> int:
    w = lo
    while w < x:
        w *= 2
    return w


@dataclass
class BatchedPack:
    """K per-key histories padded to a common (K, N) table."""

    ret: np.ndarray  # (K, N) int32, INF for info/padding
    inv: np.ndarray  # (K, N) int32, INF for padding
    f: np.ndarray    # (K, N) int32
    a0: np.ndarray   # (K, N) int32
    a1: np.ndarray   # (K, N) int32
    okv: np.ndarray  # (K, N) bool
    n_ops: np.ndarray  # (K,) int32 live op count per key

    @property
    def K(self) -> int:
        return int(self.ret.shape[0])

    @property
    def N(self) -> int:
        return int(self.ret.shape[1])


def pack_batch(packs: list[PackedOps],
               pad_keys_to: Optional[int] = None) -> BatchedPack:
    """Stacks per-key PackedOps into padded (K, N) arrays.  Padding ops
    have inv = ret = INF, so they are never order-legal candidates and
    never block anyone; padding keys (up to `pad_keys_to`, to fill a
    mesh) have n_ops = 0 and accept at once."""
    K = len(packs)
    Kp = pad_keys_to if pad_keys_to and pad_keys_to > K else K
    N = _bucket(max((p.n for p in packs), default=1))
    ret = np.full((Kp, N), INF, dtype=np.int32)
    inv = np.full((Kp, N), INF, dtype=np.int32)
    f = np.zeros((Kp, N), dtype=np.int32)
    a0 = np.zeros((Kp, N), dtype=np.int32)
    a1 = np.zeros((Kp, N), dtype=np.int32)
    okv = np.zeros((Kp, N), dtype=bool)
    n_ops = np.zeros(Kp, dtype=np.int32)
    for k, p in enumerate(packs):
        n = p.n
        n_ops[k] = n
        if n == 0:
            continue
        inv[k, :n] = p.inv.astype(np.int64).clip(max=INF - 1)
        ret[k, :n] = p.ret.clip(max=INF).astype(np.int64)
        f[k, :n] = p.f
        a0[k, :n] = p.a0
        a1[k, :n] = p.a1
        okv[k, :n] = p.status == ST_OK
    return BatchedPack(ret=ret, inv=inv, f=f, a0=a0, a1=a1, okv=okv,
                       n_ops=n_ops)


def nonzero_rows(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Per row of a (R, L) mask, the column indices of its True entries,
    ascending, padded with 0 (or cut) to `size`: `jnp.nonzero(row,
    size=size, fill_value=0)` for every row at once, with no wait for
    the device."""
    R, L = mask.shape
    pos = torch.cumsum(mask.to(torch.int64), 1) - 1
    dest = torch.where(mask & (pos < size), pos, size)
    out = torch.zeros((R, size + 1), dtype=torch.int64, device=mask.device)
    out.scatter_(1, dest, torch.arange(L, device=mask.device).expand(R, L))
    return out[:, :size]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (R, M, ...) gathered along dim 1 by idx (R, C) -> (R, C, ...)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]


class _Tables:
    """One batch's device tables (the rows of the keys in it)."""

    def __init__(self, bp: BatchedPack, sel: np.ndarray, pm: PackedModel,
                 dev: torch.device, packed_on: bool):
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a[sel])).to(dev)

        self.ret, self.inv, self.f, self.a0, self.a1, self.okv = (
            put(a) for a in (bp.ret, bp.inv, bp.f, bp.a0, bp.a1, bp.okv))
        self.n_ops = put(bp.n_ops)
        self.init = torch.tensor(pm.init_state, dtype=torch.int32,
                                 device=dev)
        self.packed = packed_on
        if packed_on:
            # The ok-mask as words; the hash multipliers as int64 (word
            # streams 0, 1; state streams 2, 3).
            Np = packing.n_words(bp.N)
            self.ok_w = packing.pack_bits(self.okv, Np)
            self.hash = tuple(
                torch.from_numpy(packing.hash_consts(n, stream).astype(
                    np.int64)).to(dev)
                for n, stream in ((Np, 0), (Np, 1), (pm.state_width, 2),
                                  (pm.state_width, 3)))
        else:
            self.hash = tuple(torch.from_numpy(v).to(dev)
                              for v in _hash_vectors(bp.N, pm.state_width))


def _level(carry, t: _Tables, B: int, Cmax: int, pm: PackedModel):
    """One BFS level of every key (the reference's `level_step` under
    `vmap`).  member (Kt, B, N) bool — (Kt, B, ceil(N/32)) int32 words
    when `t.packed` —, states (Kt, B, SW) i32, alive (Kt, B) bool;
    accepted, incomplete (Kt,) bool; explored, it (Kt,) i32."""
    member, states, alive, accepted, incomplete, explored, it = carry
    Kt, N = t.ret.shape
    member_w = member
    if t.packed:
        member = packing.unpack_bits(member_w, N)
    SW = states.shape[2]
    dev = member.device
    lanes = torch.arange(B, device=dev)

    # Candidate rule: a non-member a may be linearized next iff inv(a) <
    # min ret over the *other* non-members (two masked min-reductions).
    nm_ret = torch.where(member | ~alive[:, :, None], INF, t.ret[:, None, :])
    m1, am1 = nm_ret.min(dim=2)  # the first index of the minimum
    nm_ret2 = nm_ret.clone()
    nm_ret2[torch.arange(Kt, device=dev)[:, None], lanes[None, :], am1] = INF
    m2 = nm_ret2.min(dim=2).values
    bound = torch.where(torch.arange(N, device=dev) == am1[:, :, None],
                        m2[:, :, None], m1[:, :, None])
    order_ok = ~member & alive[:, :, None] & (t.inv[:, None, :] < bound)

    # Compact candidate (config, op) pairs.
    flat = order_ok.reshape(Kt, B * N)
    count = flat.sum(dim=1)
    cand_idx = nonzero_rows(flat, Cmax)
    valid_c = torch.arange(Cmax, device=dev)[None, :] < count[:, None]
    incomplete = incomplete | (count > Cmax)
    parent = cand_idx // N
    a = cand_idx % N

    # Model transition over the candidates.
    new_states, legal = pm.torch_step(
        _take(states, parent).reshape(Kt * Cmax, SW),
        _take(t.f, a).reshape(-1), _take(t.a0, a).reshape(-1),
        _take(t.a1, a).reshape(-1))
    new_states = new_states.reshape(Kt, Cmax, SW)
    live_c = valid_c & legal.reshape(Kt, Cmax)
    h1v, h2v, sh1v, sh2v = t.hash
    if t.packed:
        # Word-OR children, the packed cover test and the wrapping
        # uint32 hashes (int64 values; a dead candidate 0xFFFFFFFF).
        child = packing.set_bit(_take(member_w, parent), a)
        cover = packing.covers(child, t.ok_w[:, None, :])
        accepted = accepted | (live_c & cover).any(dim=1)
        dead = packing.FULL_WORD.item()
        h1 = torch.where(live_c, (packing.hash_words(child, h1v)
                                  + packing.hash_words(new_states, sh1v))
                         & dead, dead)
        h2 = torch.where(live_c, (packing.hash_words(child, h2v)
                                  + packing.hash_words(new_states, sh2v))
                         & dead, dead)
    else:
        child = _take(member, parent)
        child.scatter_(2, a[:, :, None], True)

        # Accept when some live child covers every :ok op.
        cover = (child | ~t.okv[:, None, :]).all(dim=2)
        accepted = accepted | (live_c & cover).any(dim=1)

        # Float32 dedup hashes.
        cf = child.to(torch.float32)
        sf = new_states.to(torch.float32)
        big = torch.tensor(3.0e38, dtype=torch.float32, device=dev)
        with _device.exact_float32():
            h1 = torch.where(live_c, cf @ h1v + sf @ sh1v, big)
            h2 = torch.where(live_c, cf @ h2v + sf @ sh2v, big)
    # Dedup: hash sort (stable on (h1, h2), as lax.sort with num_keys=2)
    # and exact adjacent compare.
    p2 = torch.sort(h2, dim=1, stable=True).indices
    p1 = torch.sort(torch.gather(h1, 1, p2), dim=1, stable=True).indices
    perm = torch.gather(p2, 1, p1)
    h1s, h2s = torch.gather(h1, 1, perm), torch.gather(h2, 1, perm)
    child_s = _take(child, perm)
    states_s = _take(new_states, perm)
    live_s = torch.gather(live_c, 1, perm)
    same = (h1s == h1s.roll(1, dims=1)) & (h2s == h2s.roll(1, dims=1))
    same[:, 0] = False
    same = (same & (child_s == child_s.roll(1, dims=1)).all(dim=2)
            & (states_s == states_s.roll(1, dims=1)).all(dim=2))
    uniq = live_s & ~same
    n_uniq = uniq.sum(dim=1)
    incomplete = incomplete | (n_uniq > B)
    n_keep = torch.clamp(n_uniq, max=B)
    sel = nonzero_rows(uniq, B)
    return (_take(child_s, sel), _take(states_s, sel),
            lanes[None, :] < n_keep[:, None], accepted, incomplete,
            explored + n_keep.to(torch.int32), it + 1)


def _init_carry(t: _Tables, B: int) -> tuple:
    """Every key's search at its start: one live empty configuration."""
    Kt, N = t.ret.shape
    dev = t.ret.device
    member0 = (torch.zeros((Kt, B, packing.n_words(N)), dtype=torch.int32,
                           device=dev) if t.packed
               else torch.zeros((Kt, B, N), dtype=torch.bool, device=dev))
    return (
        member0,
        t.init.expand(Kt, B, -1).clone(),
        (torch.arange(B, device=dev) < 1).expand(Kt, B).clone(),
        ~t.okv.any(dim=1),
        torch.zeros(Kt, dtype=torch.bool, device=dev),
        torch.zeros(Kt, dtype=torch.int32, device=dev),
        torch.zeros(Kt, dtype=torch.int32, device=dev),
    )


def _running(c: tuple, t: _Tables) -> torch.Tensor:
    """(Kt,) bool: the keys whose search goes on."""
    _, _, alive, accepted, _, _, it = c
    return ~accepted & alive.any(dim=1) & (it < t.n_ops)


def _advance(carry: tuple, live: torch.Tensor, t: _Tables, B: int,
             Cmax: int, pm: PackedModel) -> tuple:
    """One level of the keys still running; a finished key keeps its
    carry, as under vmap."""
    Kt, N = t.ret.shape
    nxt = _level(carry, t, B, Cmax, pm)
    _device.count("bfs_levels")
    if profile.cost_hooked():
        profile.note_cost(roofline.batched_level_cost(
            Kt, N, B, carry[1].shape[2], Cmax))
    return tuple(
        torch.where(live.reshape((Kt,) + (1,) * (old.dim() - 1)), new, old)
        for old, new in zip(carry, nxt))


def _outcome(carry: tuple) -> torch.Tensor:
    """(4, Kt) int64: accepted, alive at the end, incomplete, explored."""
    _, _, alive, accepted, incomplete, explored, _ = carry
    return torch.stack(
        [accepted.to(torch.int64), alive.any(dim=1).to(torch.int64),
         incomplete.to(torch.int64), explored.to(torch.int64)])


def _as_numpy(read) -> tuple:
    acc, alive_end, inc, expl = read
    return (np.asarray(acc, dtype=bool), np.asarray(alive_end, dtype=bool),
            np.asarray(inc, dtype=bool), np.asarray(expl, dtype=np.int64))


def _search(t: _Tables, B: int, Cmax: int, pm: PackedModel):
    """Every key's full frontier search (the reference's `key_fn` under
    `vmap`) -> (accepted, alive_end, incomplete, explored) as numpy."""
    carry = _init_carry(t, B)
    live = _running(carry, t)
    while _device.host(live.any()):
        carry = _advance(carry, live, t, B, Cmax, pm)
        live = _running(carry, t)
    return _as_numpy(_device.host(_outcome(carry)))


def _search_shards(ts: list, B: int, Cmax: int, pm: PackedModel) -> list:
    """`_search` of every shard in `ts` (one `_Tables` each, on its own
    device), their levels interleaved: each round advances every shard
    still running and reads all their flags in one host read on the
    first shard's device, so the devices work side by side.  Returns
    one `_search` tuple per shard."""
    home = ts[0].ret.device
    carries = [_init_carry(t, B) for t in ts]
    lives = [_running(c, t) for c, t in zip(carries, ts)]
    while True:
        going = _device.host(torch.stack([lv.any().to(home)
                                          for lv in lives]))
        if not any(going):
            break
        for i, t in enumerate(ts):
            if going[i]:
                carries[i] = _advance(carries[i], lives[i], t, B, Cmax, pm)
                lives[i] = _running(carries[i], t)
    outs = _device.host(torch.cat([_outcome(c).to(home) for c in carries],
                                  dim=1))
    out, at = [], 0
    for t in ts:
        k = t.ret.shape[0]
        out.append(_as_numpy([row[at:at + k] for row in outs]))
        at += k
    return out


def _search_mesh(mesh, shard_devs: list, bp: BatchedPack, todo: list,
                 pad_key: int, pm: PackedModel, B: int,
                 packed_on: bool) -> tuple:
    """One retry round of `todo` split over `mesh`: padded with the
    no-op key `pad_key` to a multiple of the mesh size, one contiguous
    shard per entry, this rank's shards searched side by side
    (`_search_shards`), every shard's results gathered in shard order;
    the padding's are dropped."""
    n_dev = mesh.size
    per = math.ceil(len(todo) / n_dev)
    sel = np.asarray(todo + [pad_key] * (n_dev * per - len(todo)))
    mine = [i for i, d in enumerate(shard_devs) if d is not None]
    ts = [_Tables(bp, sel[i * per:(i + 1) * per], pm, shard_devs[i],
                  packed_on) for i in mine]
    local = dict(zip(mine, _search_shards(ts, B, CAND_FACTOR * B, pm)
                     if ts else []))
    got = gather_shards(mesh, local)
    return tuple(np.concatenate([got[i][j] for i in range(n_dev)])[:len(todo)]
                 for j in range(4))


@dataclass
class BatchedWGLResult:
    #: per-key verdicts: True | False | "unknown" (before the CPU settle)
    valid: list
    explored: np.ndarray
    elapsed_s: float
    beam_used: int


def check_wgl_batched(
    packs: list[PackedOps],
    pm: PackedModel,
    *,
    beam: int = 256,
    max_beam: int = 16384,
    mesh: Any = None,
    time_limit_s: Optional[float] = None,
    packed_lanes: Optional[bool] = None,
    device: Union[str, torch.device, None] = "cuda",
) -> BatchedWGLResult:
    """Runs the WGL search for every key at once on `device` (the card
    by default; raises when CUDA is asked for but missing).  Keys whose
    search overflowed the beam retry together at twice the beam; at
    `max_beam` they report "unknown".  The time limit is checked
    between retry rounds.  `packed_lanes` (None: `JEPSEN_WGL_PACKED`,
    default on) carries the member bitsets as 32-bit lane words.  A
    device resource error (the `JEPSEN_WGL_FAULT` hook's "batched" tier
    included) first sheds the packed lanes at the same beam, then
    retries once at half the beam on the same device, then reports the
    unsettled keys "unknown"; any other error raises.

    With a `mesh` (parallel/mesh.py) the keys split into one contiguous
    shard per entry, each searched on its entry's device (see the
    module docstring); `device` then goes unused."""
    dev = _device.resolve(device)
    t0 = time.monotonic()
    K = len(packs)
    if mesh is None:
        bp = pack_batch(packs)
        shard_devs = None
    else:
        n_dev = mesh.size
        shard_devs = mesh.shard_devices()
        # One spare key of no ops at least: the rounds pad with it.
        bp = pack_batch(packs, pad_keys_to=max(
            n_dev * math.ceil(K / n_dev), K + 1))

    verdict: list[Any] = [None] * K
    explored = np.zeros(K, dtype=np.int64)
    todo = list(range(K))
    B = _bucket(beam, lo=32)
    packed_on = packed_enabled(packed_lanes)
    batch_retried = False
    # One cost record per batched pass: the reference's features and
    # knobs.
    with profile.capture("batched", device=dev, keys=K,
                         ops=int(sum(p.n for p in packs))) as _pb:
        _pb.knob(beam=B, max_beam=int(max_beam), cand_factor=CAND_FACTOR,
                 mesh=mesh is not None, packed=packed_on)
        while todo:
            if packed_on and telemetry.enabled():
                telemetry.count("wgl.packed.batched-rounds")
            try:
                degrade.maybe_fault("batched")
                with telemetry.span("wgl.batched.block", keys=len(todo),
                                    beam=B):
                    if mesh is None:
                        t = _Tables(bp, np.asarray(todo), pm, dev,
                                    packed_on)
                        acc, alive_end, inc, expl = _search(
                            t, B, CAND_FACTOR * B, pm)
                    else:
                        acc, alive_end, inc, expl = _search_mesh(
                            mesh, shard_devs, bp, todo, K, pm, B,
                            packed_on)
            except Exception as e:  # noqa: BLE001 — only resource errors
                if not degrade.is_resource_error(e):
                    raise
                if packed_on:
                    # First rung: shed the packed lanes at the same beam
                    # before any width (see ops/wgl.py).
                    packed_on = False
                    degrade.record("batched", "packed-fallback", e)
                    telemetry.count("wgl.packed.fallbacks")
                    continue
                if batch_retried or B <= 32:
                    degrade.record("batched", "fall-through", e)
                    for k in todo:
                        verdict[k] = "unknown"
                    todo = []
                    continue
                batch_retried = True
                degrade.record("batched", "retry-halved", e)
                B //= 2
                max_beam = min(max_beam, B)
                continue
            retry = []
            for i, k in enumerate(todo):
                explored[k] += int(expl[i])
                if acc[i]:
                    verdict[k] = True
                elif inc[i]:
                    # Inexact (beam or candidate overflow): a wider beam
                    # can settle it.
                    if B < max_beam:
                        retry.append(k)
                    else:
                        verdict[k] = "unknown"
                elif alive_end[i]:
                    # An exact search that ended alive without acceptance
                    # should not happen; a wider beam cannot change an
                    # exact outcome, so leave it to the CPU settle.
                    verdict[k] = "unknown"
                else:
                    verdict[k] = False  # exact search exhausted: invalid
            todo = retry
            if todo:
                if (time_limit_s is not None
                        and time.monotonic() - t0 > time_limit_s):
                    for k in todo:
                        verdict[k] = "unknown"
                    todo = []
                else:
                    B *= 2
        _pb.outcome = {
            "proven": sum(1 for v in verdict if v is True),
            "refuted": sum(1 for v in verdict if v is False),
            "unknown": sum(1 for v in verdict if v == "unknown"),
        }
        _pb.degraded = batch_retried or None
    if telemetry.enabled():
        telemetry.count("wgl.batched.keys", K)
        telemetry.count("wgl.batched.proven",
                        sum(1 for v in verdict if v is True))
        telemetry.count("wgl.batched.refuted",
                        sum(1 for v in verdict if v is False))
        telemetry.count("wgl.batched.unknown",
                        sum(1 for v in verdict if v == "unknown"))
    return BatchedWGLResult(valid=verdict, explored=explored,
                            elapsed_s=time.monotonic() - t0, beam_used=B)
