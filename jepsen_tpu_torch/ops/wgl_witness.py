"""Device witness search for linearizability — the valid-verdict fast
path, in PyTorch with a CUDA barrier sweep.

The port of `jepsen_tpu/ops/wgl_witness.py`.  It is an event-walk form
of Wing–Gong:

* Walk :ok operations ("barriers") in completion order.  By induction
  every :ok op returning before the current barrier is linearized in
  every surviving config, so op `a` may be linearized iff it was invoked
  before the current barrier's return.
* At the barrier for op `a`, each beam lane must contain `a`: it passes
  (a already linearized as an earlier helper), linearizes `a` directly
  (one model step), or linearizes a *chain* of helper ops ending in `a`.
* The easy part — pass or step directly — is the sweep (`sweep`): a
  hand-written CUDA kernel (csrc/witness_sweep.cu) on the card,
  `sweep_plain` on the CPU.  It stops at the first barrier no lane
  survives; there the chain search (`_heavy`) evaluates every (helper,
  lane) pair in one batched step, keeps <= B children deduplicated by
  model state, and the sweep resumes after the barrier.

Execution is a host loop (`run_chunks`): blocks of `bars_per_block`
barriers, taken `blocks_per_call` at a time (a chunk); inside a block,
sweep -> read the death barrier -> chain search -> resume.  Where a
block's (6, K) barrier table and (5, W) window table come from is the
transfer mode (`check_wgl_witness(transfer=...)`, the reference's):
"full" builds them on the host and uploads them a chunk at a time;
"indices" uploads six per-row int32 tables once per check and then,
per chunk, only the blocks' row indices, from which each block gathers
its tables on the card; "device" also plans each block's window on the
card from the host's per-block scalars, so a chunk uploads nothing.
All three feed the same sweep and chain search with equal tables.  The
loop takes and returns the search's carry between blocks
(`WitnessCarry`), so the online frontier
(streaming/frontier.py) continues it as the history grows.  By default
(`JEPSEN_WGL_PACKED`) the carry's (W, B) member window rides between
blocks as (W, ceil(B/32)) 32-bit words (ops/packing.py), re-gathered
as words; each block unpacks it on entry and packs it on exit, so the
sweep and the chain search see the bool window either way.  Each read
of a device value is a host sync (`device.counters["host_syncs"]`).
With telemetry on, each chunk's span (`wgl.witness.chunk`) holds a
`wgl.witness.table` span for its block tables, built and uploaded, and
the host's nanoseconds in the sweeps with their death reads and in the
chain searches, their reads left out, add up in
`device.counters["sweep_ns"]` and `["chain_ns"]`.

A one-shot search given a `checkpoint_dir` saves its carry there
between chunks once it has run `CKPT_MIN_ELAPSED_S`, or when its
budget runs out, and a later call on the same history resumes from
the saved chunk instead of block zero (the reference's file format
and key).

Soundness: every transition is a legal linearization step, so a lane
alive after the final barrier is a witness — `valid=True` is exact.
The search is not exhaustive (beam and chain depth bound it), so a
dead frontier proves nothing: it returns None and callers escalate.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time
from typing import Iterator, NamedTuple, Optional, Union

import numpy as np
import torch

from .. import device as _device
from .. import telemetry
from ..checker.wgl_cpu import WGLResult
from ..history.packed import ST_OK, PackedOps
from ..models.base import PackedModel
from ..telemetry import profile, roofline
from . import degrade, kernels, packing
from .wgl import _bucket, nonzero_static, packed_enabled, window_regather

log = logging.getLogger(__name__)

#: int32 sentinels, as Python ints so torch ops keep int32 tensors int32.
INF = 2**31 - 1
NO_BAR = 2**31 - 1

#: Info-window bounds of the narrow first attempt and the wide retry
#: (check_wgl_device runs the wide one only when the narrow plan
#: actually dropped info columns).
NARROW_INFO_WINDOW = 512
WIDE_INFO_WINDOW = 4096

#: Block shape: barriers per block and blocks per table upload — the
#: values of the cost model's heuristic
#: (plan/costmodel.py heuristic_witness_block_knobs), which a caller
#: that passes no shape gets unless a trained model covers the pass.
#: Block boundaries decide which info ops each block's window keeps, so
#: verdicts match the JAX package only at equal knobs.
BARS_PER_BLOCK = 2048
BLOCKS_PER_CALL = 32

#: Beam lanes (B) of the witness search; the reference's default.
BEAM = 8

#: Chain-search rounds per barrier (helper ops linearized before it).
CHAIN_DEPTH = 5

#: Widest planned window the witness takes on; wider escalates.
MAX_WINDOW = 32768

#: Seconds a search must have run before a checkpoint is worth writing:
#: short searches finish in milliseconds and would pay a carry read and
#: a file write per chunk for a file deleted moments later.  A blown
#: budget saves regardless: that is the run a resume recovers.
CKPT_MIN_ELAPSED_S = 5.0


def _ckpt_key(packed: PackedOps, pm: PackedModel, B: int, W: int,
              SW: int, K: int, NB: int,
              info_window: Optional[int]) -> str:
    """Digest binding a checkpoint to one (history, model, search shape)
    triple: the full packed arrays (a collision would resume the wrong
    search), the model's name and initial state (the beam states only
    mean anything under its transition function), and every shape
    knob.  The packing is not in it: the file holds the bool member
    window, whichever mode saved it."""
    h = hashlib.sha256()
    h.update(np.int64(
        [packed.n, B, W, SW, K, NB, -1 if info_window is None
         else info_window]
    ).tobytes())
    h.update(getattr(pm, "name", type(pm).__name__).encode())
    h.update(np.ascontiguousarray(
        np.asarray(pm.init_state, dtype=np.int64)).tobytes())
    for name in ("inv", "ret", "process", "status", "f", "a0", "a1"):
        h.update(np.ascontiguousarray(getattr(packed, name)).tobytes())
    return h.hexdigest()


def _ckpt_load(path: str, key: str):
    """-> (next block, member (W, B) bool, states, alive) or None."""
    import zipfile

    try:
        with np.load(path, allow_pickle=False) as z:
            if str(z["key"]) != key:
                return None
            return (int(z["c0"]), z["member"], z["states"], z["alive"])
    except (FileNotFoundError, OSError, KeyError, ValueError,
            zipfile.BadZipFile):
        # Missing, foreign, or torn (np.savez never fsyncs, so a hard
        # kill mid-save can leave a partial zip): start from block zero.
        return None


def _ckpt_save(path: str, key: str, c0: int, member: np.ndarray,
               states: np.ndarray, alive: np.ndarray) -> None:
    # np.savez appends ".npz" to names that lack it: the temporary
    # name must end in .npz or os.replace misses the real file.
    tmp = path + ".tmp.npz"
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(tmp, key=key, c0=np.int64(c0), member=member,
                 states=states, alive=alive)
        os.replace(tmp, path)
    except OSError:
        pass  # best effort: a full disk must not cost the verdict


def _ckpt_remove(path: Optional[str]) -> None:
    if path is None:
        return
    try:
        os.remove(path)
    except OSError:
        pass


def _state_hash_vec(sw: int, seed: int = 0xA11CE) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(1.0, 2.0, size=(sw,)).astype(np.float32)


def _plan_blocks(packed: PackedOps, bars_per_block: int,
                 info_window: Optional[int] = None,
                 rank_override: Optional[np.ndarray] = None):
    """Host-side plan: barrier order and per-block active windows (the
    reference's planner, copied).

    `info_window` keeps only the most recently invoked N indeterminate
    ops in each block's window.  Dropping an info column is sound for
    the witness (an unlinearized one merely stops being a helper; a
    linearized one keeps its state contribution).  The window is kept
    incrementally: rows are invocation-ordered, so each block's
    entrants are a contiguous index range, and its leavers are the
    barriers that passed in the previous block plus the oldest info
    rows beyond the bound.

    `rank_override` (n,) gives non-barrier rows a synthetic barrier
    rank (-1: none).  Once that rank passes, such a row is treated like
    a retired barrier: implied membership, no helper candidacy, gone
    from later windows.  Barrier rows keep their real ranks.

    Returns (bars, bar_rank, inv32, ret32, blocks, any_dropped).
    Raises OverflowError when an event index is >= int32 INF: the int32
    casts would otherwise wrap or clamp and corrupt the barrier order."""
    status = packed.status
    if packed.n:
        t_max = int(packed.inv.max())
        okm = status == ST_OK
        if okm.any():
            t_max = max(t_max, int(packed.ret[okm].max()))
        if t_max >= INF:
            raise OverflowError(
                f"event timeline exceeds int32: max index {t_max} >= "
                f"{INF}; witness tier cannot represent this history"
            )
    inv32 = packed.inv.astype(np.int32)
    ret32 = np.minimum(packed.ret, np.int64(INF)).astype(np.int32)
    ok_rows = np.nonzero(status == ST_OK)[0]
    bars = ok_rows[np.argsort(ret32[ok_rows], kind="stable")]
    bar_rank = np.full(packed.n, NO_BAR, dtype=np.int64)
    bar_rank[bars] = np.arange(len(bars))
    if rank_override is not None:
        ov = (rank_override >= 0) & (status != ST_OK)
        bar_rank[ov] = rank_override[ov]
    is_info = status != ST_OK
    blocks = []
    any_dropped = False
    # active: sorted row indices in the window; rows [0, hi) entered.
    active = np.empty(0, dtype=np.int64)
    hi = 0
    for k0 in range(0, len(bars), bars_per_block):
        block_bars = bars[k0 : k0 + bars_per_block]
        end_ret = int(ret32[block_bars[-1]])
        # Leavers: rows whose barrier passed before this block.
        if k0:
            active = active[bar_rank[active] >= k0]
        # Entrants: invoked before this block's last barrier.  An
        # np.int32 key keeps numpy from casting the whole column.
        hi_new = int(np.searchsorted(inv32, np.int32(end_ret), side="left"))
        if hi_new > hi:
            entering = np.arange(hi, hi_new, dtype=np.int64)
            entering = entering[bar_rank[entering] >= k0]
            active = np.concatenate([active, entering])
            hi = hi_new
        if info_window is not None:
            info_mask = is_info[active]
            n_info = int(info_mask.sum())
            if n_info > info_window:
                # Keep the newest N info rows; the drop is permanent.
                drop_pos = np.nonzero(info_mask)[0][: n_info - info_window]
                active = np.delete(active, drop_pos)
                any_dropped = True
        blocks.append((k0, block_bars, active))
    return bars, bar_rank, inv32, ret32, blocks, any_dropped


def _block_knobs(packed: PackedOps) -> tuple[dict, str]:
    """The cost model's block shape for `packed` (plan/costmodel.py):
    ({bars_per_block, blocks_per_call}, source)."""
    from ..plan.costmodel import choose_witness_block_knobs

    return choose_witness_block_knobs(packed.n, int(packed.n_ok))


def plan_width(packed: PackedOps, bars_per_block: Optional[int] = None,
               info_window: Optional[int] = NARROW_INFO_WINDOW) -> int:
    """The window width a witness run over `packed` will use."""
    if packed.n == 0 or packed.n_ok == 0:
        return 0
    if bars_per_block is None:
        bars_per_block = _block_knobs(packed)[0]["bars_per_block"]
    try:
        blocks = _plan_blocks(packed, bars_per_block, info_window)[4]
    except OverflowError:
        return 0
    return _bucket(max(max(len(a) for _, _, a in blocks), 1))


def plan_drops(packed: PackedOps, bars_per_block: Optional[int] = None,
               info_window: Optional[int] = NARROW_INFO_WINDOW) -> bool:
    """Whether a witness plan at this info_window would drop any info
    columns — when False, a wider window plans identically."""
    if packed.n == 0 or packed.n_ok == 0 or info_window is None:
        return False
    if packed.n - packed.n_ok <= info_window:
        return False  # fewer info ops than the window
    if bars_per_block is None:
        bars_per_block = _block_knobs(packed)[0]["bars_per_block"]
    try:
        return _plan_blocks(packed, bars_per_block, info_window)[5]
    except OverflowError:
        return False


def sweep_plain(start_k: int, bars: torch.Tensor, member: torch.Tensor,
                states: torch.Tensor, alive: torch.Tensor, step_rows):
    """The plain PyTorch sweep: the kernel's contract, one barrier per
    Python iteration.

    bars (6, K) i32 (window col, ret, real, f, a0, a1), member (W, B)
    bool, states (B, SW) i32, alive (B,) bool; `step_rows` is the
    model's `torch_step_rows`.  Returns (states', alive', death): death
    is the first real barrier >= start_k that no lane survives, with
    states and alive from just before it, or K when the block
    completes."""
    K = bars.shape[1]
    col, _, real, f, a0, a1 = bars.tolist()
    for k in range(start_k, K):
        has = member[col[k]]
        ns, legal = step_rows(states.T, f[k], a0[k], a1[k])
        surv_pass = alive & has
        surv_dir = alive & ~has & legal
        new_alive = surv_pass | surv_dir
        if real[k]:
            if not bool(new_alive.any()):
                return states, alive, k
            states = torch.where(surv_dir[:, None], ns.T, states)
            alive = new_alive
    return states, alive, K


def sweep(pm: PackedModel, start_k: int, bars: torch.Tensor,
          member: torch.Tensor, states: torch.Tensor, alive: torch.Tensor,
          init: Optional[torch.Tensor] = None):
    """The barrier sweep (see `sweep_plain` for the contract).

    CPU tensors take the plain version.  CUDA tensors go to the
    csrc/witness_sweep.cu kernel as they are (no packing, transpose or
    cast), at any beam and state width, or raise: a ValueError for a
    model with no device step (`pm.kernel_model` None) and the
    wrapper's (`kernels.witness_sweep`, before any launch) for bad
    shapes; KernelLaunchError for a failed launch or a kernel that
    reports a fault.  A stream model
    (`pm.stream`) needs `init`, its initial state as a (SW,) int32
    tensor on the card, and runs the kernel's stream instantiation.
    Reading the death barrier back is the call's one host sync."""
    if bars.device.type == "cpu":
        return sweep_plain(start_k, bars, member, states, alive,
                           pm.torch_step_rows)
    if pm.kernel_model is None:
        raise ValueError(
            f"model {pm.name!r} has no device step in the sweep kernel")
    if pm.stream and init is None:
        raise ValueError(f"stream model {pm.name!r} needs its initial state")
    s2, al2, death = kernels.witness_sweep(
        pm.kernel_model, start_k, bars, member, states, alive,
        init if pm.stream else None)
    d = _device.host(death)[0]
    if d < 0:
        raise kernels.KernelLaunchError(
            "witness_sweep: the kernel's producer and sweeper warps lost "
            "their hand-off")
    return s2, al2, d


class _Block:
    """One block's device tables and the chain search over them (the
    reference's `run_block` / `heavy`, as host-driven loops)."""

    def __init__(self, pm: PackedModel, tab: torch.Tensor, B: int,
                 compact: int, hv: torch.Tensor,
                 init: Optional[torch.Tensor], depth: int):
        self.pm = pm
        self.depth = depth
        self.init = init
        # tab (5, W): inv, f, a0, a1, bar_rank of the window rows.
        self.inv_w, self.f_w, self.a0_w, self.a1_w, self.rank_w = tab
        self.W = tab.shape[1]
        self.B = B
        self.WC = compact if 0 < compact < self.W else 0
        self.hv = hv
        self.col = torch.arange(self.W, device=tab.device)
        self.lane_ids = torch.arange(B, device=tab.device)

    def run(self, member, states, alive, bars_d, bars_h, k0: int):
        """Sweeps the block's barriers, running the chain search at each
        death point and resuming after it.  `bars_h` is the host copy of
        `bars_d`, or None when the table was built on the card: the
        death barrier's column is then read from there (one host read
        per death).  Returns (member, states, alive, failed,
        died_rank)."""
        K = bars_d.shape[1]
        cols = None if bars_h is None else bars_h[0]
        k = 0
        while k < K:
            with _device.timed("sweep_ns"):
                s2, al2, dk = sweep(self.pm, k, bars_d, member, states,
                                    alive, self.init)
                if profile.cost_hooked():
                    if cols is None:
                        cols = _device.host(bars_d[0])
                    profile.note_cost(roofline.sweep_cost(
                        k, dk, K, cols, self.B, states.shape[1],
                        self.init is not None))
                if dk >= K:
                    return member, s2, al2, False, NO_BAR
                col = (bars_h[:, dk] if bars_h is not None
                       else _device.host(bars_d[:, dk]))
                a, r, _, bf, ba0, ba1 = (int(x) for x in col)
            with _device.timed("chain_ns"):
                member, states, alive, done = self.heavy(
                    member, s2, al2, a, r, bf, ba0, ba1, k0 + dk)
            if not done:
                return member, states, alive, True, k0 + dk
            k = dk + 1
        return member, states, alive, False, NO_BAR

    def heavy(self, member, states, alive, a, r, bf, ba0, ba1, k_rank):
        """Chain search at one barrier: direct -> targeted h·a ->
        expand-any, bounded by `depth` rounds.  Two host syncs per
        round.  Counts the search (`heavy_rounds`) and each round
        (`chain_rounds`)."""
        _device.count("heavy_rounds")
        pm = self.pm
        # Membership of ops whose barrier already passed is implied.
        implied = self.rank_w < k_rank
        base_avail = (~implied & (self.inv_w < r) & (self.col != a))[:, None]
        for _ in range(self.depth):
            _device.count("chain_rounds")
            # try_direct
            ns, legal = pm.torch_step(states, bf, ba0, ba1)
            has = member[a]
            surv_dir = alive & ~has & legal
            al1 = (alive & has) | surv_dir
            s1 = torch.where(surv_dir[:, None], ns, states)
            # Helper candidates: (W, B) rows x lanes.
            avail = alive[None, :] & ~member & base_avail
            row_any = avail.any(dim=1)
            n_av = row_any.sum()
            alive_any, direct_any, n_av_h = _device.host(
                torch.stack([alive.any(), al1.any(), n_av]))
            if profile.cost_hooked():
                tile = (0 if not alive_any or direct_any
                        else self.W if self.WC == 0 or n_av_h > self.WC
                        else self.WC)
                profile.note_cost(roofline.chain_round_cost(
                    self.W, tile, self.B, states.shape[1]))
            if not alive_any:
                break
            if direct_any:
                return member, s1, al1, True
            member, states, alive, ok2 = self.targeted_or_expand(
                member, states, avail, row_any, n_av_h, bf, ba0, ba1)
            if _device.host(ok2):
                return member, states, alive, True
        return member, states, alive, False

    def targeted_or_expand(self, member, states, avail, row_any, n_av,
                           bf, ba0, ba1):
        """Chain-round escalation with candidate compaction: the window
        rows that still have an available (helper, lane) pair are
        gathered into a (WC, B) tile when they fit, else the full
        (W, B) tile runs.  The gather is ascending, so both select the
        same children."""
        if self.WC == 0 or n_av > self.WC:
            return self.run_tile(member, states, avail, self.col,
                                 self.f_w, self.a0_w, self.a1_w, bf, ba0, ba1)
        WC = self.WC
        # Padding rows read row 0 (the fill index) and are masked off.
        idx = nonzero_static(row_any, WC, 0)
        avail_c = avail[idx] & (torch.arange(WC, device=idx.device)
                                < n_av)[:, None]
        return self.run_tile(member, states, avail_c, idx, self.f_w[idx],
                             self.a0_w[idx], self.a1_w[idx], bf, ba0, ba1)

    def run_tile(self, member, states, avail, row_map, f_r, a0_r, a1_r,
                 bf, ba0, ba1):
        """One escalation over an (R, B) candidate tile: the helper
        pair-step is evaluated once and feeds both the targeted test
        (helper then barrier legal -> done) and the expand-any fallback
        (any productive helper -> keep searching).  Flat pair index is
        helper-major: i = h * B + lane."""
        pm, B = self.pm, self.B
        R = row_map.shape[0]
        flat = avail.reshape(-1)
        states_rep = states.repeat(R, 1)
        s1, legal1 = pm.torch_step(states_rep, f_r.repeat_interleave(B),
                                   a0_r.repeat_interleave(B),
                                   a1_r.repeat_interleave(B))
        s2, legal2 = pm.torch_step(s1, bf, ba0, ba1)
        good_t = flat & legal1 & legal2
        ok2 = good_t.any()
        productive = legal1 & (s1 != states_rep).any(dim=1)
        good_e = flat & productive
        child = torch.where(ok2, s2, s1)
        good = torch.where(ok2, good_t, good_e)
        cm, cs, ca = self.select_children(member, child, good, row_map)
        return cm, cs, ca, ok2

    def select_children(self, member, child_states, good, row_map):
        """Dedup (helper, lane) children by model state, keep <= B.
        Hash sort + exact adjacent compare: equal states hash equal
        (full float32; for SW = 1 the hash is one multiply), and the
        sort is stable like `jnp.argsort`, because tie order decides
        which children survive."""
        big = torch.tensor(3.0e38, dtype=torch.float32,
                           device=child_states.device)
        with _device.exact_float32():
            h = torch.where(good, child_states.to(torch.float32) @ self.hv,
                            big)
        order = torch.sort(h, stable=True).indices
        hs = h[order]
        ss = child_states[order]
        same = (hs == hs.roll(1)) & (ss == ss.roll(1, dims=0)).all(dim=1)
        same[0] = False
        uniq = (hs < big) & ~same
        n_child = torch.clamp(uniq.sum(), max=self.B)
        pos = order[nonzero_static(uniq, self.B, 0)]
        hcol = row_map[pos // self.B]
        lane = pos % self.B
        new_member = member[:, lane] | (self.col[:, None] == hcol[None, :])
        new_alive = self.lane_ids < n_child
        return new_member, child_states[pos], new_alive


class WitnessCarry(NamedTuple):
    """The search's state between blocks: the member window — (W, B)
    bool, or (W, ceil(B/32)) int32 words when packed —, the (B, SW)
    beam states and (B,) alive mask on the device, and the previous
    block's window rows (host; None before the first block), which the
    next block's re-gather maps from."""

    member: torch.Tensor
    states: torch.Tensor
    alive: torch.Tensor
    prev_active: Optional[np.ndarray]


def initial_carry(pm: PackedModel, W: int, B: int, dev: torch.device,
                  packed_on: bool = False) -> WitnessCarry:
    """The carry before the first block: an empty window (packed into
    words when `packed_on`), every lane at the initial state, lane 0
    alone alive."""
    member = (torch.zeros((W, packing.n_words(B)), dtype=torch.int32,
                          device=dev) if packed_on
              else torch.zeros((W, B), dtype=torch.bool, device=dev))
    states = torch.tensor(pm.init_state, dtype=torch.int32,
                          device=dev).repeat(B, 1)
    alive = torch.zeros(B, dtype=torch.bool, device=dev)
    alive[0] = True
    return WitnessCarry(member, states, alive, None)


def carry_window(carry: WitnessCarry) -> torch.Tensor:
    """The carry's (W, B) bool member window, unpacked if packed."""
    if carry.member.dtype == torch.bool:
        return carry.member
    return packing.unpack_bits(carry.member, carry.states.shape[0])


def compact_width(W: int, info_window: Optional[int]) -> int:
    """The chain rounds' compact candidate tile for window width W:
    max(64, min(W // 2, info_window)), or W // 8 without a bound."""
    return max(64, min(W // 2, info_window if info_window is not None
                       else W // 8))


def _chunk_tables(packed: PackedOps, plan, chunk: list,
                  prev_active: Optional[np.ndarray], K: int, W: int):
    """One chunk's tables, built on the host for one upload: bars
    (nblk, 6, K) and tab (nblk, 5, W) int32, and the re-gather of each
    block's window from the one before (perm (nblk, W) int64, present
    (nblk, W) bool; the very first block keeps member all-False).
    Returns them and the chunk's last window rows."""
    _, bar_rank, inv32, ret32 = plan[:4]
    nblk = len(chunk)
    bars_np = np.zeros((nblk, 6, K), dtype=np.int32)
    bars_np[:, 1, :] = INF
    tab_np = np.zeros((nblk, 5, W), dtype=np.int32)
    tab_np[:, 0, :] = INF
    tab_np[:, 4, :] = NO_BAR
    perm_np = np.zeros((nblk, W), dtype=np.int64)
    present_np = np.zeros((nblk, W), dtype=bool)
    for bi, (_, block_bars, active) in enumerate(chunk):
        nw = len(active)
        nb = len(block_bars)
        bars_np[bi, 0, :nb] = np.searchsorted(active, block_bars)
        bars_np[bi, 1, :nb] = ret32[block_bars]
        bars_np[bi, 2, :nb] = 1
        bars_np[bi, 3, :nb] = packed.f[block_bars]
        bars_np[bi, 4, :nb] = packed.a0[block_bars]
        bars_np[bi, 5, :nb] = packed.a1[block_bars]
        tab_np[bi, 0, :nw] = inv32[active]
        tab_np[bi, 1, :nw] = packed.f[active]
        tab_np[bi, 2, :nw] = packed.a0[active]
        tab_np[bi, 3, :nw] = packed.a1[active]
        tab_np[bi, 4, :nw] = np.minimum(bar_rank[active], NO_BAR)
        if prev_active is not None:
            perm, present = window_regather(prev_active, active)
            perm_np[bi, :nw] = perm
            present_np[bi, :nw] = present
        prev_active = active
    return bars_np, tab_np, perm_np, present_np, prev_active


#: The transfer modes `check_wgl_witness` takes besides "auto".
TRANSFER_MODES = ("full", "indices", "device")

#: The info cut of a block under no info window: keeps every info row.
NO_CUT = -(2**31)


def resolve_transfer(transfer: str, rank_override=None) -> str:
    """The transfer mode a search runs: "auto" is "full" on every
    device (the reference picks "device" only on a TPU, for its
    tunnelled uplink), and "device" under a `rank_override` is
    "indices", since the card's planner tells info rows by a rank of
    NO_BAR, which an override breaks.  Raises ValueError on an unknown
    mode."""
    if transfer not in ("auto",) + TRANSFER_MODES:
        raise ValueError(f"unknown transfer mode {transfer!r}")
    if transfer == "auto":
        transfer = "full"
    if transfer == "device" and rank_override is not None:
        transfer = "indices"
    return transfer


class RowTables(NamedTuple):
    """The per-row tables "indices" and "device" upload once per check,
    (n,) int32 each on the card: the op's f, a0, a1, its return and
    invocation index and min(barrier rank, NO_BAR); "device" adds the
    inclusive count of info rows (`icum`) and the barrier rows in rank
    order padded so any K-slice from a block's first rank is in bounds
    (`bars`)."""

    f: torch.Tensor
    a0: torch.Tensor
    a1: torch.Tensor
    ret: torch.Tensor
    inv: torch.Tensor
    rank: torch.Tensor
    icum: Optional[torch.Tensor]
    bars: Optional[torch.Tensor]


def _upload_rows(packed: PackedOps, plan, K: int, on_card_plan: bool,
                 dev: torch.device) -> tuple[RowTables, int]:
    """The check's `RowTables` on `dev` and the bytes they took up."""
    bars, bar_rank, inv32, ret32 = plan[:4]
    host = [packed.f, packed.a0, packed.a1, ret32, inv32,
            np.minimum(bar_rank, NO_BAR)]
    if on_card_plan:
        host.append(np.cumsum(packed.status != ST_OK))
        bars_pad = np.zeros(_bucket(len(bars) + K, lo=K), dtype=np.int64)
        bars_pad[:len(bars)] = bars
        host.append(bars_pad)
    # Every column is an op index, a timeline index below INF
    # (_plan_blocks raised otherwise) or a packed value.
    up = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
          for a in host]
    nbytes = sum(4 * int(a.shape[0]) for a in up)
    if not on_card_plan:
        up += [None, None]
    return RowTables(*up), nbytes


def _card_tables(rows: RowTables, bar_b: torch.Tensor, act: torch.Tensor,
                 nb: int, nw, K: int, W: int):
    """One block's (6, K) barrier table and (5, W) window table, built
    on the card from its barrier rows `bar_b` (K,) and its ascending
    window rows `act` (W,), int32, padded past `nb` and `nw` (act with
    n, above every row).  Padding reads row n - 1 and is masked to the
    host tables' fills, so both equal what "full" uploads."""
    n = rows.f.shape[0]
    jcol = torch.arange(K, device=bar_b.device)
    real = jcol < nb
    valid = torch.arange(W, device=act.device) < nw
    act_c = act.clamp(max=n - 1)
    col = torch.searchsorted(act, bar_b, out_int32=True)
    bars_b = torch.stack([
        torch.where(real, col, 0),
        torch.where(real, rows.ret[bar_b], INF),
        (jcol < nb).to(torch.int32),
        torch.where(real, rows.f[bar_b], 0),
        torch.where(real, rows.a0[bar_b], 0),
        torch.where(real, rows.a1[bar_b], 0),
    ])
    tab_b = torch.stack([
        torch.where(valid, rows.inv[act_c], INF),
        torch.where(valid, rows.f[act_c], 0),
        torch.where(valid, rows.a0[act_c], 0),
        torch.where(valid, rows.a1[act_c], 0),
        torch.where(valid, rows.rank[act_c], NO_BAR),
    ])
    return bars_b, tab_b


def _block_scalars(plan, block, info_window: Optional[int],
                   icum: np.ndarray) -> tuple[int, ...]:
    """The host's scalars for planning `block` on the card: (k0,
    end_ret, lo, nb, cut, hi).  Rows [lo, hi) hold the window, hi being
    the first row not invoked by the block's last barrier; an info row
    stays while its info count exceeds `cut`: the newest
    `info_window`."""
    _, _, inv32, ret32 = plan[:4]
    k0, block_bars, active = block
    er = int(ret32[block_bars[-1]])
    hi = int(np.searchsorted(inv32, np.int32(er), side="left"))
    lo = int(active[0]) if len(active) else hi
    cut = (int(icum[hi - 1]) - info_window
           if info_window is not None and hi > 0 else NO_CUT)
    return k0, er, lo, len(block_bars), cut, hi


def _card_window(rows: RowTables, prev_act: torch.Tensor, k0: int,
                 er: int, lo: int, cut: int, S: int, W: int):
    """A block's window rows planned on the card, and the re-gather of
    the member window from the previous block's rows `prev_act`: the
    rows r in [lo, lo + S) invoked before `er` whose barrier has not
    passed (rank >= k0), info rows only past the info `cut` — the host
    plan's row set.  Returns (act (W,) int32 padded with n, nw, perm,
    present)."""
    n = rows.f.shape[0]
    d = prev_act.device
    r = lo + torch.arange(S, device=d)
    rc = r.clamp(max=n - 1)
    rank = rows.rank[rc]
    mask = ((r < n) & (rows.inv[rc] < er) & (rank >= k0)
            & ((rank != NO_BAR) | (rows.icum[rc] > cut)))
    nw = mask.sum()
    wcol = torch.arange(W, device=d)
    local = nonzero_static(mask, W, S)
    act = torch.where(wcol < nw, lo + local.clamp(max=S - 1),
                      n).to(torch.int32)
    pos = torch.searchsorted(prev_act, act)
    pos_c = pos.clamp(0, W - 1)
    present = (pos < W) & (prev_act[pos_c] == act) & (act < n)
    perm = torch.where(present, pos_c, 0)
    return act, nw, perm, present


def _device_plan(packed: PackedOps, plan, blocks: list,
                 info_window: Optional[int], W: int):
    """Every block's `_block_scalars` and the slice width S: the widest
    [lo, hi) span bucketed up from min(W, 1024)."""
    icum = np.cumsum(packed.status != ST_OK)
    scal = [_block_scalars(plan, b, info_window, icum) for b in blocks]
    span = max([1] + [hi - lo for _, _, lo, _, _, hi in scal])
    return scal, _bucket(span, lo=min(W, 1024))


def run_chunks(pm: PackedModel, packed: PackedOps, plan, blocks: list,
               carry: WitnessCarry, *, K: int, NB: int, D: int,
               compact: int, dev: torch.device, transfer: str = "full",
               info_window: Optional[int] = None
               ) -> Iterator[tuple[WitnessCarry, int, bool, int]]:
    """Runs `blocks` (entries of `_plan_blocks`'s block list, in order,
    the first one following `carry`) from `carry`, NB blocks per chunk.
    The beam width B and window width W are the carry's, and so is the
    layout: a packed carry's words are re-gathered as words and
    unpacked for each block.  Yields after each chunk (carry, blocks in
    the chunk, failed, died_rank): `failed` when a block's chain search
    could not linearize a barrier (died_rank its global rank), after
    which it stops.  The one-shot search (`check_wgl_witness`) and the
    online frontier (streaming/frontier.py) both run their blocks here.

    `transfer` ("full", "indices" or "device"; see the module's
    docstring) says where the block tables are built.  "device" needs
    `info_window`, the plan's, and keeps the previous block's window
    rows on the card across blocks and chunks; the yielded carry's
    `prev_active` is the host plan's copy of them either way.  With
    telemetry on, each upload adds its bytes to `wgl.h2d-bytes`."""
    if transfer not in TRANSFER_MODES:
        raise ValueError(f"unknown transfer mode {transfer!r}")
    member, states, alive, prev_active = carry
    W, B = member.shape[0], states.shape[0]
    packed_on = member.dtype != torch.bool
    hv = torch.from_numpy(_state_hash_vec(pm.state_width)).to(dev)
    init = (torch.tensor(pm.init_state, dtype=torch.int32, device=dev)
            if pm.stream else None)

    def count_h2d(nbytes: int) -> None:
        if telemetry.enabled() and nbytes:
            telemetry.count("wgl.h2d-bytes", nbytes)

    rows = None
    if transfer != "full":
        rows, nbytes = _upload_rows(packed, plan, K, transfer == "device",
                                    dev)
        count_h2d(nbytes)
    if transfer == "device":
        scal, S = _device_plan(packed, plan, blocks, info_window, W)
        pa = np.full(W, packed.n, dtype=np.int32)
        if prev_active is not None:  # a resume: the rows before it
            pa[:len(prev_active)] = prev_active
        prev_act = torch.from_numpy(pa).to(dev)
        count_h2d(pa.nbytes)
    for c0 in range(0, len(blocks), NB):
        chunk = blocks[c0 : c0 + NB]
        nblk = len(chunk)
        bars_np = None
        with telemetry.span("wgl.witness.table"):
            if transfer == "full":
                bars_np, tab_np, perm_np, present_np, prev_active = \
                    _chunk_tables(packed, plan, chunk, prev_active, K, W)
                up = [bars_np, tab_np, perm_np, present_np]
            elif transfer == "indices":
                bar_np, act_np, perm_np, present_np, prev_active = \
                    _chunk_indices(packed, chunk, prev_active, K, W)
                up = [bar_np, act_np, perm_np, present_np]
            else:
                prev_active = chunk[-1][2]
                up = []
            count_h2d(sum(int(a.nbytes) for a in up))
            up_d = [torch.from_numpy(a).to(dev) for a in up]
        if transfer != "device":
            perm_d, present_d = up_d[2], up_d[3]

        failed, died = False, NO_BAR
        for bi, (k0, _, _) in enumerate(chunk):
            if transfer == "full":
                bars_b, tab_b = up_d[0][bi], up_d[1][bi]
            elif transfer == "indices":
                with telemetry.span("wgl.witness.table"):
                    bars_b, tab_b = _card_tables(
                        rows, up_d[0][bi], up_d[1][bi], len(chunk[bi][1]),
                        len(chunk[bi][2]), K, W)
            else:
                # Every block here is real (nb > 0): nothing pads the
                # carried window rows away.
                k0, er, lo, nb, cut, _ = scal[c0 + bi]
                with telemetry.span("wgl.witness.table"):
                    act, nw, perm_b, present_b = _card_window(
                        rows, prev_act, k0, er, lo, cut, S, W)
                    bars_b, tab_b = _card_tables(
                        rows, rows.bars[k0:k0 + K], act, nb, nw, K, W)
                prev_act = act
            if transfer != "device":
                perm_b, present_b = perm_d[bi], present_d[bi]
            # Re-lay the member window onto this block's rows; rows
            # absent from the previous window are cleared: a bool AND,
            # or a word AND with all-ones (present) or zero.
            keep = present_b[:, None]
            if packed_on:
                keep = -keep.to(torch.int32)
            member = member[perm_b] & keep
            blk = _Block(pm, tab_b, B, compact, hv, init, D)
            window = packing.unpack_bits(member, B) if packed_on else member
            window, states, alive, failed, died = blk.run(
                window, states, alive, bars_b,
                None if bars_np is None else bars_np[bi], k0)
            member = packing.pack_bits(window) if packed_on else window
            if failed:
                break
        yield (WitnessCarry(member, states, alive, prev_active), nblk,
               failed, died)
        if failed:
            return


def _chunk_indices(packed: PackedOps, chunk: list,
                   prev_active: Optional[np.ndarray], K: int, W: int):
    """One chunk's "indices" upload: each block's barrier rows (nblk, K)
    and window rows (nblk, W) as int32, padded with 0 and with n, and
    the member re-gather as `_chunk_tables` builds it (perm as int32).
    Returns them and the chunk's last window rows."""
    nblk = len(chunk)
    bar_np = np.zeros((nblk, K), dtype=np.int32)
    act_np = np.full((nblk, W), packed.n, dtype=np.int32)
    perm_np = np.zeros((nblk, W), dtype=np.int32)
    present_np = np.zeros((nblk, W), dtype=bool)
    for bi, (_, block_bars, active) in enumerate(chunk):
        bar_np[bi, :len(block_bars)] = block_bars
        act_np[bi, :len(active)] = active
        if prev_active is not None:
            perm, present = window_regather(prev_active, active)
            perm_np[bi, :len(active)] = perm
            present_np[bi, :len(active)] = present
        prev_active = active
    return bar_np, act_np, perm_np, present_np, prev_active


def check_wgl_witness(
    packed: PackedOps,
    pm: PackedModel,
    *,
    beam: int = BEAM,
    bars_per_block: Optional[int] = None,
    blocks_per_call: Optional[int] = None,
    depth: int = CHAIN_DEPTH,
    info_window: Optional[int] = NARROW_INFO_WINDOW,
    width_hint: int = 0,
    time_limit_s: Optional[float] = None,
    checkpoint_dir: Optional[str] = None,
    transfer: str = "auto",
    rank_override: Optional[np.ndarray] = None,
    out_info: Optional[dict] = None,
    packed_lanes: Optional[bool] = None,
    device: Union[str, torch.device, None] = "cuda",
    _degraded: bool = False,
) -> Optional[WGLResult]:
    """Runs the witness search on `device` (the card by default; raises
    when CUDA is asked for but missing).

    Returns an exact `WGLResult(valid=True)` when a witness
    linearization survives, or None when the search dies, overflows
    `MAX_WINDOW` or times out — meaning "escalate", never "invalid".

    `beam` lanes (bucketed up from 8), `bars_per_block` barriers per
    block, `blocks_per_call` blocks per table upload and `depth` chain
    rounds per barrier are the reference's knobs; a block shape the
    caller leaves None comes from the cost model
    (`choose_witness_block_knobs`: the heuristic's 2,048 x 32 unless a
    trained model covers the pass), and a history of fewer blocks than
    `blocks_per_call` uploads them in one bucket of at least 4, as the
    reference trims its call width.  `width_hint` forces at least that
    window width.  The chain rounds' compact candidate tile is
    `compact_width(W, info_window)` rows.  `rank_override` gives
    non-barrier rows a synthetic barrier rank (see `_plan_blocks`): the
    many-key stream (ops/wgl_stream.py) fences each key's indeterminate
    ops at its RESET with it.  `out_info`, when given, receives
    "died_at_rank": the global rank of the first barrier the chain
    search could not linearize (None when the death was not localized).
    `packed_lanes` (None: `JEPSEN_WGL_PACKED`, default on) carries the
    member window between blocks as 32-bit words.

    `transfer` ("auto", "full", "indices" or "device", the reference's
    modes; the module docstring says what each uploads) decides where
    the block tables are built; every mode gives the same tables, so
    the same verdict and death rank.  "auto" is "full" on every device,
    and "device" under a `rank_override` runs as "indices"
    (`resolve_transfer`); an unknown mode raises ValueError.

    `checkpoint_dir`: when set, the carry between chunks (the member
    window, unpacked, the beam states, the alive mask and the next
    block) is saved there after every chunk once the search has run
    `CKPT_MIN_ELAPSED_S`, or when its budget runs out, in
    `wgl-witness-<key>.ckpt.npz`, keyed by a digest of the packed
    history, the model and every shape knob.  A later call on the same
    history resumes from the saved chunk instead of block zero, in
    either packing mode.  The file is removed when the search concludes
    (witness found or frontier died); only a budget expiry leaves it.
    Disabled under `rank_override` (the key does not cover it).

    A device resource error in a chunk (an out-of-memory error, or the
    `JEPSEN_WGL_FAULT` hook's "witness" tier) first sheds the packed
    lanes (degradation step "packed-fallback"), then retries the search
    once with half the block shape on the same device, then returns
    None for the next tier ("retry-halved", "fall-through"); any other
    error raises."""
    transfer = resolve_transfer(transfer, rank_override)
    dev = _device.resolve(device)
    t0 = time.monotonic()
    n = packed.n
    if n == 0 or packed.n_ok == 0:
        return WGLResult(valid=True, configs_explored=1,
                         elapsed_s=time.monotonic() - t0)
    if bars_per_block is None or blocks_per_call is None:
        knobs, source = _block_knobs(packed)
        if bars_per_block is None:
            bars_per_block = knobs["bars_per_block"]
        if blocks_per_call is None:
            blocks_per_call = knobs["blocks_per_call"]
        telemetry.count(f"wgl.plan.witness-block-{source}")
    # The shape that ran, on the enclosing pass record.
    profile.annotate(bars_per_block=int(bars_per_block),
                     blocks_per_call=int(blocks_per_call))
    if rank_override is not None:
        checkpoint_dir = None  # the key does not cover the override
    try:
        with telemetry.span("wgl.witness.plan", n=n):
            plan = _plan_blocks(packed, bars_per_block, info_window,
                                rank_override)
    except OverflowError:
        return None  # the witness tier can't represent it: escalate
    bars, blocks = plan[0], plan[4]
    widest = max(len(a) for _, _, a in blocks)
    if widest > MAX_WINDOW:
        return None

    W = _bucket(max(widest, width_hint, 1))
    B = _bucket(beam, lo=8)
    packed_on = packed_enabled(packed_lanes)
    if len(blocks) < blocks_per_call:
        blocks_per_call = _bucket(len(blocks), lo=4)
    if telemetry.enabled():
        telemetry.gauge("wgl.witness.window", W)
        telemetry.gauge("wgl.witness.beam", B)
        telemetry.gauge("wgl.witness.blocks", len(blocks))
        if packed_on:
            telemetry.count("wgl.packed.witness-runs")

    def again(**kw) -> Optional[WGLResult]:
        """This search once more with `kw` changed, in the budget that
        remains (None when none does)."""
        remaining = None
        if time_limit_s is not None:
            remaining = time_limit_s - (time.monotonic() - t0)
            if remaining <= 0:
                return None
        args = dict(beam=beam, bars_per_block=bars_per_block,
                    blocks_per_call=blocks_per_call, depth=depth,
                    info_window=info_window, width_hint=width_hint,
                    checkpoint_dir=checkpoint_dir, transfer=transfer,
                    rank_override=rank_override, out_info=out_info,
                    packed_lanes=packed_on, _degraded=_degraded)
        args.update(kw)
        return check_wgl_witness(packed, pm, time_limit_s=remaining,
                                 device=dev, **args)

    def retry_smaller(e: BaseException) -> Optional[WGLResult]:
        if packed_on:
            # Packing is an optimisation, not a budget: it goes first.
            degrade.record("witness", "packed-fallback", e)
            telemetry.count("wgl.packed.fallbacks")
            return again(packed_lanes=False)
        if _degraded or bars_per_block <= 64:
            degrade.record("witness", "fall-through", e)
            log.warning("witness tier out of device resources after "
                        "halving; escalating to the next tier",
                        exc_info=True)
            return None
        degrade.record("witness", "retry-halved", e)
        log.warning("witness chunk exhausted device resources; retrying "
                    "once at bars_per_block=%d", bars_per_block // 2,
                    exc_info=True)
        return again(bars_per_block=bars_per_block // 2,
                     blocks_per_call=max(blocks_per_call // 2, 1),
                     _degraded=True)

    carry = initial_carry(pm, W, B, dev, packed_on)
    c0 = 0
    ckpt_path = ckpt_key = None
    if checkpoint_dir is not None:
        ckpt_key = _ckpt_key(packed, pm, B, W, pm.state_width,
                             bars_per_block, blocks_per_call, info_window)
        # The key prefix in the name keeps concurrent searches sharing
        # one directory (per-key checks) apart.
        ckpt_path = os.path.join(checkpoint_dir,
                                 f"wgl-witness-{ckpt_key[:16]}.ckpt.npz")
        carry, c0 = _resume(ckpt_path, ckpt_key, carry, blocks, packed_on,
                            dev)

    chunks = run_chunks(pm, packed, plan, blocks[c0:], carry,
                        K=bars_per_block, NB=blocks_per_call, D=depth,
                        compact=compact_width(W, info_window), dev=dev,
                        transfer=transfer, info_window=info_window)
    for _ in range(-(-(len(blocks) - c0) // blocks_per_call)):
        try:
            degrade.maybe_fault("witness")
            with telemetry.span("wgl.witness.chunk"):
                carry, nblk, failed, died = next(chunks)
        except Exception as e:  # noqa: BLE001 — only resource errors
            if not degrade.is_resource_error(e):
                raise
            return retry_smaller(e)
        c0 += nblk
        if failed:
            _ckpt_remove(ckpt_path)  # concluded: a resume cannot help
            if out_info is not None:
                out_info["died_at_rank"] = (None if died == NO_BAR
                                            else int(died))
            return None
        budget_blown = (time_limit_s is not None
                        and time.monotonic() - t0 > time_limit_s)
        if ckpt_path is not None and (
                budget_blown or time.monotonic() - t0 > CKPT_MIN_ELAPSED_S):
            if dev.type != "cpu":
                _device.count("host_syncs")
            _ckpt_save(ckpt_path, ckpt_key, c0,
                       carry_window(carry).cpu().numpy(),
                       carry.states.cpu().numpy(), carry.alive.cpu().numpy())
        if budget_blown:
            return None  # escalate; the checkpoint stays for a resume

    _ckpt_remove(ckpt_path)
    if not _device.host(carry.alive.any()):
        if out_info is not None:
            out_info["died_at_rank"] = None  # not localized
        return None
    return WGLResult(valid=True, configs_explored=len(bars),
                     elapsed_s=time.monotonic() - t0)


def _resume(path: str, key: str, carry: WitnessCarry, blocks: list,
            packed_on: bool, dev: torch.device
            ) -> tuple[WitnessCarry, int]:
    """The carry and next block saved at `path` under `key`, or `carry`
    and block 0 when there is none.  The blocks are planned again from
    the history, so only the cursor and the carry were saved; a cursor
    past the end clamps (the search then concludes from the carry)."""
    saved = _ckpt_load(path, key)
    if saved is None:
        return carry, 0
    c0, member, states, alive = saved
    W, B = carry.member.shape[0], carry.states.shape[0]
    if (member.shape != (W, B) or states.shape != tuple(carry.states.shape)
            or alive.shape != (B,)):
        return carry, 0
    c0 = min(c0, len(blocks))
    window = torch.from_numpy(member.astype(bool)).to(dev)
    return WitnessCarry(
        packing.pack_bits(window) if packed_on else window,
        torch.from_numpy(states.astype(np.int32)).to(dev),
        torch.from_numpy(alive.astype(bool)).to(dev),
        blocks[c0 - 1][2] if c0 > 0 else None), c0
