"""Device witness search for linearizability — the valid-verdict fast
path, in PyTorch with a CUDA barrier sweep.

The port of `jepsen_tpu/ops/wgl_witness.py` (`transfer="full"`).  It is
an event-walk form of Wing–Gong:

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

Execution is a host loop: blocks of `BARS_PER_BLOCK` barriers, their
tables built on the host and uploaded `BLOCKS_PER_CALL` blocks at a
time; inside a block, sweep -> read the death barrier -> chain search
-> resume.  Each read of a device value is a host sync
(`device.counters["host_syncs"]`).

Soundness: every transition is a legal linearization step, so a lane
alive after the final barrier is a witness — `valid=True` is exact.
The search is not exhaustive (beam and chain depth bound it), so a
dead frontier proves nothing: it returns None and callers escalate.
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
from . import kernels
from .wgl import _bucket, nonzero_static, window_regather

#: int32 sentinels, as Python ints so torch ops keep int32 tensors int32.
INF = 2**31 - 1
NO_BAR = 2**31 - 1

#: Info-window bounds of the narrow first attempt and the wide retry
#: (check_wgl_device runs the wide one only when the narrow plan
#: actually dropped info columns).
NARROW_INFO_WINDOW = 512
WIDE_INFO_WINDOW = 4096

#: Block shape: barriers per block and blocks per table upload — the
#: reference's heuristic default (plan/costmodel.py
#: heuristic_witness_block_knobs).  Block boundaries decide which info
#: ops each block's window keeps, so verdicts match the JAX package
#: only at equal knobs.
BARS_PER_BLOCK = 2048
BLOCKS_PER_CALL = 32

#: Beam lanes (B) of the witness search; the reference's default.
BEAM = 8

#: Chain-search rounds per barrier (helper ops linearized before it).
CHAIN_DEPTH = 5

#: Widest planned window the witness takes on; wider escalates.
MAX_WINDOW = 32768

#: Beams up to this width fit the sweep kernel's one-word member bits.
MAX_KERNEL_BEAM = 32

#: The widest model state the sweep kernel is compiled for.
MAX_KERNEL_STATE = 32


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


def plan_width(packed: PackedOps, bars_per_block: int = BARS_PER_BLOCK,
               info_window: Optional[int] = NARROW_INFO_WINDOW) -> int:
    """The window width a witness run over `packed` will use."""
    if packed.n == 0 or packed.n_ok == 0:
        return 0
    try:
        blocks = _plan_blocks(packed, bars_per_block, info_window)[4]
    except OverflowError:
        return 0
    return _bucket(max(max(len(a) for _, _, a in blocks), 1))


def plan_drops(packed: PackedOps, bars_per_block: int = BARS_PER_BLOCK,
               info_window: Optional[int] = NARROW_INFO_WINDOW) -> bool:
    """Whether a witness plan at this info_window would drop any info
    columns — when False, a wider window plans identically."""
    if packed.n == 0 or packed.n_ok == 0 or info_window is None:
        return False
    if packed.n - packed.n_ok <= info_window:
        return False  # fewer info ops than the window
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
    cast) or raise: a ValueError for a model with no device step
    (`pm.kernel_model` None), a state wider than the kernel's 32 words
    or a beam wider than one member word, KernelLaunchError for a
    failed launch or a kernel that reports a fault.  A stream model
    (`pm.stream`) needs `init`, its initial state as a (SW,) int32
    tensor on the card, and runs the kernel's stream instantiation.
    Reading the death barrier back is the call's one host sync."""
    if bars.device.type == "cpu":
        return sweep_plain(start_k, bars, member, states, alive,
                           pm.torch_step_rows)
    if pm.kernel_model is None:
        raise ValueError(
            f"model {pm.name!r} has no device step in the sweep kernel")
    if pm.state_width > MAX_KERNEL_STATE:
        raise ValueError(f"model {pm.name!r}: state width "
                         f"{pm.state_width} > {MAX_KERNEL_STATE}")
    B = member.shape[1]
    if B > MAX_KERNEL_BEAM:
        raise ValueError(f"beam {B} does not fit one 32-bit member word")
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
                 init: Optional[torch.Tensor]):
        self.pm = pm
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
        death point and resuming after it.  Returns (member, states,
        alive, failed, died_rank)."""
        K = bars_h.shape[1]
        k = 0
        while k < K:
            s2, al2, dk = sweep(self.pm, k, bars_d, member, states, alive,
                                self.init)
            if dk >= K:
                return member, s2, al2, False, NO_BAR
            a, r, _, bf, ba0, ba1 = (int(x) for x in bars_h[:, dk])
            member, states, alive, done = self.heavy(
                member, s2, al2, a, r, bf, ba0, ba1, k0 + dk)
            if not done:
                return member, states, alive, True, k0 + dk
            k = dk + 1
        return member, states, alive, False, NO_BAR

    def heavy(self, member, states, alive, a, r, bf, ba0, ba1, k_rank):
        """Chain search at one barrier: direct -> targeted h·a ->
        expand-any, bounded by CHAIN_DEPTH rounds.  Two host syncs per
        round."""
        _device.count("heavy_rounds")
        pm = self.pm
        # Membership of ops whose barrier already passed is implied.
        implied = self.rank_w < k_rank
        base_avail = (~implied & (self.inv_w < r) & (self.col != a))[:, None]
        for _ in range(CHAIN_DEPTH):
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


def check_wgl_witness(
    packed: PackedOps,
    pm: PackedModel,
    *,
    info_window: Optional[int] = NARROW_INFO_WINDOW,
    width_hint: int = 0,
    time_limit_s: Optional[float] = None,
    rank_override: Optional[np.ndarray] = None,
    out_info: Optional[dict] = None,
    device: Union[str, torch.device, None] = "cuda",
) -> Optional[WGLResult]:
    """Runs the witness search on `device` (the card by default; raises
    when CUDA is asked for but missing).

    Returns an exact `WGLResult(valid=True)` when a witness
    linearization survives, or None when the search dies, overflows
    `MAX_WINDOW` or times out — meaning "escalate", never "invalid".

    `width_hint` forces at least that window width.  The chain rounds'
    compact candidate tile is max(64, min(W // 2, info_window)) rows
    wide (W // 8 without a window bound).  `rank_override` gives
    non-barrier rows a synthetic barrier rank (see `_plan_blocks`): the
    many-key stream (ops/wgl_stream.py) fences each key's indeterminate
    ops at its RESET with it.  `out_info`, when given, receives
    "died_at_rank": the global rank of the first barrier the chain
    search could not linearize (None when the death was not
    localized)."""
    dev = _device.resolve(device)
    t0 = time.monotonic()
    n = packed.n
    if n == 0 or packed.n_ok == 0:
        return WGLResult(valid=True, configs_explored=1,
                         elapsed_s=time.monotonic() - t0)
    try:
        bars, bar_rank, inv32, ret32, blocks, _ = _plan_blocks(
            packed, BARS_PER_BLOCK, info_window, rank_override)
    except OverflowError:
        return None  # the witness tier can't represent it: escalate
    widest = max(len(a) for _, _, a in blocks)
    if widest > MAX_WINDOW:
        return None

    SW = pm.state_width
    B = BEAM
    K = BARS_PER_BLOCK
    W = _bucket(max(widest, width_hint, 1))
    compact = max(64, min(
        W // 2, info_window if info_window is not None else W // 8))
    hv = torch.from_numpy(_state_hash_vec(SW)).to(dev)
    init = (torch.tensor(pm.init_state, dtype=torch.int32, device=dev)
            if pm.stream else None)

    member = torch.zeros((W, B), dtype=torch.bool, device=dev)
    states = torch.tensor(pm.init_state, dtype=torch.int32,
                          device=dev).repeat(B, 1)
    alive = torch.zeros(B, dtype=torch.bool, device=dev)
    alive[0] = True
    rank32 = np.minimum(bar_rank, NO_BAR)
    prev_active: Optional[np.ndarray] = None

    for c0 in range(0, len(blocks), BLOCKS_PER_CALL):
        chunk = blocks[c0 : c0 + BLOCKS_PER_CALL]
        nblk = len(chunk)
        # The chunk's tables, built on the host and uploaded together.
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
            tab_np[bi, 4, :nw] = rank32[active]
            if prev_active is not None:
                # The very first block keeps member all-False.
                perm, present = window_regather(prev_active, active)
                perm_np[bi, :nw] = perm
                present_np[bi, :nw] = present
            prev_active = active
        bars_d = torch.from_numpy(bars_np).to(dev)
        tab_d = torch.from_numpy(tab_np).to(dev)
        perm_d = torch.from_numpy(perm_np).to(dev)
        present_d = torch.from_numpy(present_np).to(dev)

        for bi, (k0, _, _) in enumerate(chunk):
            # Re-lay the member window onto this block's rows.
            member = member[perm_d[bi]] & present_d[bi][:, None]
            blk = _Block(pm, tab_d[bi], B, compact, hv, init)
            member, states, alive, failed, died = blk.run(
                member, states, alive, bars_d[bi], bars_np[bi], k0)
            if failed:
                if out_info is not None:
                    out_info["died_at_rank"] = (None if died == NO_BAR
                                                else int(died))
                return None
        if (time_limit_s is not None
                and time.monotonic() - t0 > time_limit_s):
            return None  # budget blown: escalate

    if not _device.host(alive.any()):
        if out_info is not None:
            out_info["died_at_rank"] = None  # not localized
        return None
    return WGLResult(valid=True, configs_explored=len(bars),
                     elapsed_s=time.monotonic() - t0)
