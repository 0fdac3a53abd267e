"""The witness barrier sweep on the CPU: the port's plain version
against the JAX package's Pallas kernel in interpret mode, and a model
of the CUDA kernel's batch algorithm (csrc/witness_sweep.cu: per-lane
speculation over 32-barrier batches, one OR-vote per batch, rewind and
replay at a death; every model's device step and the stream's RESET)
against both — exact integer equality of states, alive and death.  The
JAX package's stream models do not run in its Pallas interpret mode
(their step captures the initial state as a constant), so the stream
instantiations are held against the plain sweep driven by the JAX
package's stream step instead.  The CUDA kernel itself is held against
the plain version on the card in tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jepsen_tpu.models as ref_models
from jepsen_tpu.models import cas_register as ref_cas_register
from jepsen_tpu.ops.wgl_stream import stream_model as ref_stream_model
from jepsen_tpu.ops.wgl_witness import _make_pallas_sweep
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops.wgl_witness import sweep_plain
from test_torch_kernels_cuda import (CASES, MODEL_CASES, SW, K, W,
                                     case_tables, expected_death,
                                     model_case_tables, model_pm)

_ref_sweeps = {}


def _ref_sweep(B):
    fn = _ref_sweeps.get(B)
    if fn is None:
        fn = _make_pallas_sweep(B, W, SW, K,
                                ref_cas_register().packed().jax_step_rows,
                                interpret=True)
        _ref_sweeps[B] = fn
    return fn


# ---------------------------------------------------------------------------
# The kernel's algorithm, written line by line from csrc/witness_sweep.cu
# (same names; Python ints stand for the 32-bit registers, a list of 32
# values for a warp's lanes).  The two warps run one after the other
# here: the producer's records do not depend on the sweeper, except for
# where it stops.

M32 = 0xFFFFFFFF
F_WRITE, F_CAS = 1, 2
F_ACQUIRE = F_ENQ = 0
F_RESET = 1 << 20
MODEL_REGISTER, MODEL_MUTEX, MODEL_MULTI_REGISTER = 1, 2, 3
MODEL_FIFO_QUEUE, MODEL_UNORDERED_QUEUE = 4, 5
T, AHEAD = 32, 3
STAGES = AHEAD + 1
#: Shared memory a lane never wrote: the kernel must mask it off.
GARBAGE = 0xA5C3_96F1


def register_step(s, f, a0, a1):
    is_write = f == F_WRITE
    is_cas = f == F_CAS
    nxt = a0 if is_write else (a1 if is_cas else s)
    return is_write or s == a0, nxt


def state_bucket(model, sw):
    """The compiled state width SW of `model` at real width sw."""
    if model == MODEL_MULTI_REGISTER:
        return max(2, 1 << (sw - 1).bit_length())
    return sw


def bits(preds):
    return sum(int(bool(p)) << j for j, p in enumerate(preds))


def model_step(model, s, f, a0, a1):
    """model_step<MODEL, SW> on one lane's state tuple s (its SW
    columns) -> (legal, next)."""
    SW_ = len(s)
    if model == MODEL_REGISTER:
        legal, nx = register_step(s[0], f, a0, a1)
        return legal, (nx,)
    if model == MODEL_MUTEX:
        is_acq = f == F_ACQUIRE
        return (s[0] == 0 if is_acq else s[0] == 1), (1 if is_acq else 0,)
    if model == MODEL_MULTI_REGISTER:
        is_write = f == F_WRITE
        cur = 0
        for j in range(SW_):
            cur |= s[j] if j == a0 else 0
        nxt = tuple(a1 if is_write and j == a0 else s[j] for j in range(SW_))
        return is_write or cur == a1, nxt
    is_enq = f == F_ENQ
    if model == MODEL_FIFO_QUEUE:
        length = bin(bits(x != 0 for x in s)).count("1")
        nxt = tuple((a0 if j == length else s[j]) if is_enq
                    else (s[j + 1] if j + 1 < SW_ else 0) for j in range(SW_))
        return (length < SW_ if is_enq else s[0] == a0 and a0 != 0), nxt
    assert model == MODEL_UNORDERED_QUEUE
    cand = bits(x == 0 for x in s) if is_enq else bits(x == a0 for x in s)
    pick = cand & ((-cand) & M32)  # its lowest slot
    put = a0 if is_enq else 0
    return cand != 0, tuple(put if (pick >> j) & 1 else s[j]
                            for j in range(SW_))


def lane_step(st, alive, op, stay, model=MODEL_REGISTER, init=None):
    """-> (st, alive) of one lane after one barrier, op = (f, a0, a1);
    st a state tuple (a plain int for the register).  `init` (a stream
    instantiation) makes RESET legal, to the initial state."""
    scalar = model == MODEL_REGISTER and not isinstance(st, tuple)
    legal, nx = model_step(model, (st,) if scalar else st, *op)
    if init is not None and op[0] == F_RESET:
        legal, nx = True, init
    take = alive and not stay and legal
    if scalar:
        nx = nx[0]
    st = nx if take else st
    return st, alive and (stay or legal)


class Stage:
    def __init__(self, nw):
        self.op = [[0, 0, 0, 0] for _ in range(T)]
        self.raw = [[GARBAGE] * nw for _ in range(T)]


def load_bar(bars, K_, k):
    if k < K_:
        col, real, f, a0, a1 = (int(bars[r, k]) for r in (0, 2, 3, 4, 5))
        return (col, 1 if real != 0 else 0, f, a0, a1)
    return (0, 0, 0, 0, 0)


def stage_batch(sg, bar_of_lane, member_words, B, member_bytes, nw):
    """Every lane's part of stage_batch; the cp.async copies land at
    once here (the kernel waits for them before packing)."""
    for lane in range(T):
        col, real, f, a0, a1 = bar_of_lane[lane]
        lo = col * B
        sg.op[lane] = [(lo & 3) | (real << 2), f, a0, a1]
        end = lo + B
        for w in range(nw):
            at = (lo & ~3) + 4 * w
            need = at < end
            left = member_bytes - at
            n = (min(left, 4) if need else 0)
            word = member_words[at // 4] if need else 0
            sg.raw[lane][w] = word & ((1 << (8 * n)) - 1)  # zero-filled


def pack_row(sg, offset, B, lane, nw):
    raw = sg.raw[lane]
    word = 0
    for q in range(nw - 1):
        v = (((raw[q + 1] << 32) | raw[q]) >> (8 * offset)) & M32
        nz = (((v & 0x7F7F7F7F) + 0x7F7F7F7F) | v) & 0x80808080
        word |= ((((nz >> 7) * 0x10204080) & M32) >> 28) << (4 * q)
    return word & ((((2 << (B - 1)) & M32) - 1) & M32)  # bytes past the row


def ballot(preds):
    """__ballot_sync over the warp."""
    return sum(int(bool(p)) << lane for lane, p in enumerate(preds))


def reduce_or(values):
    """__reduce_or_sync over the warp."""
    out = 0
    for v in values:
        out |= v
    return out


def produce(bars, member_words, B, K_, member_bytes, start, batches, nw,
            model=MODEL_REGISTER, sw=1):
    """Warp 1: every record it would write (it writes them all when the
    sweeper does not stop it).  For the multi-register an a0 outside
    the real width sw becomes -1."""
    stages = [Stage(nw) for _ in range(STAGES)]
    records = []
    pro = [[load_bar(bars, K_, start + p * T + lane) for lane in range(T)]
           for p in range(AHEAD + 1)]
    for p in range(AHEAD):
        stage_batch(stages[p], pro[p], member_words, B, member_bytes, nw)
    nxt = pro[AHEAD]
    for m in range(batches):
        k = start + m * T
        stage_batch(stages[(m + AHEAD) % STAGES], nxt, member_words, B,
                    member_bytes, nw)
        nxt = [load_bar(bars, K_, k + (AHEAD + 1) * T + lane)
               for lane in range(T)]
        sg = stages[m % STAGES]
        ops = [list(sg.op[lane]) for lane in range(T)]
        word = [pack_row(sg, ops[lane][0] & 3, B, lane, nw)
                for lane in range(T)]
        real = ballot((ops[lane][0] >> 2) & 1 for lane in range(T))
        has = [0] * T
        for b in range(4 * (nw - 1)):
            r = ballot((word[lane] >> b) & 1 for lane in range(T))
            has = [r if lane == b else has[lane] for lane in range(T)]
        if model == MODEL_MULTI_REGISTER:
            for o in ops:
                o[2] = o[2] if 0 <= o[2] < sw else -1
        records.append(dict(
            op=[(o[1], o[2], o[3]) for o in ops],
            stay=[(~real | has[lane]) & M32 for lane in range(T)],
            real=real))
    return records


def ffs(x):
    return (x & -x).bit_length()


def batch_model_sweep(start, bars, member, states, alive,
                      model=MODEL_REGISTER, init=None):
    """The kernel on numpy inputs (bars (6, K) i32, member (W, B) bool,
    states (B, sw) i32, alive (B,) bool, and for a stream instantiation
    its (sw,) initial state) -> (states', alive', death).  Lanes hold
    the SW bucket's columns, the padding ones 0."""
    K_ = bars.shape[1]
    W_, B = member.shape
    sw = states.shape[1]
    SW_ = state_bucket(model, sw)
    nw = 3 if B <= 8 else 9
    member_bytes = W_ * B
    flat = np.zeros(4 * ((member_bytes + 3) // 4), dtype=np.uint8)
    flat[:member_bytes] = member.reshape(-1)
    member_words = [int(x) for x in flat.view("<u4")]
    batches = (K_ - start + T - 1) // T
    records = produce(bars, member_words, B, K_, member_bytes, start,
                      batches, nw, model, sw)
    if init is not None:
        init = tuple(int(x) for x in init) + (0,) * (SW_ - sw)

    def step(st, al, op, stay):
        return lane_step(st, al, op, stay, model, init)

    # Warp 0: lane = beam lane.
    in_beam = [lane < B for lane in range(T)]
    st = [tuple(int(states[lane, j]) if in_beam[lane] and j < sw else 0
                for j in range(SW_)) for lane in range(T)]
    al = [bool(in_beam[lane] and alive[lane]) for lane in range(T)]
    death = K_
    for n in range(batches):
        k = start + n * T
        rec = records[n]
        st0, al0 = list(st), list(al)
        mask = [0] * T
        for lane in range(T):
            alive_after = 0
            for i in range(T):
                st[lane], al[lane] = step(
                    st[lane], al[lane], rec["op"][i],
                    (rec["stay"][lane] >> i) & 1)
                alive_after += al[lane]
            mask[lane] = M32 if alive_after == T else (1 << alive_after) - 1
        dead = ~reduce_or(mask) & rec["real"] & M32
        if dead:
            d = ffs(dead) - 1
            st, al = list(st0), list(al0)
            for lane in range(T):
                for i in range(d):
                    st[lane], al[lane] = step(
                        st[lane], al[lane], rec["op"][i],
                        (rec["stay"][lane] >> i) & 1)
            death = k + d
            break

    out_states = np.array([st[lane][:sw] for lane in range(B)],
                          dtype=np.int32)
    out_alive = np.array([al[lane] for lane in range(B)])
    return out_states, out_alive, death


# ---------------------------------------------------------------------------


def _plain(start_k, bars, member, states, alive):
    s, a, d = sweep_plain(
        start_k, torch.from_numpy(bars), torch.from_numpy(member),
        torch.from_numpy(states), torch.from_numpy(alive),
        cas_register().packed().torch_step_rows)
    return s.numpy(), a.numpy(), d


@pytest.mark.parametrize("B,start_k,kind", CASES)
def test_sweep_plain_matches_pallas_interpret(B, start_k, kind):
    bars, member, states, alive = case_tables(B, start_k, kind)
    ref_s, ref_a, ref_d = _ref_sweep(B)(start_k, bars, member, states, alive)
    got_s, got_a, got_d = _plain(start_k, bars, member, states, alive)
    assert got_d == int(ref_d)
    assert np.array_equal(got_s, np.asarray(ref_s))
    assert np.array_equal(got_a, np.asarray(ref_a))
    assert expected_death(kind, start_k, got_d)


@pytest.mark.parametrize("B,start_k,kind", CASES)
def test_batch_model_matches_plain_and_pallas(B, start_k, kind):
    bars, member, states, alive = case_tables(B, start_k, kind)
    got_s, got_a, got_d = batch_model_sweep(start_k, bars, member, states,
                                            alive)
    for want_s, want_a, want_d in (
            _plain(start_k, bars, member, states, alive),
            _ref_sweep(B)(start_k, bars, member, states, alive)):
        assert got_d == int(want_d)
        assert np.array_equal(got_s, np.asarray(want_s))
        assert np.array_equal(got_a, np.asarray(want_a))


@pytest.mark.parametrize("B", [1, 3, 8, 31, 32])
def test_batch_model_packs_rows_at_every_byte_offset(B):
    """The kernel's row packing (aligned 4-byte copies cut at the
    window's end, funnel shift, nonzero-byte gather) gives bit b = lane
    b for every row, whatever its byte offset, with garbage beyond the
    row masked off.  W = 7 rows make every offset 0-3 occur for odd B,
    and W * B a non-multiple of 4."""
    rng = np.random.default_rng(B)
    member = rng.random((7, B)) < 0.5
    member[0] = True  # all lanes: bit 31 set at B = 32
    member[1] = False
    nw = 3 if B <= 8 else 9
    member_bytes = member.size
    flat = np.zeros(4 * ((member_bytes + 3) // 4), dtype=np.uint8)
    flat[:member_bytes] = member.reshape(-1)
    words = [int(x) for x in flat.view("<u4")]
    for col in range(member.shape[0]):
        sg = Stage(nw)
        stage_batch(sg, [(col, 1, 0, 0, 0)] * T, words, B, member_bytes, nw)
        got = pack_row(sg, sg.op[0][0] & 3, B, 0, nw)
        want = sum(int(bit) << b for b, bit in enumerate(member[col]))
        assert got == want, (col, (col * B) & 3)


def test_batch_model_tail_batch_is_masked():
    """A start whose last batch runs past K: the barriers past K are
    neither real nor fetched, and a clean table completes (death K)."""
    bars, member, states, alive = case_tables(8, K - 5, "clean")
    got = batch_model_sweep(K - 5, bars, member, states, alive)
    want = _plain(K - 5, bars, member, states, alive)
    assert got[2] == want[2] == K
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# Every model's instantiation, plain and stream (MODEL_CASES: B = 1, 8
# and 32, deaths mid-block and at batch offsets 0 and 31, starts 1, 31
# and 33, padding).

REF_FACTORIES = {
    "register": ref_models.cas_register,
    "mutex": ref_models.mutex,
    "multi3": lambda: ref_models.multi_register({f"r{i}": 0 for i in range(3)}),
    "multi5": lambda: ref_models.multi_register({f"r{i}": 0 for i in range(5)}),
    "fifo": ref_models.fifo_queue,
    "unordered": ref_models.unordered_queue,
}

_ref_pms = {}


def _ref_pm(name):
    pm = _ref_pms.get(name)
    if pm is None:
        base, _, stream = name.partition("+")
        pm = REF_FACTORIES[base]().packed()
        _ref_pms[name] = pm = ref_stream_model(pm) if stream else pm
    return pm


def _model_init(name):
    pm = model_pm(name)
    return np.array(pm.init_state, dtype=np.int32) if pm.stream else None


def _model_plain(name, start_k, bars, member, states, alive, step_rows=None):
    s, a, d = sweep_plain(
        start_k, torch.from_numpy(bars), torch.from_numpy(member),
        torch.from_numpy(states), torch.from_numpy(alive),
        step_rows or model_pm(name).torch_step_rows)
    return s.numpy(), a.numpy(), d


@pytest.mark.parametrize("name,B,start_k,kind", MODEL_CASES)
def test_batch_model_every_model_matches_plain(name, B, start_k, kind):
    args = model_case_tables(name, B, start_k, kind)
    got = batch_model_sweep(start_k, *args, model_pm(name).kernel_model,
                            _model_init(name))
    want = _model_plain(name, start_k, *args)
    assert got[2] == want[2]
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    if kind.startswith("dead+") and not name.startswith("mutex"):
        assert got[2] == start_k + int(kind[len("dead+"):])


_ref_model_sweeps = {}


def _ref_model_sweep(name, B):
    fn = _ref_model_sweeps.get((name, B))
    if fn is None:
        pm = _ref_pm(name)
        fn = _make_pallas_sweep(B, W, pm.state_width, K, pm.jax_step_rows,
                                interpret=True)
        _ref_model_sweeps[(name, B)] = fn
    return fn


def _jax_rows(name):
    """The JAX package's rows step of `name` as a torch rows step."""
    step = _ref_pm(name).jax_step_rows

    def rows(states, f, a0, a1):
        s, legal = step(states.numpy(), np.int32(f), np.int32(a0),
                        np.int32(a1))
        return (torch.from_numpy(np.array(s, dtype=np.int32)),
                torch.from_numpy(np.array(legal).astype(bool)))

    return rows


REF_CASES = [c for c in MODEL_CASES if c[0] != "register"
             and c[3] in ("death", "dead+31", "clean")]


@pytest.mark.parametrize("name,B,start_k,kind", REF_CASES)
def test_every_model_matches_the_reference_sweep(name, B, start_k, kind):
    """The numpy model of the kernel and the plain sweep against the JAX
    package: its Pallas kernel in interpret mode for the plain
    instantiations at B = 8 (one compile per model), the plain sweep
    over its rows step otherwise (the stream ones cannot run there)."""
    args = model_case_tables(name, B, start_k, kind)
    if model_pm(name).stream or B != 8:
        want = _model_plain(name, start_k, *args, step_rows=_jax_rows(name))
    else:
        want = _ref_model_sweep(name, B)(start_k, *args)
    got_plain = _model_plain(name, start_k, *args)
    got_model = batch_model_sweep(start_k, *args, model_pm(name).kernel_model,
                                  _model_init(name))
    for got in (got_plain, got_model):
        assert got[2] == int(want[2])
        assert np.array_equal(got[0], np.asarray(want[0]))
        assert np.array_equal(got[1], np.asarray(want[1]))
