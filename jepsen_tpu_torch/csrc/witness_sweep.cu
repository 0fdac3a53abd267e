// Witness easy-path barrier sweep, hand-written for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel jepsen_tpu/ops/wgl_witness.py
// _make_pallas_sweep (inner `kernel`).  It computes the same function:
// starting at barrier `start`, walk one block's K barriers in order.  At
// barrier k, a beam lane whose member bit for window column bars[0][k] is
// set passes; any other alive lane applies the barrier op (f, a0, a1) to
// its model state and survives iff the step is legal.  At a REAL barrier
// (bars[2][k] != 0) that leaves no lane alive, stop: death = k, and the
// states and alive mask are those from just before k (the host then runs
// the chain search at k and resumes at k + 1).  Otherwise death = K.
// Padding barriers (real == 0) commit nothing and never die.
//
// Models (PackedModel.kernel_model ids; each a compile-time instantiation
// at a state width SW): register and cas-register (SW 1), mutex (SW 1),
// multi-register (its real width sw in [1, 32], compiled at the bucket
// SW = 2, 4, 8, 16 or 32; only the sw real columns are loaded and
// stored), FIFO queue and unordered queue (SW 32, 0 = an empty slot).
// Every step is written as selects over compile-time slots, so no state
// array is indexed at run time; wider multi-register states take the
// wide instantiation (below).  The stream instantiations (STREAM) also
// know the many-key stream's RESET op (f == F_RESET, as in
// jepsen_tpu/ops/wgl_stream.py): always legal, it sets the state to the
// initial state passed in `init`.  The others never test for it.
//
// Layout (all contiguous, as the port holds them):
//   bars        (6, K)  int32  rows: window column, ret, real, f, a0, a1
//   member      (W, B)  bool   one byte per beam lane, any B >= 1
//   states_in   (B, sw) int32
//   alive_in    (B,)    bool
//   init        (sw,)   int32  (stream instantiations only)
//   states_out  (B, sw) int32, alive_out (B,) bool,
//   death_out   (B,)    int32  one death per lane group, G = ceil(B / L)
//                              of them, L the lanes a block sweeps; [0]
//                              is the sweep's death
// death_out[0] is -1 if a block's two warps lost their hand-off (a
// fault; the caller raises).
//
// Beams of any width.  The lanes are independent but for the death test,
// so each group of L lanes (32, or fewer for a wide state: below) sweeps
// in a block of its own, G = ceil(B / L) blocks, exactly as one block
// sweeps a beam of <= L, and writes its own death.  A second small kernel
// joins the G groups: the joint sweep dies at the latest group death (the
// first real barrier no lane of any group survives).  A group that died
// earlier has no lane alive from its death on, so nothing of it changes
// after it: its states are the ones it returned and its alive mask is all
// false.  Every block runs both warps in full, whatever its lane count:
// the lanes past the group are never alive, so each vote and ballot is
// over the whole warp and a lane outside the group adds nothing to it.
//
// Wide states (the multi-register past 32 registers, any sw).  The state
// no longer fits registers: each lane's row lives in dynamic shared
// memory, column-major (word j of lane b at j * Bg + b, Bg the block's
// lanes, so the lanes' loads of one register fall in distinct banks),
// Bg * sw * 4 bytes beside the kernel's static rings (11,920 bytes as
// ptxas counts them).  The block's lanes L shrink as sw grows, so that
// L rows fit its 227 KB: 32 lanes up to 1,722 words, one lane up to
// 55,132.  A row wider than that stays in global memory, in states_out
// (copied from states_in first), with 32 lanes a block.  A register
// step touches one word, so the lane reads and writes that word in
// place.  The batch needs no rewind copy: at the death barrier every
// alive lane stepped illegally (a lane that stays survives), which
// commits nothing, and after it no lane is alive to commit, so the state
// after the batch's speculative pass is the state before the death; only
// the alive mask is rewound, from the lane's alive count.
//
// What bounds it on this card: not bytes (about 20 B per barrier: five
// bars words and a member row; the ret row is never read) but a chain of
// dependent register steps in each beam lane -- barrier k's state needs
// barrier k - 1's.  Only the B beam lanes are parallel.  The design keeps
// everything but that chain off the sweeping warp:
//
// - Per-lane speculation.  A lane's state and alive bit evolve on their
//   own; the lanes couple only through the death test ("no lane alive
//   after a real barrier"), and alive never comes back once lost.  So
//   each lane sweeps a batch of T = 32 barriers alone, in registers, and
//   one __reduce_or_sync of the lanes' alive masks per batch finds the
//   first real barrier no lane survived; if there is one, every lane
//   rewinds to its batch-start state and replays the barriers before it.
//   No warp vote sits on the per-barrier chain.
// - Two warps.  Fetching and packing a batch costs about as much as
//   sweeping it, and one warp cannot overlap the two (the sweep is one
//   dependent chain), so warp 1 produces and warp 0 sweeps.  Warp 1, lane
//   j owning barrier k + j: loads the barrier's five bars words
//   (coalesced) one batch ahead, copies its member row (B bytes at the
//   window column) into a ring of staging slots with cp.async, AHEAD = 3
//   batches ahead (a gather of rows by index is a per-thread copy, which
//   cp.async takes and a TMA tile copy does not), packs the landed row
//   into one 32-bit word (bit b = beam lane b), and writes the batch into
//   a ring of records: the ops, and per beam lane its "stays" bits (the
//   packed words transposed by ballots, or'ed with the padding barriers).
//   Acquire/release counters hand records over; every wait is bounded.
// - Operands in registers.  Warp 0 reads the next record into registers
//   at the end of each batch, so no shared-memory load sits on the chain,
//   and counts the barriers each lane is alive after instead of building
//   its mask bit by bit.  From SW = 16 on the state copies need those
//   registers, and the ops are read from the record in shared memory
//   instead: one broadcast load per barrier, beside a step of 16-32
//   selects; that pass is unrolled 2 steps at a time, not 32.
// - Nothing to pack on the host side: the kernel reads the (W, B) bool
//   window, (B, sw) states and bool alive directly, so a sweep call is
//   this launch plus the caller's read of `death`.
//
// witness_sweep_chain_probe times the floor every design pays: one
// lane's dependent chain of the register step, with its operands in
// registers, no loads and no vote.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// PackedModel.kernel_model ids (jepsen_tpu_torch/models/).
constexpr int MODEL_REGISTER = 1;
constexpr int MODEL_MUTEX = 2;
constexpr int MODEL_MULTI_REGISTER = 3;
constexpr int MODEL_FIFO_QUEUE = 4;
constexpr int MODEL_UNORDERED_QUEUE = 5;

// Op codes: register family (models/registers.py F_WRITE, F_CAS), mutex
// (models/mutex.py F_ACQUIRE), queues (models/collections.py F_ENQ), and
// the stream's RESET (ops/wgl_stream.py F_RESET).
constexpr int32_t F_WRITE = 1;
constexpr int32_t F_CAS = 2;
constexpr int32_t F_ACQUIRE = 0;
constexpr int32_t F_ENQ = 0;
constexpr int32_t F_RESET = 1 << 20;

constexpr int QUEUE_CAPACITY = 32;  // slots of the packed queues
constexpr int MAX_SW = 32;

constexpr unsigned FULL = 0xffffffffu;
constexpr int T = 32;            // barriers per batch: one per lane
constexpr int AHEAD = 3;         // member-row batches in flight (producer)
constexpr int STAGES = AHEAD + 1;
constexpr int RECORDS = 8;       // ring of packed batches between the warps
constexpr int SPIN_LIMIT = 1 << 22;  // a wait longer than this is a fault

// A batch as the sweeping warp reads it: per barrier i its op {f, a0,
// a1}, per beam lane b the bits of the barriers it stays at (padding, or
// its member bit set), and the real barriers.
struct Record {
  int4 op[T];
  uint32_t stay[T];
  uint32_t real;
};

// The producing warp's staging of one batch: lane j's barrier words and
// member row (NW 4-byte words cover Bg <= 4 * (NW - 1) bytes at any byte
// offset, Bg the block's beam lanes).  Only lane j touches its part.
template <int NW>
struct Stage {
  int4 op[T];           // {row byte offset | real << 2, f, a0, a1}
  uint32_t raw[T][NW];  // member row bytes as cp.async landed them
};

// The register transition of models/registers.py (the reference's
// registers.py:166-186): reads and cas must see a0; writes always succeed.
__device__ __forceinline__ bool register_step(int32_t s, int32_t f,
                                              int32_t a0, int32_t a1,
                                              int32_t* next) {
  const bool is_write = f == F_WRITE;
  const bool is_cas = f == F_CAS;
  *next = is_write ? a0 : (is_cas ? a1 : s);
  return is_write | (s == a0);
}

// The model transitions of jepsen_tpu_torch/models/ (the reference's
// jax_step_rows: registers.py:176 and :301, mutex.py:70, collections.py
// :197 and :224).  `next` matters only where the step is legal: an
// illegal step commits nothing.
template <int MODEL, int SW>
__device__ __forceinline__ bool model_step(const int32_t (&s)[SW],
                                           int32_t (&next)[SW], int32_t f,
                                           int32_t a0, int32_t a1) {
  if constexpr (MODEL == MODEL_REGISTER) {
    static_assert(SW == 1, "the register has one word of state");
    return register_step(s[0], f, a0, a1, &next[0]);
  } else if constexpr (MODEL == MODEL_MUTEX) {
    // Acquire is legal iff the lock is free; any other f releases, legal
    // iff it is held.
    static_assert(SW == 1, "the mutex has one word of state");
    const bool is_acq = f == F_ACQUIRE;
    next[0] = is_acq ? 1 : 0;
    return is_acq ? s[0] == 0 : s[0] == 1;
  } else if constexpr (MODEL == MODEL_MULTI_REGISTER) {
    // a0 is the register index, already -1 (no register) where it lies
    // outside the real width (the producer clears it): a read is legal
    // iff s[a0] == a1, a write sets s[a0] = a1.
    const bool is_write = f == F_WRITE;
    int32_t cur = 0;
#pragma unroll
    for (int j = 0; j < SW; ++j) cur |= j == a0 ? s[j] : 0;
#pragma unroll
    for (int j = 0; j < SW; ++j) next[j] = is_write & (j == a0) ? a1 : s[j];
    return is_write | (cur == a1);
  } else if constexpr (MODEL == MODEL_FIFO_QUEUE) {
    // Left-aligned slots; the length is the count of nonzero slots.
    // Enqueue writes slot `length` (legal iff there is room); dequeue is
    // legal iff the head holds a0 != 0, and shifts the slots by one.
    static_assert(SW == QUEUE_CAPACITY, "queue state is its slots");
    uint32_t used = 0;
#pragma unroll
    for (int j = 0; j < SW; ++j) used |= static_cast<uint32_t>(s[j] != 0) << j;
    const int length = __popc(used);
    const bool is_enq = f == F_ENQ;
#pragma unroll
    for (int j = 0; j < SW; ++j) {
      const int32_t shifted = j + 1 < SW ? s[j + 1] : 0;
      next[j] = is_enq ? (j == length ? a0 : s[j]) : shifted;
    }
    return is_enq ? length < SW : (s[0] == a0) & (a0 != 0);
  } else {
    // Unordered: enqueue fills the first empty slot (legal iff there is
    // one); dequeue clears the first slot holding a0 (legal iff there is
    // one).  The slots are not kept sorted, as collections.py:224.
    static_assert(MODEL == MODEL_UNORDERED_QUEUE, "no such model");
    static_assert(SW == QUEUE_CAPACITY, "queue state is its slots");
    uint32_t empty = 0;
    uint32_t match = 0;
#pragma unroll
    for (int j = 0; j < SW; ++j) {
      empty |= static_cast<uint32_t>(s[j] == 0) << j;
      match |= static_cast<uint32_t>(s[j] == a0) << j;
    }
    const bool is_enq = f == F_ENQ;
    const uint32_t cand = is_enq ? empty : match;
    const uint32_t pick = cand & (0u - cand);  // its lowest slot
    const int32_t put = is_enq ? a0 : 0;
#pragma unroll
    for (int j = 0; j < SW; ++j) next[j] = (pick >> j) & 1u ? put : s[j];
    return cand != 0u;
  }
}

// One beam lane at one barrier, op = {f, a0, a1}.  A lane that stays
// keeps its state and alive; otherwise an alive lane steps the model,
// commits the step if it is legal and dies if not.  Returns alive after
// the barrier.  Written in bools so the chain is compare -> predicate op
// -> select.  A stream instantiation maps RESET to `init`, always legal.
template <int MODEL, int SW, bool STREAM>
__device__ __forceinline__ bool lane_step(int32_t (&st)[SW], bool alive,
                                          const int4 op, bool stay,
                                          const int32_t (&init)[SW]) {
  int32_t nx[SW];
  bool legal = model_step<MODEL, SW>(st, nx, op.x, op.y, op.z);
  if constexpr (STREAM) {
    const bool reset = op.x == F_RESET;
#pragma unroll
    for (int j = 0; j < SW; ++j) nx[j] = reset ? init[j] : nx[j];
    legal |= reset;
  }
  const bool take = alive & !stay & legal;
#pragma unroll
  for (int j = 0; j < SW; ++j) st[j] = take ? nx[j] : st[j];
  return alive & (stay | legal);
}

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n"
               : "=r"(v) : "r"(smem(p)) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;\n"
               :: "r"(smem(p)), "r"(v) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The bars words of one barrier (the ret row is not read); a barrier
// past K is padding.
struct Bar {
  int32_t col, real, f, a0, a1;
};

__device__ __forceinline__ Bar load_bar(const int32_t* __restrict__ bars,
                                        int K, int k) {
  Bar b = {0, 0, 0, 0, 0};
  if (k < K) {
    b.col = __ldg(bars + k);
    b.real = __ldg(bars + 2 * K + k) != 0 ? 1 : 0;
    b.f = __ldg(bars + 3 * K + k);
    b.a0 = __ldg(bars + 4 * K + k);
    b.a1 = __ldg(bars + 5 * K + k);
  }
  return b;
}

// Lane j stages barrier j: its words, and the NW aligned words from the
// first byte of its member row's part for this block's lanes (Bg bytes
// at lane0 of a row of B) on.  Words past that part or the window's end
// copy no bytes (cp.async zero-fills them), so every lane issues the same
// NW copies with no branch, and commits one group per batch.
template <int NW>
__device__ __forceinline__ void stage_batch(Stage<NW>& sg, const Bar& b,
                                            const uint8_t* __restrict__ member,
                                            int B, int lane0, int Bg,
                                            int64_t member_bytes, int lane) {
  const int64_t lo = static_cast<int64_t>(b.col) * B + lane0;
  sg.op[lane] = make_int4(static_cast<int>(lo & 3) | (b.real << 2), b.f,
                          b.a0, b.a1);
  const int64_t end = lo + Bg;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int64_t at = (lo & ~int64_t{3}) + 4 * w;
    const bool need = at < end;
    const int64_t left = member_bytes - at;
    cp_async4(&sg.raw[lane][w], need ? member + at : member,
              need ? (left < 4 ? static_cast<int>(left) : 4) : 0);
  }
  cp_async_commit();
}

// Lane j's landed member row packed into one word: bit b = the block's
// beam lane b.
// Four row bytes at a time: the funnel shift aligns them, bit 7 of each
// byte of `nz` is set iff the byte is nonzero, and the multiply gathers
// the four flags into the top nibble.
template <int NW>
__device__ __forceinline__ uint32_t pack_row(const Stage<NW>& sg,
                                             unsigned offset, int Bg,
                                             int lane) {
  const uint32_t* raw = sg.raw[lane];
  uint32_t word = 0;
#pragma unroll
  for (int q = 0; q + 1 < NW; ++q) {
    const uint32_t v = __funnelshift_r(raw[q], raw[q + 1], 8u * offset);
    const uint32_t nz = (((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) & 0x80808080u;
    word |= (((nz >> 7) * 0x10204080u) >> 28) << (4 * q);
  }
  return word & ((2u << (Bg - 1)) - 1u);  // bytes past the block's part
}

struct Shared {
  int produced;  // records written (release by the producer)
  int consumed;  // records swept (release by the sweeper)
  int stop;      // the sweeper is done: the producer stops
};

// Warp 1: fetches batch after batch and writes it into the record ring
// as the sweeping warp reads it.  For the multi-register it clears an a0
// outside the real width sw to -1, so the step's selects over the bucket
// never reach a padding column.
template <int MODEL, int NW>
__device__ void produce(Record* ring, Stage<NW>* stages, Shared& sh, int B,
                        int lane0, int Bg, int K, int W, int sw, int start,
                        int batches, const int32_t* __restrict__ bars,
                        const uint8_t* __restrict__ member, int lane) {
  const int64_t member_bytes = static_cast<int64_t>(W) * B;
  Bar pro[AHEAD + 1];
#pragma unroll
  for (int p = 0; p <= AHEAD; ++p) {
    pro[p] = load_bar(bars, K, start + p * T + lane);
  }
#pragma unroll
  for (int p = 0; p < AHEAD; ++p) {
    stage_batch(stages[p], pro[p], member, B, lane0, Bg, member_bytes,
                lane);
  }
  Bar next = pro[AHEAD];
  for (int m = 0; m < batches; ++m) {
    const int k = start + m * T;
    stage_batch(stages[(m + AHEAD) % STAGES], next, member, B, lane0, Bg,
                member_bytes, lane);
    next = load_bar(bars, K, k + (AHEAD + 1) * T + lane);
    cp_async_wait<AHEAD>();  // this lane's row of batch m has landed
    const Stage<NW>& sg = stages[m % STAGES];
    const int4 op = sg.op[lane];
    const uint32_t word = pack_row(sg, op.x & 3, Bg, lane);
    const uint32_t real = __ballot_sync(FULL, (op.x >> 2) & 1);
    // Transpose: lane b gets bit j = "lane b has barrier j".
    uint32_t has = 0;
#pragma unroll
    for (int b = 0; b < 4 * (NW - 1); ++b) {
      const uint32_t r = __ballot_sync(FULL, (word >> b) & 1u);
      has = lane == b ? r : has;
    }
    int32_t a0 = op.z;
    if constexpr (MODEL == MODEL_MULTI_REGISTER) {
      a0 = static_cast<unsigned>(a0) < static_cast<unsigned>(sw) ? a0 : -1;
    }
    // Room in the ring (the sweeper is at most RECORDS behind); stop
    // once the sweeper has.  Each lane acquires before it writes the
    // ring; the votes keep the decision the same in every lane.
    int spins = 0;
    bool stopped = __any_sync(FULL, load_acquire(&sh.stop) != 0);
    while (!stopped &&
           !__all_sync(FULL, m - load_acquire(&sh.consumed) < RECORDS)) {
      stopped = __any_sync(FULL, load_acquire(&sh.stop) != 0) ||
                ++spins > SPIN_LIMIT;
    }
    if (stopped) break;
    Record& rec = ring[m % RECORDS];
    rec.op[lane] = make_int4(op.y, a0, op.w, 0);
    rec.stay[lane] = ~real | has;
    if (lane == 0) rec.real = real;
    __syncwarp();
    if (lane == 0) store_release(&sh.produced, m + 1);
  }
  cp_async_wait_all();
}

// The widest state whose instantiations keep a batch's ops in registers
// (see the header).
constexpr int OPS_IN_REGISTERS_MAX_SW = 8;

// The sweeping warp's copy of one record: the ops in registers (REGS),
// and this lane's stay bits.
template <bool REGS>
struct Batch {
  int4 op[T];
  uint32_t stay;
  uint32_t real;
  __device__ __forceinline__ int4 at(const Record&, int i) const {
    return op[i];
  }
};

template <>
struct Batch<false> {
  uint32_t stay;
  uint32_t real;
  __device__ __forceinline__ int4 at(const Record& rec, int i) const {
    return rec.op[i];
  }
};

// Waits until the producer has written record n, then reads it into
// registers.  Every lane acquires the release it reads the ring after;
// the vote only keeps the warp's loop uniform.  Returns false if it never
// comes (a fault).
template <bool REGS>
__device__ __forceinline__ bool fetch_record(const Record* ring, Shared& sh,
                                             int n, int lane,
                                             Batch<REGS>& bt) {
  int spins = 0;
  while (!__all_sync(FULL, load_acquire(&sh.produced) > n)) {
    if (++spins > SPIN_LIMIT) return false;
  }
  const Record& rec = ring[n % RECORDS];
  if constexpr (REGS) {
#pragma unroll
    for (int i = 0; i < T; ++i) bt.op[i] = rec.op[i];
  }
  bt.stay = rec.stay[lane];
  bt.real = rec.real;
  return true;
}

// One lane's speculative pass over a batch -> the number of barriers it
// is alive after (alive never comes back, so they form a prefix of the
// batch: the count gives its alive mask).  With the ops in registers the
// pass is unrolled in full (a register array needs compile-time
// indices); otherwise UNROLL steps at a time, since 32 steps of 16-32
// selects each unrolled in full outgrow the instruction cache.
template <int MODEL, int SW, bool STREAM, int UNROLL, bool REGS>
__device__ __forceinline__ int sweep_batch(int32_t (&st)[SW], bool& alive,
                                           const Batch<REGS>& bt,
                                           const Record& rec,
                                           const int32_t (&init)[SW]) {
  int alive_after = 0;
#pragma unroll UNROLL
  for (int i = 0; i < T; ++i) {
    alive = lane_step<MODEL, SW, STREAM>(st, alive, bt.at(rec, i),
                                         (bt.stay >> i) & 1u, init);
    alive_after += alive;
  }
  return alive_after;
}

// Warp 0: lane = beam lane.  Sweeps each record speculatively (from
// registers where the ops are kept there: the next record is read at the
// end of the previous iteration, so no shared load sits on the chain) and
// votes once per batch.  Returns the death barrier, K, or -1 if the
// producer never delivered (a fault).
template <int MODEL, int SW, bool STREAM>
__device__ int sweep_records(const Record* ring, Shared& sh, int K,
                             int start, int batches, int32_t (&st)[SW],
                             bool& alive, const int32_t (&init)[SW],
                             int lane) {
  constexpr bool REGS = SW <= OPS_IN_REGISTERS_MAX_SW;
  Batch<REGS> bt;
  if (batches > 0 && !fetch_record(ring, sh, 0, lane, bt)) return -1;
  for (int n = 0, k = start; n < batches; ++n, k += T) {
    const Record& rec = ring[n % RECORDS];
    int32_t st0[SW];
#pragma unroll
    for (int j = 0; j < SW; ++j) st0[j] = st[j];
    const bool alive0 = alive;
    const int alive_after = sweep_batch<MODEL, SW, STREAM, REGS ? T : 2>(
        st, alive, bt, rec, init);
    const uint32_t mask =
        alive_after == T ? FULL : (1u << alive_after) - 1u;
    // One vote per batch: the real barriers no lane survived.
    const uint32_t dead = ~__reduce_or_sync(FULL, mask) & bt.real;
    if (dead != 0u) {
      // Rewind and replay up to the death, from the record (still in the
      // ring: it is released only after this batch).
      const int d = __ffs(static_cast<int>(dead)) - 1;
#pragma unroll
      for (int j = 0; j < SW; ++j) st[j] = st0[j];
      alive = alive0;
      for (int i = 0; i < d; ++i) {
        alive = lane_step<MODEL, SW, STREAM>(st, alive, rec.op[i],
                                             (bt.stay >> i) & 1u, init);
      }
      return k + d;
    }
    __syncwarp();
    if (lane == 0) store_release(&sh.consumed, n + 1);
    if (n + 1 < batches && !fetch_record(ring, sh, n + 1, lane, bt)) {
      return -1;
    }
  }
  return K;
}

// The block's lane group: beam lanes [lane0, lane0 + Bg) of B, L lanes
// a block.
struct Group {
  int lane0, Bg;
};

__device__ __forceinline__ Group block_group(int B, int L) {
  const int lane0 = static_cast<int>(blockIdx.x) * L;
  return {lane0, min(L, B - lane0)};
}

template <int MODEL, int SW, int NW, bool STREAM>
__global__ void __launch_bounds__(64)
witness_sweep_kernel(int B, int L, int K, int W, int sw, int start,
                     const int32_t* __restrict__ bars,
                     const uint8_t* __restrict__ member,
                     const int32_t* __restrict__ states_in,
                     const uint8_t* __restrict__ alive_in,
                     const int32_t* __restrict__ init_in,
                     int32_t* __restrict__ states_out,
                     uint8_t* __restrict__ alive_out,
                     int32_t* __restrict__ death_out) {
  __shared__ Record ring[RECORDS];
  __shared__ Stage<NW> stages[STAGES];
  __shared__ Shared sh;
  const int lane = threadIdx.x & 31;
  const Group g = block_group(B, L);
  const int batches = (K - start + T - 1) / T;
  if (threadIdx.x == 0) {
    sh.produced = 0;
    sh.consumed = 0;
    sh.stop = 0;
  }
  __syncthreads();
  if (threadIdx.x >= 32) {
    produce<MODEL, NW>(ring, stages, sh, B, g.lane0, g.Bg, K, W, sw, start,
                       batches, bars, member, lane);
    return;
  }
  // Only the sw real columns are read and written; the bucket's padding
  // columns stay 0, and no step reaches them.
  const bool in_beam = lane < g.Bg;
  const int64_t row = g.lane0 + lane;
  int32_t st[SW];
  int32_t init[SW];
#pragma unroll
  for (int j = 0; j < SW; ++j) {
    st[j] = in_beam && j < sw ? states_in[row * sw + j] : 0;
    init[j] = STREAM && j < sw ? init_in[j] : 0;
  }
  bool alive = in_beam && alive_in[row] != 0;
  const int death = sweep_records<MODEL, SW, STREAM>(
      ring, sh, K, start, batches, st, alive, init, lane);
  if (lane == 0) store_release(&sh.stop, 1);
  if (in_beam) {
#pragma unroll
    for (int j = 0; j < SW; ++j) {
      if (j < sw) states_out[row * sw + j] = st[j];
    }
    alive_out[row] = alive ? 1 : 0;
  }
  if (lane == 0) death_out[blockIdx.x] = death;
}

// The multi-register step on a lane's state row in shared memory (word j
// at st[j * stride]); a0 is already -1 outside the real width.  The same
// transition as model_step<MODEL_MULTI_REGISTER> and lane_step: a read is
// legal iff the register holds a1, a write sets it, a stream RESET copies
// `init` (global memory: it is rare) and is always legal.
template <bool STREAM>
__device__ __forceinline__ bool wide_lane_step(int32_t* st, int stride,
                                               int sw, bool alive,
                                               const int4 op, bool stay,
                                               const int32_t* init) {
  const bool is_write = op.x == F_WRITE;
  const bool reset = STREAM && op.x == F_RESET;
  const int a0 = op.y;
  const int32_t cur = a0 >= 0 ? st[a0 * stride] : 0;
  const bool legal = is_write | (cur == op.z) | reset;
  if (alive & !stay & legal) {
    if (reset) {
      for (int j = 0; j < sw; ++j) st[j * stride] = __ldg(init + j);
    } else if (is_write & (a0 >= 0)) {
      st[a0 * stride] = op.z;
    }
  }
  return alive & (stay | legal);
}

// Warp 0 of the wide instantiation: sweep_records with the state in
// shared memory, and no rewind copy (see the header): on a death only
// the alive mask goes back, to the lane's alive count.
template <bool STREAM>
__device__ int sweep_records_wide(const Record* ring, Shared& sh, int K,
                                  int start, int batches, int32_t* st,
                                  int stride, int sw, bool& alive,
                                  const int32_t* init, int lane) {
  Batch<false> bt;
  if (batches > 0 && !fetch_record(ring, sh, 0, lane, bt)) return -1;
  for (int n = 0, k = start; n < batches; ++n, k += T) {
    const Record& rec = ring[n % RECORDS];
    const bool alive0 = alive;
    int alive_after = 0;
#pragma unroll 2
    for (int i = 0; i < T; ++i) {
      alive = wide_lane_step<STREAM>(st, stride, sw, alive, rec.op[i],
                                     (bt.stay >> i) & 1u, init);
      alive_after += alive;
    }
    const uint32_t mask =
        alive_after == T ? FULL : (1u << alive_after) - 1u;
    const uint32_t dead = ~__reduce_or_sync(FULL, mask) & bt.real;
    if (dead != 0u) {
      const int d = __ffs(static_cast<int>(dead)) - 1;
      alive = d == 0 ? alive0 : alive_after >= d;
      return k + d;
    }
    __syncwarp();
    if (lane == 0) store_release(&sh.consumed, n + 1);
    if (n + 1 < batches && !fetch_record(ring, sh, n + 1, lane, bt)) {
      return -1;
    }
  }
  return K;
}

// The multi-register at a run-time width sw > 32: the state rows in
// dynamic shared memory (Bg * sw int32), or, with `rows_global`, in
// states_out; the producer as for the register-resident instantiations.
template <bool STREAM>
__global__ void __launch_bounds__(64)
witness_sweep_wide_kernel(int B, int L, int rows_global, int K, int W,
                          int sw, int start,
                          const int32_t* __restrict__ bars,
                          const uint8_t* __restrict__ member,
                          const int32_t* __restrict__ states_in,
                          const uint8_t* __restrict__ alive_in,
                          const int32_t* __restrict__ init_in,
                          int32_t* __restrict__ states_out,
                          uint8_t* __restrict__ alive_out,
                          int32_t* __restrict__ death_out) {
  extern __shared__ int32_t wide_states[];
  __shared__ Record ring[RECORDS];
  __shared__ Stage<9> stages[STAGES];
  __shared__ Shared sh;
  const int lane = threadIdx.x & 31;
  const Group g = block_group(B, L);
  const int batches = (K - start + T - 1) / T;
  if (threadIdx.x == 0) {
    sh.produced = 0;
    sh.consumed = 0;
    sh.stop = 0;
  }
  __syncthreads();
  if (threadIdx.x >= 32) {
    produce<MODEL_MULTI_REGISTER, 9>(ring, stages, sh, B, g.lane0, g.Bg, K,
                                     W, sw, start, batches, bars, member,
                                     lane);
    return;
  }
  // A lane outside the beam is never alive, so it never writes; it reads
  // lane 0's row and ignores what it reads.
  const bool in_beam = lane < g.Bg;
  const int64_t row = g.lane0 + lane;
  int32_t* st;
  int stride;
  if (rows_global) {
    st = states_out + (in_beam ? row : g.lane0) * sw;
    stride = 1;
    if (in_beam) {
      for (int j = 0; j < sw; ++j) st[j] = states_in[row * sw + j];
    }
  } else {
    st = wide_states + (in_beam ? lane : 0);
    stride = g.Bg;
    if (in_beam) {
      for (int j = 0; j < sw; ++j) st[j * stride] = states_in[row * sw + j];
    }
  }
  __syncwarp();
  bool alive = in_beam && alive_in[row] != 0;
  const int death = sweep_records_wide<STREAM>(
      ring, sh, K, start, batches, st, stride, sw, alive, init_in, lane);
  if (lane == 0) store_release(&sh.stop, 1);
  if (in_beam) {
    if (!rows_global) {
      for (int j = 0; j < sw; ++j) states_out[row * sw + j] = st[j * stride];
    }
    alive_out[row] = alive ? 1 : 0;
  }
  if (lane == 0) death_out[blockIdx.x] = death;
}

// Joins the G lane groups (L lanes each) of a beam that spans more than
// one block: the sweep's death is the latest group death (-1 if any
// faulted), and a group that died before it leaves every lane dead, its
// states as it left them.  One block; every thread reads the deaths it
// needs before the barrier, and death_out[0] is written after it.
__global__ void __launch_bounds__(256)
combine_groups_kernel(int B, int L, int G, int32_t* __restrict__ death_out,
                      uint8_t* __restrict__ alive_out) {
  int d = death_out[0];
  for (int i = 1; i < G; ++i) {
    const int di = death_out[i];
    d = d < 0 || di < 0 ? -1 : max(d, di);
  }
  if (d >= 0) {
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      if (death_out[b / L] < d) alive_out[b] = 0;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) death_out[0] = d;
}

// The per-lane chain with no loads in the loop and no vote: `steps`
// dependent register lane_steps (state k needs state k - 1) over 16 ops
// {f, a0, a1, member word} read into registers before the loop.  Writes
// each lane's state and alive so nothing is dead code.
constexpr int PROBE_OPS = 16;

__global__ void __launch_bounds__(32)
chain_probe_kernel(int steps, const int4* __restrict__ ops,
                   int32_t* __restrict__ out) {
  const int lane = threadIdx.x;
  int4 op[PROBE_OPS];
  bool stay[PROBE_OPS];
#pragma unroll
  for (int j = 0; j < PROBE_OPS; ++j) {
    op[j] = ops[j];
    stay[j] = (static_cast<uint32_t>(op[j].w) >> lane) & 1u;
  }
  int32_t st[1] = {lane & 3};
  const int32_t no_init[1] = {0};
  bool alive = true;
  for (int k = 0; k < steps; k += PROBE_OPS) {
#pragma unroll
    for (int j = 0; j < PROBE_OPS; ++j) {
      alive = lane_step<MODEL_REGISTER, 1, false>(st, alive, op[j], stay[j],
                                                  no_init);
    }
  }
  out[lane] = st[0] + (alive ? 1 : 0);
}

// The launch's arguments, as the C interface takes them; the launch sets
// L (lanes a block) and rows_global.
struct Args {
  int B, L, rows_global, K, W, sw, start;
  const void* bars;
  const void* member;
  const void* states_in;
  const void* alive_in;
  const void* init;
  void* states_out;
  void* alive_out;
  void* death_out;
  cudaStream_t stream;
};

// Shared memory a block may use on Hopper (227 KB); the wide
// instantiation's dynamic part is what its rings leave of it.
constexpr int MAX_BLOCK_SMEM = 232448;

#define JT_SWEEP_ARGS                                                       \
  a.K, a.W, a.sw, a.start, static_cast<const int32_t*>(a.bars),             \
      static_cast<const uint8_t*>(a.member),                               \
      static_cast<const int32_t*>(a.states_in),                            \
      static_cast<const uint8_t*>(a.alive_in),                             \
      static_cast<const int32_t*>(a.init),                                 \
      static_cast<int32_t*>(a.states_out),                                 \
      static_cast<uint8_t*>(a.alive_out), static_cast<int32_t*>(a.death_out)

inline int groups(const Args& a) { return (a.B + a.L - 1) / a.L; }

// A row of Bg bytes at any byte offset spans ceil((Bg + 3) / 4) words;
// the pack reads one word past its last group.  One block per 32 lanes.
template <int MODEL, int SW, bool STREAM>
cudaError_t launch(Args& a) {
  a.L = 32;
  a.rows_global = 0;
  if (a.B <= 8) {
    witness_sweep_kernel<MODEL, SW, 3, STREAM>
        <<<groups(a), 64, 0, a.stream>>>(a.B, a.L, JT_SWEEP_ARGS);
  } else {
    witness_sweep_kernel<MODEL, SW, 9, STREAM>
        <<<groups(a), 64, 0, a.stream>>>(a.B, a.L, JT_SWEEP_ARGS);
  }
  return cudaGetLastError();
}

// The lanes a block of the wide kernel sweeps at width sw, whose rows
// fill at most `room` bytes of shared memory: as many as fit, at most
// 32; 0 if one row does not fit (the rows then stay in global memory).
inline int wide_lanes(int sw, size_t room) {
  const size_t fit = room / (sizeof(int32_t) * static_cast<size_t>(sw));
  return fit < 32 ? static_cast<int>(fit) : 32;
}

// The wide multi-register: L lanes a block with their rows in shared
// memory beside the kernel's static rings, or 32 lanes a block with the
// rows in global memory where one row does not fit.
template <bool STREAM>
cudaError_t wide_layout(Args& a) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, witness_sweep_wide_kernel<STREAM>);
  if (err != cudaSuccess) return err;
  const int fit = wide_lanes(a.sw, MAX_BLOCK_SMEM - attr.sharedSizeBytes);
  a.rows_global = fit == 0;
  a.L = fit == 0 ? 32 : fit;
  return cudaSuccess;
}

template <bool STREAM>
cudaError_t launch_wide(Args& a) {
  const auto kernel = witness_sweep_wide_kernel<STREAM>;
  cudaError_t err = wide_layout<STREAM>(a);
  if (err != cudaSuccess) return err;
  const size_t lanes = a.B < a.L ? a.B : a.L;
  const size_t dyn = a.rows_global ? 0 : sizeof(int32_t) * lanes *
                                             static_cast<size_t>(a.sw);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dyn));
  if (err != cudaSuccess) return err;
  kernel<<<groups(a), 64, dyn, a.stream>>>(a.B, a.L, a.rows_global,
                                           JT_SWEEP_ARGS);
  return cudaGetLastError();
}

#undef JT_SWEEP_ARGS

// Launches the instantiation for (model, sw); cudaErrorInvalidValue,
// without launching, if there is none.
template <bool STREAM>
cudaError_t dispatch(int model, Args& a) {
  switch (model) {
    case MODEL_REGISTER:
      if (a.sw != 1) break;
      return launch<MODEL_REGISTER, 1, STREAM>(a);
    case MODEL_MUTEX:
      if (a.sw != 1) break;
      return launch<MODEL_MUTEX, 1, STREAM>(a);
    case MODEL_MULTI_REGISTER:
      if (a.sw < 1) break;
      if (a.sw <= 2) return launch<MODEL_MULTI_REGISTER, 2, STREAM>(a);
      if (a.sw <= 4) return launch<MODEL_MULTI_REGISTER, 4, STREAM>(a);
      if (a.sw <= 8) return launch<MODEL_MULTI_REGISTER, 8, STREAM>(a);
      if (a.sw <= 16) return launch<MODEL_MULTI_REGISTER, 16, STREAM>(a);
      if (a.sw <= MAX_SW) return launch<MODEL_MULTI_REGISTER, 32, STREAM>(a);
      return launch_wide<STREAM>(a);
    case MODEL_FIFO_QUEUE:
      if (a.sw != QUEUE_CAPACITY) break;
      return launch<MODEL_FIFO_QUEUE, QUEUE_CAPACITY, STREAM>(a);
    case MODEL_UNORDERED_QUEUE:
      if (a.sw != QUEUE_CAPACITY) break;
      return launch<MODEL_UNORDERED_QUEUE, QUEUE_CAPACITY, STREAM>(a);
    default:
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches the sweep on `stream` and returns the launch's CUDA error (0
// on success).  `stream_model` != 0 selects the stream instantiation,
// which reads the (sw,) initial state at `init`.  `death_out` holds B
// int32 (one per lane group is used); where the beam spans G > 1 blocks
// a second kernel joins the groups into death_out[0].  `info` (3 host
// ints) receives the lanes a block swept, G, and 1 if the wide
// kernel's rows stayed in global memory.  A model with no instantiation
// at `sw`, a bad shape, a stream launch without `init`, or a member
// window that is not 4-byte aligned returns cudaErrorInvalidValue
// without launching.
int witness_sweep_launch(int model, int sw, int stream_model, int B, int K,
                         int W, int start, const void* bars,
                         const void* member, const void* states_in,
                         const void* alive_in, const void* init,
                         void* states_out, void* alive_out, void* death_out,
                         void* stream, int* info) {
  if (B < 1 || K < 1 || W < 1 || start < 0 || start > K ||
      reinterpret_cast<uintptr_t>(member) % 4 != 0 ||
      (stream_model != 0 && init == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.B = B;
  a.L = 32;
  a.rows_global = 0;
  a.K = K;
  a.W = W;
  a.sw = sw;
  a.start = start;
  a.bars = bars;
  a.member = member;
  a.states_in = states_in;
  a.alive_in = alive_in;
  a.init = init;
  a.states_out = states_out;
  a.alive_out = alive_out;
  a.death_out = death_out;
  a.stream = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      stream_model != 0 ? dispatch<true>(model, a) : dispatch<false>(model, a);
  const int G = groups(a);
  if (err == cudaSuccess && G > 1) {
    combine_groups_kernel<<<1, 256, 0, a.stream>>>(
        B, a.L, G, static_cast<int32_t*>(death_out),
        static_cast<uint8_t*>(alive_out));
    err = cudaGetLastError();
  }
  info[0] = a.L;
  info[1] = G;
  info[2] = a.rows_global;
  return static_cast<int>(err);
}

// The layout witness_sweep_launch gives a sweep of `model` at width `sw`
// over B lanes, without launching: info = {lanes a block, blocks, rows in
// global memory}.  Returns the CUDA error of reading the wide kernel's
// attributes (0 on success).
int witness_sweep_geometry(int model, int sw, int B, int* info) {
  if (B < 1 || sw < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.B = B;
  a.sw = sw;
  a.L = 32;
  a.rows_global = 0;
  if (model == MODEL_MULTI_REGISTER && sw > MAX_SW) {
    const cudaError_t err = wide_layout<false>(a);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  info[0] = a.L;
  info[1] = groups(a);
  info[2] = a.rows_global;
  return 0;
}

// Launches the per-lane chain probe (one warp, `steps` steps, a multiple
// of 16, over the 16 ops {f, a0, a1, member word} at `ops`) on `stream`;
// `out` holds 32 int32.  Returns cudaGetLastError().
int witness_sweep_chain_probe(int steps, const void* ops, void* out,
                              void* stream) {
  if (steps < 0 || steps % PROBE_OPS != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<const int4*>(ops), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* witness_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
