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
// array is indexed at run time.  The stream instantiations (STREAM) also
// know the many-key stream's RESET op (f == F_RESET, as in
// jepsen_tpu/ops/wgl_stream.py): always legal, it sets the state to the
// initial state passed in `init`.  The others never test for it.
//
// Layout (all contiguous, as the port holds them):
//   bars        (6, K)  int32  rows: window column, ret, real, f, a0, a1
//   member      (W, B)  bool   one byte per beam lane, B <= 32
//   states_in   (B, sw) int32
//   alive_in    (B,)    bool
//   init        (sw,)   int32  (stream instantiations only)
//   states_out  (B, sw) int32, alive_out (B,) bool, death_out (1,) int32
// death_out is -1 if the two warps lost their hand-off (a fault; the
// caller raises).
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
// member row (NW 4-byte words cover B <= 4 * (NW - 1) bytes at any byte
// offset).  Only lane j touches its part.
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

// Lane j stages barrier j: its words, and the NW aligned words from its
// member row's first byte on.  Words past the row or the window's end
// copy no bytes (cp.async zero-fills them), so every lane issues the same
// NW copies with no branch, and commits one group per batch.
template <int NW>
__device__ __forceinline__ void stage_batch(Stage<NW>& sg, const Bar& b,
                                            const uint8_t* __restrict__ member,
                                            int B, int64_t member_bytes,
                                            int lane) {
  const int64_t lo = static_cast<int64_t>(b.col) * B;  // row's first byte
  sg.op[lane] = make_int4(static_cast<int>(lo & 3) | (b.real << 2), b.f,
                          b.a0, b.a1);
  const int64_t end = lo + B;
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

// Lane j's landed member row packed into one word: bit b = beam lane b.
// Four row bytes at a time: the funnel shift aligns them, bit 7 of each
// byte of `nz` is set iff the byte is nonzero, and the multiply gathers
// the four flags into the top nibble.
template <int NW>
__device__ __forceinline__ uint32_t pack_row(const Stage<NW>& sg,
                                             unsigned offset, int B,
                                             int lane) {
  const uint32_t* raw = sg.raw[lane];
  uint32_t word = 0;
#pragma unroll
  for (int q = 0; q + 1 < NW; ++q) {
    const uint32_t v = __funnelshift_r(raw[q], raw[q + 1], 8u * offset);
    const uint32_t nz = (((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) & 0x80808080u;
    word |= (((nz >> 7) * 0x10204080u) >> 28) << (4 * q);
  }
  return word & ((2u << (B - 1)) - 1u);  // bytes past the row
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
                        int K, int W, int sw, int start, int batches,
                        const int32_t* __restrict__ bars,
                        const uint8_t* __restrict__ member, int lane) {
  const int64_t member_bytes = static_cast<int64_t>(W) * B;
  Bar pro[AHEAD + 1];
#pragma unroll
  for (int p = 0; p <= AHEAD; ++p) {
    pro[p] = load_bar(bars, K, start + p * T + lane);
  }
#pragma unroll
  for (int p = 0; p < AHEAD; ++p) {
    stage_batch(stages[p], pro[p], member, B, member_bytes, lane);
  }
  Bar next = pro[AHEAD];
  for (int m = 0; m < batches; ++m) {
    const int k = start + m * T;
    stage_batch(stages[(m + AHEAD) % STAGES], next, member, B, member_bytes,
                lane);
    next = load_bar(bars, K, k + (AHEAD + 1) * T + lane);
    cp_async_wait<AHEAD>();  // this lane's row of batch m has landed
    const Stage<NW>& sg = stages[m % STAGES];
    const int4 op = sg.op[lane];
    const uint32_t word = pack_row(sg, op.x & 3, B, lane);
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

template <int MODEL, int SW, int NW, bool STREAM>
__global__ void __launch_bounds__(64)
witness_sweep_kernel(int B, int K, int W, int sw, int start,
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
  const int batches = (K - start + T - 1) / T;
  if (threadIdx.x == 0) {
    sh.produced = 0;
    sh.consumed = 0;
    sh.stop = 0;
  }
  __syncthreads();
  if (threadIdx.x >= 32) {
    produce<MODEL, NW>(ring, stages, sh, B, K, W, sw, start, batches, bars,
                       member, lane);
    return;
  }
  // Only the sw real columns are read and written; the bucket's padding
  // columns stay 0, and no step reaches them.
  const bool in_beam = lane < B;
  int32_t st[SW];
  int32_t init[SW];
#pragma unroll
  for (int j = 0; j < SW; ++j) {
    st[j] = in_beam && j < sw ? states_in[lane * sw + j] : 0;
    init[j] = STREAM && j < sw ? init_in[j] : 0;
  }
  bool alive = in_beam && alive_in[lane] != 0;
  const int death = sweep_records<MODEL, SW, STREAM>(
      ring, sh, K, start, batches, st, alive, init, lane);
  if (lane == 0) store_release(&sh.stop, 1);
  if (in_beam) {
#pragma unroll
    for (int j = 0; j < SW; ++j) {
      if (j < sw) states_out[lane * sw + j] = st[j];
    }
    alive_out[lane] = alive ? 1 : 0;
  }
  if (lane == 0) death_out[0] = death;
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

// The launch's arguments, as the C interface takes them.
struct Args {
  int B, K, W, sw, start;
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

// A row of B bytes at any byte offset spans ceil((B + 3) / 4) words; the
// pack reads one word past its last group.
template <int MODEL, int SW, bool STREAM>
bool launch(const Args& a) {
#define JT_SWEEP_ARGS                                                       \
  a.B, a.K, a.W, a.sw, a.start, static_cast<const int32_t*>(a.bars),       \
      static_cast<const uint8_t*>(a.member),                               \
      static_cast<const int32_t*>(a.states_in),                            \
      static_cast<const uint8_t*>(a.alive_in),                             \
      static_cast<const int32_t*>(a.init),                                 \
      static_cast<int32_t*>(a.states_out),                                 \
      static_cast<uint8_t*>(a.alive_out), static_cast<int32_t*>(a.death_out)
  if (a.B <= 8) {
    witness_sweep_kernel<MODEL, SW, 3, STREAM><<<1, 64, 0, a.stream>>>(
        JT_SWEEP_ARGS);
  } else {
    witness_sweep_kernel<MODEL, SW, 9, STREAM><<<1, 64, 0, a.stream>>>(
        JT_SWEEP_ARGS);
  }
#undef JT_SWEEP_ARGS
  return true;
}

// Launches the instantiation for (model, sw); false if there is none.
template <bool STREAM>
bool dispatch(int model, const Args& a) {
  switch (model) {
    case MODEL_REGISTER:
      return a.sw == 1 && launch<MODEL_REGISTER, 1, STREAM>(a);
    case MODEL_MUTEX:
      return a.sw == 1 && launch<MODEL_MUTEX, 1, STREAM>(a);
    case MODEL_MULTI_REGISTER:
      if (a.sw < 1 || a.sw > MAX_SW) return false;
      if (a.sw <= 2) return launch<MODEL_MULTI_REGISTER, 2, STREAM>(a);
      if (a.sw <= 4) return launch<MODEL_MULTI_REGISTER, 4, STREAM>(a);
      if (a.sw <= 8) return launch<MODEL_MULTI_REGISTER, 8, STREAM>(a);
      if (a.sw <= 16) return launch<MODEL_MULTI_REGISTER, 16, STREAM>(a);
      return launch<MODEL_MULTI_REGISTER, 32, STREAM>(a);
    case MODEL_FIFO_QUEUE:
      return a.sw == QUEUE_CAPACITY &&
             launch<MODEL_FIFO_QUEUE, QUEUE_CAPACITY, STREAM>(a);
    case MODEL_UNORDERED_QUEUE:
      return a.sw == QUEUE_CAPACITY &&
             launch<MODEL_UNORDERED_QUEUE, QUEUE_CAPACITY, STREAM>(a);
    default:
      return false;
  }
}

}  // namespace

extern "C" {

// Launches the sweep on `stream` and returns cudaGetLastError() (0 on
// success).  `stream_model` != 0 selects the stream instantiation, which
// reads the (sw,) initial state at `init`.  A model with no instantiation
// at `sw`, a bad shape, a stream launch without `init`, or a member
// window that is not 4-byte aligned returns cudaErrorInvalidValue
// without launching.
int witness_sweep_launch(int model, int sw, int stream_model, int B, int K,
                         int W, int start, const void* bars,
                         const void* member, const void* states_in,
                         const void* alive_in, const void* init,
                         void* states_out, void* alive_out, void* death_out,
                         void* stream) {
  if (B < 1 || B > 32 || K < 1 || W < 1 || start < 0 || start > K ||
      reinterpret_cast<uintptr_t>(member) % 4 != 0 ||
      (stream_model != 0 && init == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.B = B;
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
  const bool launched =
      stream_model != 0 ? dispatch<true>(model, a) : dispatch<false>(model, a);
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
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
