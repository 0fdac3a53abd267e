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
// Padding barriers (real == 0) commit nothing.
//
// Layout (all int32, contiguous):
//   bars        (6, K)   rows: window column, ret, real, f, a0, a1
//   mbits       (W,)     member bits: lane b of the beam is bit b (B <= 32)
//   states_in   (SW, B)  lane-major beam states
//   alive_in    (B,)     0/1
//   states_out  (SW, B), alive_out (B,), death_out (1,)
//
// What bounds it on this card: not bytes -- it reads 24 B per barrier
// (five bars words and one member word; the ret row is not read) -- but
// the serial chain of K dependent barrier steps: whether barrier k + 1
// runs at all depends on the warp-wide death test at k, and each step
// waits on two dependent loads (the window column, then its member word).
// Only the B beam lanes are parallel.  The design follows from that: ONE
// warp per launch, lane = beam lane, so the death test is a single
// __ballot_sync with no shared memory or block barrier; states and alive
// stay in registers for the whole sweep and are written back once; the
// kernel allocates nothing and launches on the caller's stream.  The bars
// are read straight from global memory through the read-only path
// (__ldg); staging them in shared memory ((6, 2048) i32 plus the window is
// past the 48 KB static limit, so it needs dynamic shared memory) or
// prefetching the next barrier's words is left for a later change.
//
// witness_sweep_chain_probe times the part of each step no prefetch can
// hide -- the model step, the ballot and the commit, with the barrier's
// words already in registers -- so a caller can set the sweep's time
// against that serial-chain floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// PackedModel.kernel_model ids (jepsen_tpu_torch/models/registers.py).
constexpr int MODEL_REGISTER = 1;

// Register-family op codes (models/registers.py F_WRITE, F_CAS).
constexpr int32_t F_WRITE = 1;
constexpr int32_t F_CAS = 2;

// The register transition of models/registers.py (the reference's
// registers.py:166-186): reads and cas must see a0; writes always succeed.
__device__ __forceinline__ bool register_step(int32_t s, int32_t f,
                                              int32_t a0, int32_t a1,
                                              int32_t* next) {
  const bool is_write = f == F_WRITE;
  const bool is_cas = f == F_CAS;
  *next = is_write ? a0 : (is_cas ? a1 : s);
  return is_write || s == a0;
}

template <int MODEL, int SW>
__device__ __forceinline__ bool model_step(const int32_t (&s)[SW],
                                           int32_t (&next)[SW], int32_t f,
                                           int32_t a0, int32_t a1) {
  static_assert(MODEL == MODEL_REGISTER && SW == 1,
                "no device step for this model");
  return register_step(s[0], f, a0, a1, &next[0]);
}

template <int MODEL, int SW>
__global__ void __launch_bounds__(32)
witness_sweep_kernel(int B, int K, int start,
                     const int32_t* __restrict__ bars,
                     const int32_t* __restrict__ mbits,
                     const int32_t* __restrict__ states_in,
                     const int32_t* __restrict__ alive_in,
                     int32_t* __restrict__ states_out,
                     int32_t* __restrict__ alive_out,
                     int32_t* __restrict__ death_out) {
  const int lane = threadIdx.x;
  const bool in_beam = lane < B;
  int32_t st[SW];
#pragma unroll
  for (int j = 0; j < SW; ++j) st[j] = in_beam ? states_in[j * B + lane] : 0;
  int alive = (in_beam && alive_in[lane] != 0) ? 1 : 0;
  int death = K;

  for (int k = start; k < K; ++k) {
    // The same six words for every lane: one broadcast load each.
    const int32_t col = __ldg(bars + k);
    const int32_t real = __ldg(bars + 2 * K + k);
    const int32_t f = __ldg(bars + 3 * K + k);
    const int32_t a0 = __ldg(bars + 4 * K + k);
    const int32_t a1 = __ldg(bars + 5 * K + k);
    const int32_t word = __ldg(mbits + col);
    // Bit 31 comes out of the arithmetic shift as -1; the & 1 keeps it.
    const int has = (word >> lane) & 1;
    int32_t nx[SW];
    const bool legal = model_step<MODEL, SW>(st, nx, f, a0, a1);
    const int surv_pass = alive & has;
    const int surv_dir = alive & (1 - has) & (legal ? 1 : 0);
    const int new_alive = surv_pass | surv_dir;
    if (real != 0) {  // uniform across the warp: every lane read `real`
      // Death test over the B beam lanes only (lanes >= B are masked out).
      const unsigned any = __ballot_sync(0xffffffffu, in_beam && new_alive);
      if (any == 0u) {
        death = k;
        break;
      }
      if (surv_dir) {
#pragma unroll
        for (int j = 0; j < SW; ++j) st[j] = nx[j];
      }
      alive = new_alive;
    }
  }

  if (in_beam) {
#pragma unroll
    for (int j = 0; j < SW; ++j) states_out[j * B + lane] = st[j];
    alive_out[lane] = alive;
  }
  if (lane == 0) death_out[0] = death;
}

// The serial chain of the sweep with no loads: per step, the register
// step, the death ballot and the commit.  The operands of 16 steps are
// made in registers before the loop (from `steps`, so they are not
// compile-time constants) and the loop is unrolled by 16, so each step
// waits only on the previous step's state and alive.  Lane 0 passes every
// step, but the compiler cannot know it, so every ballot and branch stays.
// Writes each lane's state plus alive and the step count reached, so
// nothing is dead code.
constexpr int PROBE_UNROLL = 16;

__global__ void __launch_bounds__(32)
chain_probe_kernel(int steps, int32_t* __restrict__ out) {
  const int lane = threadIdx.x;
  int32_t f[PROBE_UNROLL], a0[PROBE_UNROLL], a1[PROBE_UNROLL];
  int has[PROBE_UNROLL];
#pragma unroll
  for (int j = 0; j < PROBE_UNROLL; ++j) {
    const uint32_t h = static_cast<uint32_t>(steps + j) * 2654435761u;
    f[j] = static_cast<int32_t>(h >> 30) % 3;
    a0[j] = static_cast<int32_t>(h >> 8) & 3;
    a1[j] = static_cast<int32_t>(h >> 12) & 3;
    has[j] = lane == 0 ? 1 : static_cast<int>((h >> lane) & 1u);
  }
  int32_t st = lane & 3;
  int alive = 1;
  int reached = steps;
  for (int k = 0; k < steps; k += PROBE_UNROLL) {
#pragma unroll
    for (int j = 0; j < PROBE_UNROLL; ++j) {
      int32_t nx;
      const bool legal = register_step(st, f[j], a0[j], a1[j], &nx);
      const int surv_dir = alive & (1 - has[j]) & (legal ? 1 : 0);
      const int new_alive = (alive & has[j]) | surv_dir;
      if (__ballot_sync(0xffffffffu, new_alive) == 0u) {
        reached = k + j;
        goto done;
      }
      if (surv_dir) st = nx;
      alive = new_alive;
    }
  }
done:
  out[lane] = st + alive;
  if (lane == 0) out[32] = reached;
}

}  // namespace

extern "C" {

// Launches the sweep on `stream` and returns cudaGetLastError() (0 on
// success); an unsupported model or shape returns cudaErrorInvalidValue
// without launching.
int witness_sweep_launch(int model, int sw, int B, int K, int start,
                         const void* bars, const void* mbits,
                         const void* states_in, const void* alive_in,
                         void* states_out, void* alive_out, void* death_out,
                         void* stream) {
  if (model != MODEL_REGISTER || sw != 1 || B < 1 || B > 32 || K < 1 ||
      start < 0 || start > K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  witness_sweep_kernel<MODEL_REGISTER, 1>
      <<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
          B, K, start, static_cast<const int32_t*>(bars),
          static_cast<const int32_t*>(mbits),
          static_cast<const int32_t*>(states_in),
          static_cast<const int32_t*>(alive_in),
          static_cast<int32_t*>(states_out), static_cast<int32_t*>(alive_out),
          static_cast<int32_t*>(death_out));
  return static_cast<int>(cudaGetLastError());
}

// Launches the serial-chain probe (one warp, `steps` steps, a multiple
// of 16) on `stream`; `out` holds 33 int32.  Returns cudaGetLastError().
int witness_sweep_chain_probe(int steps, void* out, void* stream) {
  if (steps < 0 || steps % PROBE_UNROLL != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* witness_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
