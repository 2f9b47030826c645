// Kernels K10 and K11: the CTC alpha and beta recursions over the 2U+1
// label lattice, in log space.
//
// Replace the TPU kernels lstm_ctc_tpu/ops/ctc_pallas.py _alpha_kernel
// (:46-75) and _beta_kernel (:78-105), launched by alpha_pallas (:120) and
// beta_pallas (:168) from ops/ctc.py _forward / _backward.
//
// alpha (forward time):  row 0 is alpha0; for t >= 1
//   a'[s] = valid[s] ? log3(a[s], a[s-1], can_skip[s] ? a[s-2] : -inf)
//                      + lp[t, s] : -inf
//   and the row stays as it was where time_mask[t] is false.
// beta' (reverse time, emission included), from t = T-1 down to 0:
//   b'[s] = valid[s] ? log3(b[s], b[s+1], skip_from[s] ? b[s+2] : -inf)
//                      + lp[t, s] : -inf
//   replaced by final[s] ? lp[t, s] : -inf where is_last[t] (the
//   sequence's last frame), and frozen where time_mask[t] is false.  The
//   result is written in forward time order.
// log3 is the NEG_INF-safe logsumexp of ctc_pallas._log3 (:30-33), with
// NEG_INF = -1e30 as a finite stand-in for -inf.
//
// What bounds it on the H100: the work is tiny (a few flops per lattice
// entry and step) and the bytes are lp_ext read once and the [T, N, S]
// result written once (92 MB at N = 96, T = 400, S = 301: 0.03 ms at
// 3.35 TB/s); but every step depends on the last, so the time is T times
// one step's latency.
//
// alpha (K10): one block per lattice row (slot n), a warp for every 32
// positions (W = ceil(S / 32), up to 16: 10 at S = 301), warp w holding
// positions 32·w·P + l + 32·j in registers (lane l, P = ceil(S / 32W)
// registers: 1 up to S = 512).  A step's neighbours s - 1 and s - 2 are
// the lanes before it in the same register, and for lanes 0 and 1 the last
// lanes of the register before, each brought by one __shfl_sync; the
// registers are updated from the last down, so each shuffle still sees the
// old row.  Only the two positions before a warp's range cross warps: each
// warp writes its last two old values into a buffer in shared memory, and
// one block barrier a live step makes them visible (the two buffers are
// taken in turn, so a warp rewrites one only after the barrier that its
// readers reach after reading it).  With that layout each register's
// store of a row is 128 contiguous bytes a warp.  lp(t) reaches a ring of kLpRing steps in
// shared memory by 4-byte cp.async (a row of S floats need not be a
// multiple of 16 bytes, nor start on one), each lane copying and reading
// only its own positions, kLpRing - 1 steps ahead; time_mask arrives 32
// steps at a time as one ballot word, its loads a word ahead; valid and
// can_skip are bit masks in registers.  log3 keeps the plain version's
// order of operations (expf/logf, no fast-math), so alpha is bit-equal.
// One warp a row, with no block barrier at all, was slower: a row's ~10
// log3 a lane then issue from one of the SM's four schedulers.
// beta (K11): one block per lattice row, one thread per lattice position;
// the carried row is double-buffered in shared memory, so a step costs one
// __syncthreads; each thread loads its lp entry a step ahead.

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxLattice = 1024;  // beta: one thread per position
constexpr int kMaxRowWarps = 16;  // alpha: warps a lattice row, at most
constexpr int kLpRing = 8;         // alpha: steps of lp a warp holds

__device__ __forceinline__ float log3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float out = m + logf(expf(a - m) + expf(b - m) + expf(c - m));
  return m <= kNegInf * 0.5f ? kNegInf : out;
}

// alpha: a block of W warps per lattice row, warp w holding positions
// w·32·P + l + 32·j (lane l, j < P) in registers
template <int P>
__global__ void __launch_bounds__(32 * kMaxRowWarps) ctc_alpha_kernel(
    const float* __restrict__ lp,       // [T, N, S]
    const bool* __restrict__ time_mask, // [T, N]
    const bool* __restrict__ valid,     // [N, S]
    const bool* __restrict__ can_skip,  // [N, S]
    const float* __restrict__ alpha0,   // [N, S]
    int steps, int slots, int width,
    float* __restrict__ out) {          // [T, N, S]
  extern __shared__ float smem[];  // lp rings [W][kLpRing][P][32], edges
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, W = blockDim.x >> 5;
  const int n = blockIdx.x;
  float* ring = smem + (size_t)w * kLpRing * P * 32;
  // the old values of the last two positions of each warp's range, in two
  // buffers taken in turn by the live steps: [2][W][2]
  float* edges = smem + (size_t)W * kLpRing * P * 32;
  const int base = w * 32 * P;  // the warp's first position
  const size_t ns = (size_t)n * width, stride = (size_t)slots * width;

  float a[P];
  uint32_t ok = 0, skip = 0;  // bit j: position base + lane + 32·j
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int s = base + lane + 32 * j;
    const bool in = s < width;
    a[j] = in ? alpha0[ns + s] : kNegInf;
    if (in && valid[ns + s]) ok |= 1u << j;
    if (in && s >= 2 && can_skip[ns + s]) skip |= 1u << j;
    if (in && steps > 0) out[ns + s] = a[j];
  }
  // lp(t) of the warp's positions, each lane its own, kLpRing - 1 steps ahead
  auto fetch = [&](int t) {
    if (t < steps) {
      float* slot = ring + (size_t)(t % kLpRing) * P * 32 + lane;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int s = base + lane + 32 * j;
        if (s < width) cp_async4_fill(slot + 32 * j, lp + t * stride + ns + s, 4);
      }
    }
    cp_async_commit();
  };
  for (int t = 1; t < kLpRing; ++t) fetch(t);
  // time_mask, 32 steps a word (lane i: step t0 + i), the next word's loads
  // a word ahead
  auto mask_of = [&](int t0) {
    return t0 + lane < steps && time_mask[(size_t)(t0 + lane) * slots + n];
  };
  uint32_t live = __ballot_sync(0xffffffffu, mask_of(0));
  bool live_next = mask_of(32);
  int turn = 0;  // the edge buffer of the next live step

  for (int t = 1; t < steps; ++t) {
    if ((t & 31) == 0) {
      live = __ballot_sync(0xffffffffu, live_next);
      live_next = mask_of(t + 32);
    }
    cp_async_wait_pending(kLpRing - 2);  // lp(t) is in
    const float* lpt = ring + (size_t)(t % kLpRing) * P * 32 + lane;
    if ((live >> (t & 31)) & 1) {  // the same for the row's warps
      // positions base - 2 and base - 1 (the warp before, NEG_INF for the
      // first), for lanes 30 and 31 to hand to lanes 0 and 1
      float edge = kNegInf;
      if (W > 1) {
        // a warp rewrites a buffer two live steps on, after the barrier of
        // the step between, which its readers reach only after reading it
        float* e = edges + turn * W * 2;
        turn ^= 1;
        if (lane >= 30) e[w * 2 + lane - 30] = a[P - 1];
        __syncthreads();
        if (w > 0 && lane >= 30) edge = e[(w - 1) * 2 + lane - 30];
      }
      // from the last register down, so that a[j - 1] is still the old row:
      // position s - 1 is lane l - 1 of register j, or lane 31 of j - 1 for
      // lane 0 (the lane supplies what its reader needs); s - 2 likewise
      // from lanes 30 and 31
#pragma unroll
      for (int j = P - 1; j >= 0; --j) {
        const float prev = j > 0 ? a[j - 1] : edge;
        const float b = __shfl_sync(0xffffffffu, lane == 31 ? prev : a[j], (lane + 31) & 31);
        const float c0 = __shfl_sync(0xffffffffu, lane >= 30 ? prev : a[j], (lane + 30) & 31);
        a[j] = (ok >> j) & 1 ? log3(a[j], b, (skip >> j) & 1 ? c0 : kNegInf) + lpt[32 * j]
                             : kNegInf;
      }
    }
    fetch(t + kLpRing - 1);  // into step t-1's slot
    float* row = out + t * stride + ns;
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (base + lane + 32 * j < width) row[base + lane + 32 * j] = a[j];
  }
  cp_async_wait_pending(0);
}

__global__ void ctc_beta_kernel(const float* __restrict__ lp,        // [T, N, S]
                                const bool* __restrict__ time_mask,  // [T, N]
                                const bool* __restrict__ is_last,    // [T, N]
                                const bool* __restrict__ valid,      // [N, S]
                                const bool* __restrict__ skip_from,  // [N, S]
                                const bool* __restrict__ final_mask, // [N, S]
                                int steps, int slots, int width,
                                float* __restrict__ out) {           // [T, N, S]
  extern __shared__ float row[];  // [2][width]
  const int n = blockIdx.x, s = threadIdx.x;
  const bool in = s < width;
  const size_t ns = (size_t)n * width + s;
  const bool ok = in && valid[ns];
  const bool skip = in && s + 2 < width && skip_from[ns];
  const bool fin = in && final_mask[ns];
  float b = kNegInf;
  if (in) row[s] = b;
  float lp_next = (in && steps > 0) ? lp[((size_t)(steps - 1) * slots) * width + ns] : 0.0f;
  __syncthreads();
  int cur = 0;
  for (int t = steps - 1; t >= 0; --t) {
    const float lpt = lp_next;
    if (in && t > 0) lp_next = lp[((size_t)(t - 1) * slots) * width + ns];
    const float* r = row + cur * width;
    if (in && time_mask[(size_t)t * slots + n]) {
      if (is_last[(size_t)t * slots + n]) {
        b = (fin && ok) ? lpt : kNegInf;
      } else {
        const float b1 = s + 1 < width ? r[s + 1] : kNegInf;
        const float b2 = skip ? r[s + 2] : kNegInf;
        b = ok ? log3(b, b1, b2) + lpt : kNegInf;
      }
    }
    cur ^= 1;
    if (in) {
      row[cur * width + s] = b;
      out[(size_t)t * slots * width + ns] = b;
    }
    __syncthreads();
  }
}

int block_threads(int width) { return (width + 31) / 32 * 32; }

template <int P>
int alpha_launch(const void* lp, const void* time_mask, const void* valid, const void* can_skip,
                 const void* alpha0, int steps, int slots, int width, int warps, void* out,
                 void* stream) {
  const size_t smem = sizeof(float) * (warps * kLpRing * P * 32 + 2 * warps * 2);
  cudaError_t err = cudaFuncSetAttribute(ctc_alpha_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ctc_alpha_kernel<P><<<slots, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)lp, (const bool*)time_mask, (const bool*)valid, (const bool*)can_skip,
      (const float*)alpha0, steps, slots, width, (float*)out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ctc_alpha(int device, const void* lp, const void* time_mask,
                         const void* valid, const void* can_skip,
                         const void* alpha0, int steps, int slots, int width,
                         void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (width <= 0 || width > kMaxLattice) return cudaErrorInvalidValue;
  if (slots <= 0 || steps <= 0) return cudaSuccess;
  // a warp for every 32 positions, up to 16 warps (then two positions a lane)
  const int warps = cdiv(width, 32) < kMaxRowWarps ? cdiv(width, 32) : kMaxRowWarps;
  if (cdiv(width, 32 * warps) == 1)
    return alpha_launch<1>(lp, time_mask, valid, can_skip, alpha0, steps, slots, width, warps, out,
                           stream);
  return alpha_launch<2>(lp, time_mask, valid, can_skip, alpha0, steps, slots, width, warps, out,
                         stream);
}

extern "C" int ctc_beta(int device, const void* lp, const void* time_mask,
                        const void* is_last, const void* valid,
                        const void* skip_from, const void* final_mask,
                        int steps, int slots, int width, void* out,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (width <= 0 || width > kMaxLattice) return cudaErrorInvalidValue;
  if (slots <= 0 || steps <= 0) return cudaSuccess;
  ctc_beta_kernel<<<slots, block_threads(width), 2 * width * sizeof(float),
                    (cudaStream_t)stream>>>(
      (const float*)lp, (const bool*)time_mask, (const bool*)is_last,
      (const bool*)valid, (const bool*)skip_from, (const bool*)final_mask,
      steps, slots, width, (float*)out);
  return cudaGetLastError();
}
