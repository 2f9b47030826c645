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
// beta (K11): K10's design mirrored.  The same block of W warps a row and
// the same positions in registers; the neighbours s + 1 and s + 2 come by
// one shuffle each from the lanes after, and for lanes 30 and 31 from
// lanes 0 and 1 of the register after, so the registers are updated from
// the first up, each shuffle still seeing the old row.  Only the two
// positions after a warp's range cross warps: each warp writes its first
// two old values into one of the two edge buffers, warp w reads warp
// w + 1's after the step's block barrier, and the last warp reads NEG_INF.
// lp(t) comes down a ring of kLpRing steps from t = T - 1, kLpRing - 1
// steps ahead; time_mask and is_last come as two ballot words of 32 steps,
// each loaded a word ahead walking down; a reset step (is_last, which a
// packed row has once per utterance) needs no neighbour and takes no
// barrier.  valid, skip_from and final & valid are bit masks in registers.
// Bit-equal to the plain version, as K10 (the same log3).

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxLattice = 1024;  // positions a row, at most (16 warps of 2 registers)
constexpr int kMaxRowWarps = 16;   // warps a lattice row, at most
constexpr int kLpRing = 8;         // steps of lp a warp holds

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

// beta: alpha's layout, walked down in time with the neighbours after
template <int P>
__global__ void __launch_bounds__(32 * kMaxRowWarps) ctc_beta_kernel(
    const float* __restrict__ lp,         // [T, N, S]
    const bool* __restrict__ time_mask,   // [T, N]
    const bool* __restrict__ is_last,     // [T, N]
    const bool* __restrict__ valid,       // [N, S]
    const bool* __restrict__ skip_from,   // [N, S]
    const bool* __restrict__ final_mask,  // [N, S]
    int steps, int slots, int width,
    float* __restrict__ out) {            // [T, N, S]
  extern __shared__ float smem[];  // lp rings [W][kLpRing][P][32], edges
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, W = blockDim.x >> 5;
  const int n = blockIdx.x;
  float* ring = smem + (size_t)w * kLpRing * P * 32;
  // the old values of the first two positions of each warp's range, in two
  // buffers taken in turn by the live steps that are not resets: [2][W][2]
  float* edges = smem + (size_t)W * kLpRing * P * 32;
  const int base = w * 32 * P;  // the warp's first position
  const size_t ns = (size_t)n * width, stride = (size_t)slots * width;

  float b[P];
  uint32_t ok = 0, skip = 0, fin = 0;  // bit j: position base + lane + 32·j
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int s = base + lane + 32 * j;
    const bool in = s < width;
    b[j] = kNegInf;
    const bool v = in && valid[ns + s];
    if (v) ok |= 1u << j;
    if (in && skip_from[ns + s]) skip |= 1u << j;
    if (v && final_mask[ns + s]) fin |= 1u << j;
  }
  // lp(t) of the warp's positions, each lane its own, kLpRing - 1 steps
  // ahead on the way down
  auto fetch = [&](int t) {
    if (t >= 0) {
      float* slot = ring + (size_t)(t % kLpRing) * P * 32 + lane;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int s = base + lane + 32 * j;
        if (s < width) cp_async4_fill(slot + 32 * j, lp + t * stride + ns + s, 4);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < kLpRing - 1; ++i) fetch(steps - 1 - i);
  // a mask, 32 steps a word (lane i: step t0 + i), the word below loaded a
  // word ahead
  auto bit_of = [&](const bool* mask, int t0) {
    const int t = t0 + lane;
    return t >= 0 && t < steps && mask[(size_t)t * slots + n];
  };
  const int top = (steps - 1) & ~31;  // the first step of the top word
  uint32_t live = __ballot_sync(0xffffffffu, bit_of(time_mask, top));
  uint32_t reset = __ballot_sync(0xffffffffu, bit_of(is_last, top));
  bool live_next = bit_of(time_mask, top - 32), reset_next = bit_of(is_last, top - 32);
  int turn = 0;  // the edge buffer of the next update

  for (int t = steps - 1; t >= 0; --t) {
    if ((t & 31) == 31 && t != steps - 1) {  // into the word below
      live = __ballot_sync(0xffffffffu, live_next);
      reset = __ballot_sync(0xffffffffu, reset_next);
      live_next = bit_of(time_mask, t - 63);
      reset_next = bit_of(is_last, t - 63);
    }
    cp_async_wait_pending(kLpRing - 2);  // lp(t) is in
    const float* lpt = ring + (size_t)(t % kLpRing) * P * 32 + lane;
    // live and reset are the same for the row's warps
    if ((reset >> (t & 31)) & (live >> (t & 31)) & 1) {
      // the sequence's last frame: b' = final & valid ? lp : NEG_INF
#pragma unroll
      for (int j = 0; j < P; ++j) b[j] = (fin >> j) & 1 ? lpt[32 * j] : kNegInf;
    } else if ((live >> (t & 31)) & 1) {
      // positions base + 32P and base + 32P + 1 (the warp after, NEG_INF
      // for the last), for lanes 0 and 1 to hand to lanes 31 and 30, 31
      float edge = kNegInf;
      if (W > 1) {
        // a warp rewrites a buffer two updates on, after the barrier of the
        // update between, which its readers reach only after reading it
        float* e = edges + turn * W * 2;
        turn ^= 1;
        if (lane < 2) e[w * 2 + lane] = b[0];
        __syncthreads();
        if (w + 1 < W && lane < 2) edge = e[(w + 1) * 2 + lane];
      }
      // from the first register up, so that b[j + 1] is still the old row:
      // position s + 1 is lane l + 1 of register j, or lane 0 of j + 1 for
      // lane 31 (the lane supplies what its reader needs); s + 2 likewise
      // from lanes 0 and 1
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float next = j + 1 < P ? b[j + 1] : edge;
        const float b1 = __shfl_sync(0xffffffffu, lane == 0 ? next : b[j], (lane + 1) & 31);
        const float b2 = __shfl_sync(0xffffffffu, lane < 2 ? next : b[j], (lane + 2) & 31);
        b[j] = (ok >> j) & 1 ? log3(b[j], b1, (skip >> j) & 1 ? b2 : kNegInf) + lpt[32 * j]
                             : kNegInf;
      }
    }
    fetch(t - (kLpRing - 1));  // into step t + 1's slot
    float* row = out + t * stride + ns;
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (base + lane + 32 * j < width) row[base + lane + 32 * j] = b[j];
  }
  cp_async_wait_pending(0);
}

// warps a row: one for every 32 positions, up to kMaxRowWarps (then two
// positions a lane)
int row_warps(int width) {
  return cdiv(width, 32) < kMaxRowWarps ? cdiv(width, 32) : kMaxRowWarps;
}

size_t row_smem(int warps, int per) {
  return sizeof(float) * (warps * kLpRing * per * 32 + 2 * warps * 2);
}

template <int P>
int beta_launch(const void* lp, const void* time_mask, const void* is_last, const void* valid,
                const void* skip_from, const void* final_mask, int steps, int slots, int width,
                int warps, void* out, void* stream) {
  const size_t smem = row_smem(warps, P);
  cudaError_t err = cudaFuncSetAttribute(ctc_beta_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ctc_beta_kernel<P><<<slots, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)lp, (const bool*)time_mask, (const bool*)is_last, (const bool*)valid,
      (const bool*)skip_from, (const bool*)final_mask, steps, slots, width, (float*)out);
  return cudaGetLastError();
}

template <int P>
int alpha_launch(const void* lp, const void* time_mask, const void* valid, const void* can_skip,
                 const void* alpha0, int steps, int slots, int width, int warps, void* out,
                 void* stream) {
  const size_t smem = row_smem(warps, P);
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
  const int warps = row_warps(width);
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
  const int warps = row_warps(width);
  if (cdiv(width, 32 * warps) == 1)
    return beta_launch<1>(lp, time_mask, is_last, valid, skip_from, final_mask, steps, slots,
                          width, warps, out, stream);
  return beta_launch<2>(lp, time_mask, is_last, valid, skip_from, final_mask, steps, slots,
                        width, warps, out, stream);
}
