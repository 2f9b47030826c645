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
// one step's latency.  Design: one block per lattice row (slot n), one
// thread per lattice position s; the carried row is double-buffered in
// shared memory, so a step costs one __syncthreads.  Each thread loads its
// lp entry a step ahead, so the load's latency overlaps the step before.
// Sums use expf/logf (no fast-math), as the plain version does in float32.

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxLattice = 1024;  // one thread per position

__device__ __forceinline__ float log3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float out = m + logf(expf(a - m) + expf(b - m) + expf(c - m));
  return m <= kNegInf * 0.5f ? kNegInf : out;
}

__global__ void ctc_alpha_kernel(const float* __restrict__ lp,       // [T, N, S]
                                 const bool* __restrict__ time_mask, // [T, N]
                                 const bool* __restrict__ valid,     // [N, S]
                                 const bool* __restrict__ can_skip,  // [N, S]
                                 const float* __restrict__ alpha0,   // [N, S]
                                 int steps, int slots, int width,
                                 float* __restrict__ out) {          // [T, N, S]
  extern __shared__ float row[];  // [2][width]
  const int n = blockIdx.x, s = threadIdx.x;
  const bool in = s < width;
  const size_t ns = (size_t)n * width + s;
  const bool ok = in && valid[ns];
  const bool skip = in && s >= 2 && can_skip[ns];
  float a = in ? alpha0[ns] : kNegInf;
  if (in) {
    row[s] = a;
    if (steps > 0) out[ns] = a;
  }
  float lp_next = (in && steps > 1) ? lp[(size_t)slots * width + ns] : 0.0f;
  __syncthreads();
  int cur = 0;
  for (int t = 1; t < steps; ++t) {
    const float lpt = lp_next;
    if (in && t + 1 < steps) lp_next = lp[((size_t)(t + 1) * slots) * width + ns];
    const float* r = row + cur * width;
    if (in && time_mask[(size_t)t * slots + n]) {
      const float b = s >= 1 ? r[s - 1] : kNegInf;
      const float c = skip ? r[s - 2] : kNegInf;
      a = ok ? log3(a, b, c) + lpt : kNegInf;
    }
    cur ^= 1;
    if (in) {
      row[cur * width + s] = a;
      out[(size_t)t * slots * width + ns] = a;
    }
    __syncthreads();
  }
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

}  // namespace

extern "C" int ctc_alpha(int device, const void* lp, const void* time_mask,
                         const void* valid, const void* can_skip,
                         const void* alpha0, int steps, int slots, int width,
                         void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (width <= 0 || width > kMaxLattice) return cudaErrorInvalidValue;
  if (slots <= 0 || steps <= 0) return cudaSuccess;
  ctc_alpha_kernel<<<slots, block_threads(width), 2 * width * sizeof(float),
                     (cudaStream_t)stream>>>(
      (const float*)lp, (const bool*)time_mask, (const bool*)valid,
      (const bool*)can_skip, (const float*)alpha0, steps, slots, width,
      (float*)out);
  return cudaGetLastError();
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
