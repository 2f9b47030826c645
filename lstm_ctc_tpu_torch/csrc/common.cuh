// Shared helpers for the port's kernels: compute-dtype conversions, the
// bf16 tensor-core primitives (ldmatrix, mma.sync m16n8k16) as PTX, the
// counter-based dropout hash, and the fixed-order pass that adds the
// partial sums of split products.
//
// Every matrix product in the kernels rounds its operands to the compute
// dtype (float32 or bfloat16) and sums the products in float32, as the
// reference's dot_general(..., preferred_element_type=float32) does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
struct Dtype;

template <>
struct Dtype<float> {
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ float from_float(float v) { return v; }
};

template <>
struct Dtype<__nv_bfloat16> {
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float v) {
    return __float2bfloat16(v);  // round to nearest even, as torch's .to()
  }
};

// Largest dynamic shared memory one block may use on sm_90 (227 KB).
constexpr size_t kMaxSmemPerBlock = 232448;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices from shared memory, each lane giving one row
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// four elements from global into shared memory, asynchronously (cp.async;
// both addresses aligned to their 4·sizeof(X) bytes; 16 bytes bypass L1);
// commit, then wait for all before reading them
template <typename X>
__device__ __forceinline__ void cp_async4(X* dst, const X* src) {
  static_assert(sizeof(X) == 2 || sizeof(X) == 4, "8 or 16 bytes a copy");
  if constexpr (sizeof(X) == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 16 or 4 bytes from global into shared memory, asynchronously, of which
// the first `src_bytes` are read and the rest are zero-filled (16: both
// addresses 16-byte aligned, L1 bypassed; 4: 4-byte aligned)
__device__ __forceinline__ void cp_async16_fill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4_fill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

// wait until at most `n` (0-7) of this thread's latest committed groups
// are still in flight
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// d += a (16x16, row) · b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Uniform in [0, 1) from the murmur3 finalizer over (global row, global
// column, seed): lstm_ctc_tpu/ops/moe_pallas.py hash_uniform (:85-101),
// bit for bit.  The MoE head's kernels draw their mask from it at the
// element's global (n, e·V + v), the LSTM stack's (lstm_stack_fwd.cu,
// lstm_stack_bwd.cu) at (s·L·B + l·B + b, p), whatever order they visit the
// elements in.
__device__ __forceinline__ float hash_uniform(uint32_t row, uint32_t col,
                                              uint32_t seed) {
  uint32_t x = row * 0x9E3779B1u + col * 0x85EBCA77u + seed * 0xC2B2AE3Du;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (float)(x >> 9) * (1.0f / 8388608.0f);
}

// the dropout factor of one element: 1 / keep_prob where kept, else 0
__device__ __forceinline__ float drop_factor(uint32_t row, uint32_t col,
                                             uint32_t seed, float keep_prob,
                                             float inv_keep) {
  return hash_uniform(row, col, seed) < keep_prob ? inv_keep : 0.0f;
}

namespace {

// mbarriers (the LSTM kernels' point-to-point hand-offs, the MoE kernels'
// copy rings): init with an arrival count, arm a phase for a number of
// bytes, wait for a phase by its parity.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// makes initialised barriers visible to the cluster (before its barrier)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of this parity has completed; it acquires, at
// cluster scope, the stores that completed it.  A wait of seconds means a
// fault: the launch ends with an error rather than hang (a step takes
// microseconds).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1LL << 26)) __trap();
  }
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// out[i] = Σ over splits of partial[split][i], in split order: the second
// pass of the kernels whose blocks write partial sums (no atomics, so the
// result does not depend on the schedule)
__global__ void split_sum_kernel(const float* __restrict__ partial,
                                 int splits, size_t count,
                                 float* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int s = 0; s < splits; ++s) v += partial[s * count + i];
    out[i] = v;
  }
}

}  // namespace
