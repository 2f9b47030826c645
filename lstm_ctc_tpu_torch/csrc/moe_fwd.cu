// K4 and K5: the MoE head's fused expert mix, forward.
//
// Replaces the TPU kernels lstm_ctc_tpu/ops/moe_pallas.py _fwd_kernel (:212,
// K4) and _fwd_kernel_res (:217, K5), both with the body _fwd_body
// (:189-210), launched by _pallas_fwd (:358) from moe_mix_fused (:574):
//
//   out[n, v] = sum_e gate[n, e] * drop(tau * tanh(x[n] · W_e + b_e))[v]
//
// K4 (serving, evaluation) does not write the [N, E·V] expert tile to
// memory.  K5 (training) also stores th = tanh(x · W + b) [N, E·V] in the
// compute dtype for the backward (moe_bwd.cu), as the TPU kernel stashes
// it (:199-202, :369).  Dropout keeps an element where hash_uniform(n,
// e·V + v, seed) < keep_prob and scales it by 1 / keep_prob; the hash is
// the reference's murmur3 finalizer, bit for bit.  K4 takes the seed as an
// argument; K5 reads it from device memory, where the training step drew
// it, so the host never waits for it.
//
// What bounds it on the H100: the expert product, 2·N·D·E·V flops
// (95.1 GFLOP at N = 14336, D = 640, E = V = 72), above the byte traffic
// (x and out once, W, 6.6 MB in bf16, re-read from L2 by every row tile;
// K5 adds the 149 MB bf16 stash, ~0.04 ms at 3.35 TB/s).  So the tensor
// cores should set the pace: the bf16 path issues ldmatrix and mma.sync
// m16n8k16; the float32 path, which must not round to TF32, uses FMA.  The
// TPU kernel's R/S fold matrices and expert padding are lane tricks of the
// TPU and are not carried over.
//
// Design: one block per tile of NB rows loops over all E experts.  The x
// tile, cast to the compute dtype inside the kernel, stays in shared
// memory for all experts.  W_e streams through two shared-memory buffers
// in 64-row chunks; the next chunk is loaded into registers (16-byte
// loads) while the current one feeds the products, so one barrier per
// chunk suffices.  z = x·W_e lands in shared memory (aliasing the W
// buffers; ~104 KB a block, so two blocks share an SM); the epilogue adds
// b_e, takes tau·tanh, applies the mask and adds gate[n, e]·a into a
// [NB, V] accumulator held in registers, written once at the end.  K5
// first turns the z tile into th in place with all threads, row-major, so
// that its stash is written in whole rows.  No atomics, no cross-block
// reduction.  A TMA/wgmma pipeline is later work.

#include "tile_product.cuh"

namespace {

constexpr int kChunk = 64;  // rows of W_e per shared-memory chunk

struct FwdLayout {
  Layout l;
  size_t x_bytes, w_elems, wz_bytes;
};

template <typename T>
__host__ __device__ FwdLayout fwd_layout(int d, int v) {
  FwdLayout f;
  f.l = layout<T>(d, v);
  f.x_bytes = sizeof(T) * Tile<T>::kRows * (size_t)f.l.ldx;
  f.w_elems = (size_t)kChunk * f.l.ldw;
  const size_t w_bytes = 2 * sizeof(T) * f.w_elems;  // two chunk buffers
  const size_t z_bytes = sizeof(float) * Tile<T>::kRows * (size_t)f.l.ldz;
  f.wz_bytes = w_bytes > z_bytes ? w_bytes : z_bytes;
  return f;
}

// One chunk of W_e (rows k0 .. k0 + 64, columns e·V .. e·V + V, zero
// padded to vp) held in registers as 16-byte vectors between its load and
// its store to shared memory.  Used when a row segment of W_e is a whole
// number of 16-byte vectors (V · sizeof(T) % 16 == 0).
template <typename T>
struct ChunkRegs {
  static constexpr int kVecs = kChunk * (kMaxV * (int)sizeof(T) / 16) / kThreads;
  uint4 reg[kVecs];

  __device__ void load(const T* __restrict__ w, int k0, int d, int ev, int e,
                       int v, const Layout& l) {
    const int per_row = l.vp * (int)sizeof(T) / 16;
    const int valid = v * (int)sizeof(T) / 16;
    const uint4* base = reinterpret_cast<const uint4*>(w + (size_t)e * v);
    const int row_vecs = ev * (int)sizeof(T) / 16;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      const int kk = idx / per_row, c = idx - kk * per_row;
      const int k = k0 + kk;
      reg[j] = (kk < kChunk && k < d && c < valid)
                   ? __ldg(base + (size_t)k * row_vecs + c)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ void store(T* ws, const Layout& l) const {
    const int per_row = l.vp * (int)sizeof(T) / 16;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      const int kk = idx / per_row, c = idx - kk * per_row;
      if (kk < kChunk) reinterpret_cast<uint4*>(ws + (size_t)kk * l.ldw)[c] = reg[j];
    }
  }
};

// The same chunk staged element by element (any V).
template <typename T>
__device__ void stage_scalar(T* ws, const T* __restrict__ w, int k0, int d,
                             int ev, int e, int v, const Layout& l) {
  for (int i = threadIdx.x; i < kChunk * l.vp; i += kThreads) {
    const int kk = i / l.vp, c = i - kk * l.vp;
    const int k = k0 + kk;
    ws[kk * l.ldw + c] = (k < d && c < v) ? w[(size_t)k * ev + e * v + c]
                                          : Dtype<T>::from_float(0.0f);
  }
}

template <typename T, bool kStash>
__global__ void __launch_bounds__(kThreads, 2) moe_fwd_kernel(
    const float* __restrict__ x,     // [N, D] float32
    const T* __restrict__ w,         // [D, E·V] compute dtype
    const float* __restrict__ b,     // [E·V]
    const float* __restrict__ gate,  // [N, E]
    int n, int d, int experts, int v, float tau, float keep_prob,
    uint32_t seed_arg,               // K4's seed
    const int32_t* __restrict__ seed_dev,  // K5's seed [1] (read if dropout)
    float* __restrict__ out,         // [N, V]
    T* __restrict__ th) {            // [N, E·V] (K5)
  constexpr int kRows = Tile<T>::kRows;
  constexpr int kPerRow = kThreads / kRows;  // threads per output row
  constexpr int kCols = kMaxV / kPerRow;     // output columns per thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const FwdLayout f = fwd_layout<T>(d, v);
  const Layout& l = f.l;
  T* xs = reinterpret_cast<T*>(smem_raw);                       // [NB][ldx]
  T* ws = reinterpret_cast<T*>(smem_raw + f.x_bytes);           // 2 x [64][ldw]
  float* zs = reinterpret_cast<float*>(smem_raw + f.x_bytes);   // [NB][ldz]
  const int n0 = blockIdx.x * kRows;
  const int ev = experts * v;
  const bool vec = (v * (int)sizeof(T)) % 16 == 0;
  const bool dropout = keep_prob < 1.0f;
  const uint32_t seed = kStash ? (dropout ? (uint32_t)seed_dev[0] : 0u) : seed_arg;

  // the x tile, cast to the compute dtype once for all experts
  for (int i = threadIdx.x; i < kRows * l.dp; i += kThreads) {
    const int r = i / l.dp, k = i - r * l.dp;
    const float val = (n0 + r < n && k < d) ? x[(size_t)(n0 + r) * d + k] : 0.0f;
    xs[r * l.ldx + k] = Dtype<T>::from_float(val);
  }

  const int row = threadIdx.x / kPerRow, lane = threadIdx.x % kPerRow;
  const bool row_ok = n0 + row < n;
  const float inv_keep = 1.0f / keep_prob;
  float mix[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) mix[j] = 0.0f;

  typename Product<T>::Acc acc;
  acc.zero();
  ChunkRegs<T> next;
  const int chunks = (l.dp + kChunk - 1) / kChunk;
  const int total = experts * chunks;
  if (vec) next.load(w, 0, d, ev, 0, v, l);
  for (int it = 0; it < total; ++it) {
    const int e = it / chunks, k0 = (it - e * chunks) * kChunk;
    T* buf = ws + (it & 1) * f.w_elems;
    if (vec)
      next.store(buf, l);
    else
      stage_scalar(buf, w, k0, d, ev, e, v, l);
    __syncthreads();
    if (vec && it + 1 < total) {
      const int e2 = (it + 1) / chunks;
      next.load(w, (it + 1 - e2 * chunks) * kChunk, d, ev, e2, v, l);
    }
    acc.product(xs, buf, k0, min(kChunk, l.dp - k0), l);
    if (k0 + kChunk < l.dp) continue;

    // expert e is complete: z -> shared memory, then the epilogue
    __syncthreads();  // every warp is done reading the W buffers
    acc.store(zs, l);
    acc.zero();
    __syncthreads();
    if (kStash) {
      // z -> th in place, and th to the stash in whole rows
      for (int i = threadIdx.x; i < kRows * v; i += kThreads) {
        const int r = i / v, c = i - r * v;
        const float t = tanhf(zs[r * l.ldz + c] + b[e * v + c]);
        zs[r * l.ldz + c] = t;
        if (n0 + r < n) th[(size_t)(n0 + r) * ev + e * v + c] = Dtype<T>::from_float(t);
      }
      __syncthreads();
    }
    if (row_ok) {
      const float g = gate[(size_t)(n0 + row) * experts + e];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = lane + kPerRow * j;
        if (c < v) {
          const float t = kStash ? zs[row * l.ldz + c] : tanhf(zs[row * l.ldz + c] + b[e * v + c]);
          float a = tau * t;
          if (dropout) {
            const float u = hash_uniform((uint32_t)(n0 + row), (uint32_t)(e * v + c), seed);
            a = u < keep_prob ? a * inv_keep : 0.0f;
          }
          mix[j] = fmaf(g, a, mix[j]);
        }
      }
    }
    __syncthreads();  // zs is free before the next chunk lands on it
  }

  if (row_ok) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + kPerRow * j;
      if (c < v) out[(size_t)(n0 + row) * v + c] = mix[j];
    }
  }
}

template <typename T, bool kStash>
int launch(int device, const void* x, const void* w, const void* b,
           const void* gate, int n, int d, int experts, int v, float tau,
           float keep_prob, uint32_t seed, const void* seed_dev, void* out,
           void* th, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  if (v <= 0 || v > kMaxV || d <= 0 || experts <= 0) return cudaErrorInvalidValue;
  if (kStash && keep_prob < 1.0f && seed_dev == nullptr) return cudaErrorInvalidValue;
  const FwdLayout f = fwd_layout<T>(d, v);
  const size_t smem = f.x_bytes + f.wz_bytes;
  err = set_smem(moe_fwd_kernel<T, kStash>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + Tile<T>::kRows - 1) / Tile<T>::kRows;
  moe_fwd_kernel<T, kStash><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const T*)w, (const float*)b, (const float*)gate, n, d,
      experts, v, tau, keep_prob, seed, (const int32_t*)seed_dev, (float*)out,
      (T*)th);
  return cudaGetLastError();
}

}  // namespace

#define MOE_FWD_ARGS                                                          \
  int device, const void *x, const void *w, const void *b, const void *gate, \
      int n, int d, int experts, int v, float tau, float keep_prob,          \
      uint32_t seed, void *out, void *stream
#define MOE_FWD_PASS(T)                                                 \
  launch<T, false>(device, x, w, b, gate, n, d, experts, v, tau, keep_prob, \
                   seed, nullptr, out, nullptr, stream)

extern "C" int moe_fwd_f32(MOE_FWD_ARGS) { return MOE_FWD_PASS(float); }

extern "C" int moe_fwd_bf16(MOE_FWD_ARGS) { return MOE_FWD_PASS(__nv_bfloat16); }

#define MOE_STASH_ARGS                                                        \
  int device, const void *x, const void *w, const void *b, const void *gate, \
      const void *seed, int n, int d, int experts, int v, float tau,         \
      float keep_prob, void *out, void *th, void *stream
#define MOE_STASH_PASS(T)                                                    \
  launch<T, true>(device, x, w, b, gate, n, d, experts, v, tau, keep_prob, 0u, \
                  seed, out, th, stream)

extern "C" int moe_fwd_stash_f32(MOE_STASH_ARGS) { return MOE_STASH_PASS(float); }

extern "C" int moe_fwd_stash_bf16(MOE_STASH_ARGS) {
  return MOE_STASH_PASS(__nv_bfloat16);
}
