// Kernel B: the MoE head's fused expert mix, forward.
//
// Replaces the TPU kernel lstm_ctc_tpu/ops/moe_pallas.py _fwd_kernel (:212,
// body _fwd_body :189-210), launched by _pallas_fwd (:358) from
// moe_mix_fused (:574):
//
//   out[n, v] = sum_e gate[n, e] * drop(tau * tanh(x[n] · W_e + b_e))[v]
//
// without writing the [N, E·V] expert tile to memory.  Dropout keeps an
// element where hash_uniform(n, e·V + v, seed) < keep_prob and scales it by
// 1 / keep_prob; the hash is the reference's murmur3 finalizer, bit for bit.
//
// What bounds it on the H100: the expert product, 2·N·D·E·V flops
// (81.5 GFLOP at N = 12288, D = 640, E = V = 72), far above the byte
// traffic (x and out once; W, 6.6 MB in bf16, re-read from L2 by every
// row tile).  So the tensor cores should set the pace: the bf16 path
// issues ldmatrix and mma.sync m16n8k16; the float32 path, which must not
// round to TF32, uses FMA.  The TPU kernel's R/S fold matrices and
// expert padding are lane tricks of the TPU and are not carried over.
//
// Design: one block per tile of NB rows loops over all E experts.  The x
// tile, cast to the compute dtype inside the kernel, stays in shared
// memory for all experts.  W_e streams through two shared-memory buffers
// in 64-row chunks; the next chunk is loaded into registers (16-byte
// loads) while the current one feeds the products, so one barrier per
// chunk suffices.  z = x·W_e lands in shared memory (aliasing the W
// buffers; ~104 KB a block, so two blocks share an SM); the epilogue adds
// b_e, takes tau·tanh, applies the mask and adds gate[n, e]·a into a
// [NB, V] accumulator held in registers, written once at the end.  No
// atomics, no cross-block reduction.  A TMA/wgmma pipeline is later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kChunk = 64;     // rows of W_e per shared-memory chunk
constexpr int kMaxV = 128;     // widest expert output a block can hold

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

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

template <typename T>
struct Tile;  // rows per block, shared-memory row padding (elements)

template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kRows = 64;
  static constexpr int kPad = 8;  // 16 bytes: rows fall on other banks
};

template <>
struct Tile<float> {
  static constexpr int kRows = 32;
  static constexpr int kPad = 4;
};

struct Layout {
  int dp, vp, ldx, ldw, ldz;
  size_t x_bytes, w_elems, wz_bytes;
};

template <typename T>
__host__ __device__ Layout layout(int d, int v) {
  Layout l;
  l.dp = round16(d);
  l.vp = round16(v);
  l.ldx = l.dp + Tile<T>::kPad;
  l.ldw = l.vp + Tile<T>::kPad;
  l.ldz = l.vp + 4;
  l.x_bytes = sizeof(T) * Tile<T>::kRows * (size_t)l.ldx;
  l.w_elems = (size_t)kChunk * l.ldw;
  const size_t w_bytes = 2 * sizeof(T) * l.w_elems;  // two chunk buffers
  const size_t z_bytes = sizeof(float) * Tile<T>::kRows * (size_t)l.ldz;
  l.wz_bytes = w_bytes > z_bytes ? w_bytes : z_bytes;
  return l;
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

// Partial expert product over one chunk, bf16 on the tensor cores
// (ldmatrix, mma.sync m16n8k16).  Warp w owns row tile w % 4 and column
// tiles w / 4, w / 4 + 2, ... of 16 columns each.
struct MmaAcc {
  static constexpr int kTiles = (kMaxV / 16 + 1) / 2;
  float acc[kTiles][2][4];  // [column tile][8-column half][mma C registers]

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][h][i] = 0.0f;
  }

  __device__ void product(const __nv_bfloat16* xs, const __nv_bfloat16* ws,
                          int k0, int kc, const Layout& l) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
    const int tm = warp % 4, tn0 = warp / 4, ntn = l.vp / 16;
    // ldmatrix row addresses: x rows tm·16 + lane % 16 at k + 8·(lane / 16);
    // W rows k = lane % 16 at column 8·(lane / 16)
    const __nv_bfloat16* x_lane = xs + (tm * 16 + (lane & 15)) * l.ldx + (lane >> 4) * 8;
    const __nv_bfloat16* w_lane = ws + (lane & 15) * l.ldw + (lane >> 4) * 8;
    for (int kk = 0; kk < kc; kk += 16) {
      uint32_t fa[4];
      ldsm_x4(fa, x_lane + k0 + kk);
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const int tn = tn0 + 2 * j;
        if (tn < ntn) {
          uint32_t fb[4];
          ldsm_x4_trans(fb, w_lane + kk * l.ldw + tn * 16);
          mma_16816(acc[j][0], fa, fb[0], fb[1]);
          mma_16816(acc[j][1], fa, fb[2], fb[3]);
        }
      }
    }
  }

  // lane holds rows lane / 4 and + 8, columns 2·(lane % 4) and + 1 of each
  // 8-column half
  __device__ void store(float* zs, const Layout& l) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
    const int tm = warp % 4, tn0 = warp / 4;
    float* row = zs + (tm * 16 + (lane >> 2)) * l.ldz + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int tn = tn0 + 2 * j;
      if (tn < l.vp / 16) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* dst = row + tn * 16 + h * 8;
          *reinterpret_cast<float2*>(dst) = make_float2(acc[j][h][0], acc[j][h][1]);
          *reinterpret_cast<float2*>(dst + 8 * l.ldz) =
              make_float2(acc[j][h][2], acc[j][h][3]);
        }
      }
    }
  }
};

// Partial expert product over one chunk in float32 FMA (no TF32 rounding).
// Thread (rg, cg) owns rows 2·rg, 2·rg + 1 and columns cg + 16·j.
struct FmaAcc {
  static constexpr int kRowsPer = Tile<float>::kRows / 16;
  static constexpr int kColsPer = kMaxV / 16;
  float acc[kRowsPer][kColsPer];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) acc[i][j] = 0.0f;
  }

  __device__ void product(const float* xs, const float* ws, int k0, int kc,
                          const Layout& l) {
    const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
    for (int kk = 0; kk < kc; ++kk) {
      float a[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) a[i] = xs[(rg * kRowsPer + i) * l.ldx + k0 + kk];
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) {
        if (j * 16 < l.vp) {
          const float b = ws[kk * l.ldw + cg + 16 * j];
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
        }
      }
    }
  }

  __device__ void store(float* zs, const Layout& l) const {
    const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < kColsPer; ++j)
        if (j * 16 < l.vp) zs[(rg * kRowsPer + i) * l.ldz + cg + 16 * j] = acc[i][j];
  }
};

template <typename T>
struct Product;
template <>
struct Product<__nv_bfloat16> { using Acc = MmaAcc; };
template <>
struct Product<float> { using Acc = FmaAcc; };

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) moe_fwd_kernel(
    const float* __restrict__ x,     // [N, D] float32
    const T* __restrict__ w,         // [D, E·V] compute dtype
    const float* __restrict__ b,     // [E·V]
    const float* __restrict__ gate,  // [N, E]
    int n, int d, int experts, int v, float tau, float keep_prob,
    uint32_t seed, float* __restrict__ out) {  // [N, V]
  constexpr int kRows = Tile<T>::kRows;
  constexpr int kPerRow = kThreads / kRows;  // threads per output row
  constexpr int kCols = kMaxV / kPerRow;     // output columns per thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Layout l = layout<T>(d, v);
  T* xs = reinterpret_cast<T*>(smem_raw);                       // [NB][ldx]
  T* ws = reinterpret_cast<T*>(smem_raw + l.x_bytes);           // 2 x [64][ldw]
  float* zs = reinterpret_cast<float*>(smem_raw + l.x_bytes);   // [NB][ldz]
  const int n0 = blockIdx.x * kRows;
  const int ev = experts * v;
  const bool vec = (v * (int)sizeof(T)) % 16 == 0;

  // the x tile, cast to the compute dtype once for all experts
  for (int i = threadIdx.x; i < kRows * l.dp; i += kThreads) {
    const int r = i / l.dp, k = i - r * l.dp;
    const float val = (n0 + r < n && k < d) ? x[(size_t)(n0 + r) * d + k] : 0.0f;
    xs[r * l.ldx + k] = Dtype<T>::from_float(val);
  }

  const int row = threadIdx.x / kPerRow, lane = threadIdx.x % kPerRow;
  const bool row_ok = n0 + row < n;
  const bool dropout = keep_prob < 1.0f;
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
    T* buf = ws + (it & 1) * l.w_elems;
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
    if (row_ok) {
      const float g = gate[(size_t)(n0 + row) * experts + e];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = lane + kPerRow * j;
        if (c < v) {
          float a = tau * tanhf(zs[row * l.ldz + c] + b[e * v + c]);
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

template <typename T>
int launch(int device, const void* x, const void* w, const void* b,
           const void* gate, int n, int d, int experts, int v, float tau,
           float keep_prob, uint32_t seed, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  if (v <= 0 || v > kMaxV || d <= 0 || experts <= 0) return cudaErrorInvalidValue;
  const Layout l = layout<T>(d, v);
  const size_t smem = l.x_bytes + l.wz_bytes;
  if (smem > kMaxSmemPerBlock) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(moe_fwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // all of the SM's unified L1/shared storage as shared memory: two blocks
  err = cudaFuncSetAttribute(moe_fwd_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return err;
  const int blocks = (n + Tile<T>::kRows - 1) / Tile<T>::kRows;
  moe_fwd_kernel<T><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const T*)w, (const float*)b, (const float*)gate, n, d,
      experts, v, tau, keep_prob, seed, (float*)out);
  return cudaGetLastError();
}

}  // namespace

#define MOE_FWD_ARGS                                                          \
  int device, const void *x, const void *w, const void *b, const void *gate, \
      int n, int d, int experts, int v, float tau, float keep_prob,          \
      uint32_t seed, void *out, void *stream
#define MOE_FWD_PASS \
  device, x, w, b, gate, n, d, experts, v, tau, keep_prob, seed, out, stream

extern "C" int moe_fwd_f32(MOE_FWD_ARGS) { return launch<float>(MOE_FWD_PASS); }

extern "C" int moe_fwd_bf16(MOE_FWD_ARGS) {
  return launch<__nv_bfloat16>(MOE_FWD_PASS);
}
