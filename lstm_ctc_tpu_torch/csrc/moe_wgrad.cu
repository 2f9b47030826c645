// K9: the MoE head's expert weight and bias gradients, dz recomputed.
//
// Replaces the TPU kernel lstm_ctc_tpu/ops/moe_pallas.py _wgrad_kernel
// (:289-309), launched by _pallas_wgrad (:507): the second pass of the
// opt-in "twokernel" backward (fused_bwd :557-559), after K8.  From x, the
// stash th, the gate, gout and the same hash mask m at global (n, e·V + v):
//
//   dz            = gate[n, e] · gout[n, v] · tau (1 - th²) · m   (float32)
//   dw[:, e·V + v] = x (compute dtype)ᵀ · dz (compute dtype)     float32 sums
//   db[e·V + v]    = sum_n dz                                      float32
//
// No dz is written to memory.
//
// What bounds it on the H100: the product, 2·N·D·E·V = 95.1 GFLOP at
// N = 14336, D = 640, E = V = 72 (0.096 ms on the bf16 tensor cores),
// against ~207 MB of bytes (th 149 MB, x 37 MB, dw 13 MB; 0.062 ms).
//
// Design: one block per (expert e, slice of NB columns of D) walks all row
// tiles of 64 rows in a fixed order, so no atomics and no cross-block sum
// are needed and the result does not depend on the schedule (the TPU
// kernel's grid (e, n) with n innermost, :509-512).  For each row tile it
// stages xᵀ for its slice ([NB][64], cast to the compute dtype) and the
// recomputed dz tile ([64][V]), double-buffered with one barrier a tile;
// dw_slice [NB, V] accumulates in registers (bf16: ldmatrix + mma.sync;
// float32: FMA).  Each element's mask is drawn at its global (n, e·V + v),
// so it is the mask of K5 and K6 whatever the walk.  The slice-0 blocks
// also sum db: each thread keeps one column's partial over its rows, and
// the two partials of a column are added in a fixed order at the end.  dz
// is recomputed by every slice of an expert (D / NB times) from th, which
// then comes from L2.

#include "tile_product.cuh"

namespace {

constexpr int kChunkN = 64;  // rows of N per step (the product's K)

struct WgradLayout {
  Layout l;               // product: K = kChunkN, N = V
  size_t x_elems, dz_elems, buf_bytes;
};

template <typename T>
__host__ __device__ WgradLayout wgrad_layout(int v) {
  WgradLayout g;
  g.l = layout<T>(kChunkN, v);
  g.x_elems = (size_t)Tile<T>::kRows * g.l.ldx;  // xᵀ [NB][ldx]
  g.dz_elems = (size_t)kChunkN * g.l.ldw;         // dz [64][ldw]
  g.buf_bytes = sizeof(T) * (g.x_elems + g.dz_elems);
  return g;
}

template <typename T>
__host__ __device__ size_t wgrad_smem(int v) {
  const WgradLayout g = wgrad_layout<T>(v);
  const size_t z_bytes = sizeof(float) * Tile<T>::kRows * (size_t)g.l.ldz;
  const size_t db_bytes = sizeof(float) * 2 * kMaxV;
  const size_t bufs = 2 * g.buf_bytes;
  return (bufs > z_bytes ? bufs : z_bytes) + db_bytes;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) moe_wgrad_kernel(
    const float* __restrict__ x,     // [N, D] float32
    const T* __restrict__ th,        // [N, E·V] compute dtype
    const float* __restrict__ gate,  // [N, E]
    const float* __restrict__ gout,  // [N, V]
    const int32_t* __restrict__ seed_dev,  // [1] (read if dropout)
    int n, int d, int experts, int v, float tau, float keep_prob,
    float* __restrict__ dw,          // [D, E·V]
    float* __restrict__ db) {        // [E·V]
  constexpr int kCols = Tile<T>::kRows;  // columns of D per block (M)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const WgradLayout gl = wgrad_layout<T>(v);
  const Layout& l = gl.l;
  const int e = blockIdx.x, d0 = blockIdx.y * kCols;
  const bool lead = blockIdx.y == 0;  // sums db
  const int ev = experts * v;
  const bool dropout = keep_prob < 1.0f;
  const float inv_keep = 1.0f / keep_prob;
  const uint32_t seed = dropout ? (uint32_t)seed_dev[0] : 0u;
  float* dbs = reinterpret_cast<float*>(smem_raw + wgrad_smem<T>(v) - sizeof(float) * 2 * kMaxV);
  // dz stage: thread owns column c and rows r0, r0 + 2, ...
  const int c = threadIdx.x % kMaxV, r0 = threadIdx.x / kMaxV;
  float db_part = 0.0f;

  typename Product<T>::Acc acc;
  acc.zero();
  const int tiles = (n + kChunkN - 1) / kChunkN;
  for (int t = 0; t < tiles; ++t) {
    const int n0 = t * kChunkN;
    T* xts = reinterpret_cast<T*>(smem_raw + (t & 1) * gl.buf_bytes);
    T* dzs = xts + gl.x_elems;
    // xᵀ: xts[j][r] = x[n0 + r, d0 + j]
    for (int i = threadIdx.x; i < kChunkN * kCols; i += kThreads) {
      const int r = i / kCols, j = i - r * kCols;
      const float val = (n0 + r < n && d0 + j < d) ? x[(size_t)(n0 + r) * d + d0 + j] : 0.0f;
      xts[j * l.ldx + r] = Dtype<T>::from_float(val);
    }
    if (c < l.vp) {
      for (int r = r0; r < kChunkN; r += kThreads / kMaxV) {
        const int nn = n0 + r;
        float dz = 0.0f;
        if (nn < n && c < v) {
          const float tt = Dtype<T>::to_float(th[(size_t)nn * ev + e * v + c]);
          dz = gate[(size_t)nn * experts + e] * gout[(size_t)nn * v + c] *
               (tau * (1.0f - tt * tt));
          if (dropout)
            dz *= drop_factor((uint32_t)nn, (uint32_t)(e * v + c), seed, keep_prob,
                              inv_keep);
          db_part += dz;
        }
        dzs[r * l.ldw + c] = Dtype<T>::from_float(dz);
      }
    }
    __syncthreads();
    acc.product(xts, dzs, 0, kChunkN, l);
  }

  __syncthreads();  // every warp is done with the buffers zs aliases
  float* zs = reinterpret_cast<float*>(smem_raw);
  acc.store(zs, l);
  if (lead) dbs[r0 * kMaxV + c] = db_part;
  __syncthreads();
  for (int i = threadIdx.x; i < kCols * v; i += kThreads) {
    const int j = i / v, cc = i - j * v;
    if (d0 + j < d) dw[(size_t)(d0 + j) * ev + e * v + cc] = zs[j * l.ldz + cc];
  }
  if (lead && threadIdx.x < v) db[e * v + threadIdx.x] = dbs[threadIdx.x] + dbs[kMaxV + threadIdx.x];
}

template <typename T>
int launch(int device, const void* x, const void* th, const void* gate,
           const void* gout, const void* seed, int n, int d, int experts, int v,
           float tau, float keep_prob, void* dw, void* db, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (v <= 0 || v > kMaxV || d <= 0 || experts <= 0 || n < 0) return cudaErrorInvalidValue;
  if (keep_prob < 1.0f && seed == nullptr) return cudaErrorInvalidValue;
  const size_t smem = wgrad_smem<T>(v);
  err = set_smem(moe_wgrad_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(experts, (d + Tile<T>::kRows - 1) / Tile<T>::kRows);
  moe_wgrad_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const T*)th, (const float*)gate, (const float*)gout,
      (const int32_t*)seed, n, d, experts, v, tau, keep_prob, (float*)dw, (float*)db);
  return cudaGetLastError();
}

}  // namespace

#define MOE_WGRAD_ARGS                                                        \
  int device, const void *x, const void *th, const void *gate,               \
      const void *gout, const void *seed, int n, int d, int experts, int v,  \
      float tau, float keep_prob, void *dw, void *db, void *stream
#define MOE_WGRAD_PASS \
  device, x, th, gate, gout, seed, n, d, experts, v, tau, keep_prob, dw, db, stream

extern "C" int moe_wgrad_f32(MOE_WGRAD_ARGS) { return launch<float>(MOE_WGRAD_PASS); }

extern "C" int moe_wgrad_bf16(MOE_WGRAD_ARGS) {
  return launch<__nv_bfloat16>(MOE_WGRAD_PASS);
}
