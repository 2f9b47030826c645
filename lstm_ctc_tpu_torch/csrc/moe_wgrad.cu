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
// What bounds it on the H100: the product, 2·N·D·E·V = 95.1 GFLOP at
// N = 14336, D = 640, E = V = 72 (0.096 ms on the bf16 tensor cores),
// against ~207 MB of bytes (th 149 MB, x 37 MB, dw 13 MB; 0.062 ms).
//
// bf16, the twokernel path: K7's two stages, any D.
//   1. dz once per element (moe_bwd.cu moe_dz_db_bf16: K6's dz units
//      without the dx product and the dgate sums, which K8 made), written
//      in bf16 to a scratch with rows E·V rounded up to 8 apart, and db's
//      float32 partials of the unrounded dz per 64-row tile; bit for bit
//      the dz and partials of K7's first stage.
//   2. moe_dw.cuh, K7's own second stage: db from the partials, x cast to
//      bf16, dw on wg_product.cuh's engine.
// So K9's (dw, db) are K7's bit for bit.  The TPU kernel makes dz inside
// the product; here each 128-wide tile of D would make it again (5 times
// at D = 640), and elementwise work already sets the pace of K4-K6, so dz
// is written once and read back (149 MB each way at the flagship).
//
// float32: the first design's FMA body, kept (D <= 1024).  One block per (expert e,
// slice of NB columns of D) walks all row tiles of 64 rows in a fixed
// order, so no atomics and no cross-block sum are needed (the TPU kernel's
// grid (e, n) with n innermost, :509-512).  For each row tile it stages xᵀ
// for its slice ([NB][64]) and the recomputed dz tile ([64][V]),
// double-buffered with one barrier a tile; dw_slice [NB, V] accumulates in
// registers (FMA).  Each element's mask is drawn at its global (n, e·V +
// v), so it is the mask of K5 and K6 whatever the walk.  The slice-0 blocks
// also sum db: each thread keeps one column's partial over its rows, and
// the two partials of a column are added in a fixed order at the end.  dz
// is recomputed by every slice of an expert (D / NB times) from th, which
// then comes from L2.

#include "moe_dw.cuh"

// K9's first stage (moe_bwd.cu)
extern "C" int moe_dz_db_bf16(int device, const void* th, const void* gate, const void* gout,
                              const void* seed, int n, int experts, int v, float tau,
                              float keep_prob, void* dz, int ldz, float* db_part, void* stream);

namespace {

constexpr int kChunkN = 64;  // rows of N per step (the product's K)

struct WgradLayout {
  Layout l;               // product: K = kChunkN, N = V
  size_t x_elems, dz_elems, buf_bytes;
};

__host__ __device__ WgradLayout wgrad_layout(int v) {
  WgradLayout g;
  g.l = layout<float>(kChunkN, v);
  g.x_elems = (size_t)Tile<float>::kRows * g.l.ldx;  // xᵀ [NB][ldx]
  g.dz_elems = (size_t)kChunkN * g.l.ldw;             // dz [64][ldw]
  g.buf_bytes = sizeof(float) * (g.x_elems + g.dz_elems);
  return g;
}

__host__ __device__ size_t wgrad_smem(int v) {
  const WgradLayout g = wgrad_layout(v);
  const size_t z_bytes = sizeof(float) * Tile<float>::kRows * (size_t)g.l.ldz;
  const size_t db_bytes = sizeof(float) * 2 * kMaxV;
  const size_t bufs = 2 * g.buf_bytes;
  return (bufs > z_bytes ? bufs : z_bytes) + db_bytes;
}

__global__ void __launch_bounds__(kThreads) moe_wgrad_kernel(
    const float* __restrict__ x,     // [N, D] float32
    const float* __restrict__ th,    // [N, E·V]
    const float* __restrict__ gate,  // [N, E]
    const float* __restrict__ gout,  // [N, V]
    const int32_t* __restrict__ seed_dev,  // [1] (read if dropout)
    int n, int d, int experts, int v, float tau, float keep_prob,
    float* __restrict__ dw,          // [D, E·V]
    float* __restrict__ db) {        // [E·V]
  constexpr int kCols = Tile<float>::kRows;  // columns of D per block (M)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const WgradLayout gl = wgrad_layout(v);
  const Layout& l = gl.l;
  const int e = blockIdx.x, d0 = blockIdx.y * kCols;
  const bool lead = blockIdx.y == 0;  // sums db
  const int ev = experts * v;
  const bool dropout = keep_prob < 1.0f;
  const float inv_keep = 1.0f / keep_prob;
  const uint32_t seed = dropout ? (uint32_t)seed_dev[0] : 0u;
  float* dbs = reinterpret_cast<float*>(smem_raw + wgrad_smem(v) - sizeof(float) * 2 * kMaxV);
  // dz stage: thread owns column c and rows r0, r0 + 2, ...
  const int c = threadIdx.x % kMaxV, r0 = threadIdx.x / kMaxV;
  float db_part = 0.0f;

  FmaAcc acc;
  acc.zero();
  const int tiles = (n + kChunkN - 1) / kChunkN;
  for (int t = 0; t < tiles; ++t) {
    const int n0 = t * kChunkN;
    float* xts = reinterpret_cast<float*>(smem_raw + (t & 1) * gl.buf_bytes);
    float* dzs = xts + gl.x_elems;
    // xᵀ: xts[j][r] = x[n0 + r, d0 + j]
    for (int i = threadIdx.x; i < kChunkN * kCols; i += kThreads) {
      const int r = i / kCols, j = i - r * kCols;
      const float val = (n0 + r < n && d0 + j < d) ? x[(size_t)(n0 + r) * d + d0 + j] : 0.0f;
      xts[j * l.ldx + r] = val;
    }
    if (c < l.vp) {
      for (int r = r0; r < kChunkN; r += kThreads / kMaxV) {
        const int nn = n0 + r;
        float dz = 0.0f;
        if (nn < n && c < v) {
          const float tt = th[(size_t)nn * ev + e * v + c];
          dz = gate[(size_t)nn * experts + e] * gout[(size_t)nn * v + c] *
               (tau * (1.0f - tt * tt));
          if (dropout)
            dz *= drop_factor((uint32_t)nn, (uint32_t)(e * v + c), seed, keep_prob,
                              inv_keep);
          db_part += dz;
        }
        dzs[r * l.ldw + c] = dz;
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

int launch_f32(int device, const void* x, const void* th, const void* gate, const void* gout,
               const void* seed, int n, int d, int experts, int v, float tau, float keep_prob,
               void* dw, void* db, void*, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (v <= 0 || v > kMaxV || d <= 0 || experts <= 0 || n < 0) return cudaErrorInvalidValue;
  if (keep_prob < 1.0f && seed == nullptr) return cudaErrorInvalidValue;
  const size_t smem = wgrad_smem(v);
  err = set_smem(moe_wgrad_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(experts, (d + Tile<float>::kRows - 1) / Tile<float>::kRows);
  moe_wgrad_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)th, (const float*)gate, (const float*)gout,
      (const int32_t*)seed, n, d, experts, v, tau, keep_prob, (float*)dw, (float*)db);
  return cudaGetLastError();
}

int launch_bf16(int device, const void* x, const void* th, const void* gate, const void* gout,
                const void* seed, int n, int d, int experts, int v, float tau, float keep_prob,
                void* dw, void* db, void* scratch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (v <= 0 || v > kMaxV || d <= 0 || experts <= 0 || n < 0) return cudaErrorInvalidValue;
  if (keep_prob < 1.0f && seed == nullptr) return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int kk = experts * v;
  if (n == 0) {
    err = cudaMemsetAsync(dw, 0, sizeof(float) * d * kk, s);
    return err != cudaSuccess ? err : cudaMemsetAsync(db, 0, sizeof(float) * kk, s);
  }
  const int sms = device_sms(device);
  if (sms <= 0) return cudaErrorInvalidDevice;
  const Bf16Plan p = bf16_plan(n, d, experts, v, sms);
  float* base = scratch_base(scratch);
  err = (cudaError_t)moe_dz_db_bf16(device, th, gate, gout, seed, n, experts, v, tau, keep_prob,
                                    base + p.dz, p.ldz, base + p.db_part, stream);
  if (err != cudaSuccess) return err;
  return dw_db_from_dz(x, n, d, kk, p, base, dw, db, sms, s);
}

}  // namespace

// device, x, th, gate, gout, seed, N, D, E, V, tau, keep_prob, dw, db,
// scratch (bf16: moe_bwd_wgrad_scratch_floats's, the plan K7's stage 2
// shares; float32: none), stream
#define MOE_WGRAD_ARGS                                                        \
  int device, const void *x, const void *th, const void *gate,               \
      const void *gout, const void *seed, int n, int d, int experts, int v,  \
      float tau, float keep_prob, void *dw, void *db, void *scratch,         \
      void *stream
#define MOE_WGRAD_PASS                                                       \
  device, x, th, gate, gout, seed, n, d, experts, v, tau, keep_prob, dw, db, \
      scratch, stream

extern "C" int moe_wgrad_f32(MOE_WGRAD_ARGS) { return launch_f32(MOE_WGRAD_PASS); }

extern "C" int moe_wgrad_bf16(MOE_WGRAD_ARGS) { return launch_bf16(MOE_WGRAD_PASS); }
