// K7: the MoE head's whole backward: dx and dgate as K6, and the expert
// weight and bias gradients from the same dz.
//
// Replaces the TPU kernel lstm_ctc_tpu/ops/moe_pallas.py _bwd_kernel_wgrad
// (:311-333), launched by _pallas_bwd_wgrad (:428) from fused_bwd
// (:554-556) under LSTM_CTC_TPU_MOE_WGRAD=kernel.  From x, the stash th =
// tanh(x·W + b) [N, E·V] that K5 wrote, the gate [N, E], gout [N, V] and
// the hash mask m at global (n, e·V + v):
//
//   a     = tau · th · m
//   dz    = gate[n, e] · gout[n, v] · tau (1 - th²) · m      (float32)
//   dgate = sum_v gout[n, v] · a[n, e, v]                    float32
//   dx    = dz (compute dtype) · Wᵀ                            float32 sums
//   dw    = x (compute dtype)ᵀ · dz (compute dtype)            float32 sums
//   db    = sum_n dz                                          float32
//
// What bounds it on the H100: the two products, 2·N·D·E·V each, 190.2
// GFLOP at N = 14336, D = 640, E = V = 72 (0.19 ms on the bf16 tensor
// cores), against ~213 MB of bytes (th 149 MB, x and dx 37 MB each; 0.064
// ms).
//
// Why no one pass.  On the TPU the grid runs in order, so one dw in VMEM
// carries the sum over every row block.  Here blocks run in parallel: dx
// sums over the experts and dw over the rows, so one of the two sums must
// cross blocks.  dw is [D, E·V] float32 (13.3 MB at the flagship), more
// than the SMs' shared memory holds beside the operands, so a deterministic
// one-pass kernel must either make dz again for each slice of D or write a
// dw partial for each row group, which is what the float32 body below does
// and pays for both.
//
// bf16, the main path: two stages, as K3 is K2's launch and its products.
//   1. K6's bf16 body (moe_bwd.cu moe_bwd_dz_db_bf16): dz made once per
//      element, dx and dgate bit for bit K6's; dz written in bf16 to a
//      scratch with rows E·V rounded up to 8 apart; and db's partials, the
//      float32 sums of the unrounded dz per 64-row tile, which a last pass
//      adds over the tiles in wg_product.cuh's group_sum order.
//   2. dw = x(bf16)ᵀ · dz(bf16) on wg_product.cuh's engine (MN-major: both
//      operands' rows are the depth), x cast to bf16 rows padded to 8 by one
//      pass; the depth split over blocks where the (D/128)·(E·V/128) tiles
//      cannot fill the card, the partials added in split order
//      (moe_dw.cuh, shared with K9, whose first stage makes the same dz
//      and db partials without dx and dgate).
// No atomics: the results do not depend on the schedule.
//
// float32: one kernel.  One block owns a slice of kM columns of D and a
// group of kGroupRows rows (kM-row tiles), and walks the experts in the
// outer loop and its row tiles in the inner one:
//   * dx of its rows and columns accumulates over the experts in shared
//     memory (each element by the thread that holds it in the tile product);
//   * dw of its columns and expert e accumulates over its row tiles in
//     registers and is written once per expert, as the group's partial;
//   * a second pass (common.cuh's split_sum_kernel) adds the groups'
//     partials of dw and db in a fixed order.
// For each (row tile, expert) the block stages xᵀ of its slice and
// computes the dz tile into shared memory, with W_eᵀ of its slice staged
// once per expert; the products are tile_product.cuh's FMA (no TF32).
// Every slice of a row tile recomputes dz from th, which then comes from
// L2, and the blocks of slice 0 write dgate and sum db (each thread one
// column's sum over its rows, the 16 sums of a column added in a fixed
// order).  The partials take groups · D · E·V floats.

#include "moe_dw.cuh"

// K7's first stage: K6's bf16 body with dz rows `ldz` apart and db's
// partials per 64-row tile (moe_bwd.cu)
extern "C" int moe_bwd_dz_db_bf16(int device, const void* th, const void* w, const void* gate,
                                  const void* gout, const void* seed, int n, int d, int experts,
                                  int v, float tau, float keep_prob, void* dx, void* dgate,
                                  void* dz, void* stream, int ldz, float* db_part);

namespace {

constexpr int kGroupRows = 512;  // rows of N per block
constexpr int kRowLanes = 16;    // threads per row in the dz stage
constexpr int kRowsPerPass = kThreads / kRowLanes;

__host__ __device__ constexpr size_t align16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// Shared-memory plan: the dx accumulators of the group's row tiles, W_eᵀ
// of the slice, the dz tile, xᵀ of the slice, dw's store and db's sums
struct Plan {
  Layout dxl;  // dx product: K = V, N = kM
  Layout dwl;  // dw product: K = kM rows, N = V
  size_t dxs, ws, dzs, xts, zs, dbs, bytes;
};

__host__ __device__ Plan plan(int v) {
  constexpr int kM = Tile<float>::kRows;
  Plan p;
  p.dxl = layout<float>(v, kM);
  p.dwl = layout<float>(kM, v);  // its B (dz) rows: dwl.ldw == dxl.ldx
  size_t o = 0;
  p.dxs = o;
  o += align16(sizeof(float) * (kGroupRows / kM) * kM * p.dxl.ldz);
  p.ws = o;
  o += align16(sizeof(float) * p.dxl.dp * p.dxl.ldw);
  p.dzs = o;
  o += align16(sizeof(float) * kM * p.dxl.ldx);
  p.xts = o;
  o += align16(sizeof(float) * kM * p.dwl.ldx);
  p.zs = o;
  o += align16(sizeof(float) * kM * p.dwl.ldz);
  p.dbs = o;
  o += sizeof(float) * kRowsPerPass * kMaxV;
  p.bytes = o;
  return p;
}

__global__ void __launch_bounds__(kThreads) moe_bwd_wgrad_kernel(
    const float* __restrict__ x,     // [N, D] float32
    const float* __restrict__ th,    // [N, E·V]
    const float* __restrict__ w,     // [D, E·V]
    const float* __restrict__ gate,  // [N, E]
    const float* __restrict__ gout,  // [N, V]
    const int32_t* __restrict__ seed_dev,  // [1] (read if dropout)
    int n, int d, int experts, int v, float tau, float keep_prob,
    float* __restrict__ dx,          // [N, D]
    float* __restrict__ dgate,       // [N, E]
    float* __restrict__ dw_part,     // [groups, D, E·V]
    float* __restrict__ db_part) {   // [groups, E·V]
  constexpr int kM = Tile<float>::kRows;
  constexpr int kTiles = kGroupRows / kM;
  constexpr int kCols = kMaxV / kRowLanes;  // dz columns per thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Plan p = plan(v);
  float* dxs = reinterpret_cast<float*>(smem_raw + p.dxs);
  float* ws = reinterpret_cast<float*>(smem_raw + p.ws);
  float* dzs = reinterpret_cast<float*>(smem_raw + p.dzs);
  float* xts = reinterpret_cast<float*>(smem_raw + p.xts);
  float* zs = reinterpret_cast<float*>(smem_raw + p.zs);
  float* dbs = reinterpret_cast<float*>(smem_raw + p.dbs);
  const int d0 = blockIdx.x * kM, group = blockIdx.y;
  const int g0 = group * kGroupRows;
  const int tiles = min(kTiles, cdiv(n - g0, kM));
  const bool lead = blockIdx.x == 0;  // writes dgate and sums db
  const int ev = experts * v;
  const bool dropout = keep_prob < 1.0f;
  const float inv_keep = 1.0f / keep_prob;
  const uint32_t seed = dropout ? (uint32_t)seed_dev[0] : 0u;
  const int rlane = threadIdx.x % kRowLanes, rsub = threadIdx.x / kRowLanes;
  const int dx_tile = kM * p.dxl.ldz;

  for (int i = threadIdx.x; i < kTiles * dx_tile; i += kThreads) dxs[i] = 0.0f;

  for (int e = 0; e < experts; ++e) {
    // W_eᵀ for this slice: ws[c][j] = W[d0 + j, e·V + c], zero padded
    for (int i = threadIdx.x; i < kM * p.dxl.dp; i += kThreads) {
      const int j = i / p.dxl.dp, c = i - j * p.dxl.dp;
      ws[c * p.dxl.ldw + j] = (c < v && d0 + j < d) ? w[(size_t)(d0 + j) * ev + e * v + c]
                                                    : 0.0f;
    }
    float db_sum[kCols] = {};
    FmaAcc acc_dw;
    acc_dw.zero();
    for (int t = 0; t < tiles; ++t) {
      const int n0 = g0 + t * kM;
      // xᵀ of the slice: xts[j][r] = x[n0 + r, d0 + j]
      for (int i = threadIdx.x; i < kM * kM; i += kThreads) {
        const int r = i / kM, j = i - r * kM;
        const float val = (n0 + r < n && d0 + j < d) ? x[(size_t)(n0 + r) * d + d0 + j] : 0.0f;
        xts[j * p.dwl.ldx + r] = val;
      }
      // dz of the row tile for expert e, dgate[:, e] and db's sums
      for (int r0 = 0; r0 < kM; r0 += kRowsPerPass) {
        const int r = r0 + rsub, nn = n0 + r;
        const bool row_ok = nn < n;
        const float g = row_ok ? gate[(size_t)nn * experts + e] : 0.0f;
        float dg = 0.0f;
#pragma unroll
        for (int jc = 0; jc < kCols; ++jc) {
          const int c = rlane + kRowLanes * jc;
          if (c < p.dxl.dp) {
            float dz = 0.0f;
            if (row_ok && c < v) {
              const float tt = th[(size_t)nn * ev + e * v + c];
              const float q = gout[(size_t)nn * v + c];
              float a = tau * tt;
              dz = g * q * (tau * (1.0f - tt * tt));
              if (dropout) {
                const float m = drop_factor((uint32_t)nn, (uint32_t)(e * v + c), seed,
                                            keep_prob, inv_keep);
                a *= m;
                dz *= m;
              }
              dg = fmaf(q, a, dg);
              db_sum[jc] += dz;
            }
            dzs[r * p.dxl.ldx + c] = dz;
          }
        }
#pragma unroll
        for (int off = kRowLanes / 2; off > 0; off >>= 1)
          dg += __shfl_xor_sync(0xffffffffu, dg, off);
        if (lead && row_ok && rlane == 0) dgate[(size_t)nn * experts + e] = dg;
      }
      __syncthreads();
      FmaAcc acc_dx;
      acc_dx.zero();
      acc_dx.product(dzs, ws, 0, p.dxl.dp, p.dxl);
      acc_dx.accumulate(dxs + t * dx_tile, p.dxl);
      acc_dw.product(xts, dzs, 0, kM, p.dwl);
      __syncthreads();  // before the next tile's dz and xᵀ
    }
    // the group's partial of dw[slice, e·V : (e+1)·V] and of db
    acc_dw.store(zs, p.dwl);
    if (lead) {
#pragma unroll
      for (int jc = 0; jc < kCols; ++jc) dbs[rsub * kMaxV + rlane + kRowLanes * jc] = db_sum[jc];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kM * v; i += kThreads) {
      const int j = i / v, c = i - j * v;
      if (d0 + j < d)
        dw_part[((size_t)group * d + d0 + j) * ev + e * v + c] = zs[j * p.dwl.ldz + c];
    }
    if (lead && threadIdx.x < v) {
      float s = 0.0f;
      for (int q = 0; q < kRowsPerPass; ++q) s += dbs[q * kMaxV + threadIdx.x];
      db_part[(size_t)group * ev + e * v + threadIdx.x] = s;
    }
    // zs, dbs and ws are next written after the barriers of the next
    // expert's first tile
  }

  __syncthreads();  // every thread's accumulation into dxs is done
  for (int t = 0; t < tiles; ++t) {
    const int n0 = g0 + t * kM;
    for (int i = threadIdx.x; i < kM * kM; i += kThreads) {
      const int r = i / kM, j = i - r * kM;
      if (n0 + r < n && d0 + j < d)
        dx[(size_t)(n0 + r) * d + d0 + j] = dxs[t * dx_tile + r * p.dxl.ldz + j];
    }
  }
}

size_t f32_scratch_floats(int n, int d, int experts, int v) {
  const size_t groups = (size_t)cdiv(n, kGroupRows);
  return groups * ((size_t)d + 1) * experts * v;
}

int launch_f32(int device, const void* x, const void* th, const void* w, const void* gate,
               const void* gout, const void* seed, int n, int d, int experts, int v, float tau,
               float keep_prob, void* dx, void* dgate, void* dw, void* db, void* scratch,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (v <= 0 || v > kMaxV || d <= 0 || experts <= 0 || n < 0) return cudaErrorInvalidValue;
  if (keep_prob < 1.0f && seed == nullptr) return cudaErrorInvalidValue;
  const int groups = cdiv(n, kGroupRows), ev = experts * v;
  float* dw_part = (float*)scratch;
  float* db_part = dw_part + (size_t)groups * d * ev;
  const cudaStream_t s = (cudaStream_t)stream;
  if (groups > 0) {
    const Plan p = plan(v);
    err = set_smem(moe_bwd_wgrad_kernel, p.bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((d + Tile<float>::kRows - 1) / Tile<float>::kRows, groups);
    moe_bwd_wgrad_kernel<<<grid, kThreads, p.bytes, s>>>(
        (const float*)x, (const float*)th, (const float*)w, (const float*)gate,
        (const float*)gout, (const int32_t*)seed, n, d, experts, v, tau, keep_prob,
        (float*)dx, (float*)dgate, dw_part, db_part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  split_sum_kernel<<<264, 256, 0, s>>>(dw_part, groups, (size_t)d * ev, (float*)dw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_sum_kernel<<<cdiv(ev, 256), 256, 0, s>>>(db_part, groups, (size_t)ev, (float*)db);
  return cudaGetLastError();
}

// ---- bf16: K6's body, then the engine ----

int launch_bf16(int device, const void* x, const void* th, const void* w, const void* gate,
                const void* gout, const void* seed, int n, int d, int experts, int v, float tau,
                float keep_prob, void* dx, void* dgate, void* dw, void* db, void* scratch,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (v <= 0 || v > kMaxV || d <= 0 || experts <= 0 || n < 0) return cudaErrorInvalidValue;
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
  err = (cudaError_t)moe_bwd_dz_db_bf16(device, th, w, gate, gout, seed, n, d, experts, v, tau,
                                        keep_prob, dx, dgate, base + p.dz, stream, p.ldz,
                                        base + p.db_part);
  if (err != cudaSuccess) return err;
  return dw_db_from_dz(x, n, d, kk, p, base, dw, db, sms, s);
}

}  // namespace

// device, x, th, w, gate, gout, seed, N, D, E, V, tau, keep_prob, dx, dgate,
// dw, db, scratch (moe_bwd_wgrad_scratch_floats), stream; bf16: w is the
// packed image of ops/moe_kernels.py bwd_pack (K6's)
#define MOE_BWD_WGRAD_ARGS                                                      \
  int device, const void *x, const void *th, const void *w, const void *gate,  \
      const void *gout, const void *seed, int n, int d, int experts, int v,    \
      float tau, float keep_prob, void *dx, void *dgate, void *dw, void *db,   \
      void *scratch, void *stream
#define MOE_BWD_WGRAD_PASS                                                       \
  device, x, th, w, gate, gout, seed, n, d, experts, v, tau, keep_prob, dx,     \
      dgate, dw, db, scratch, stream

extern "C" int moe_bwd_wgrad_f32(MOE_BWD_WGRAD_ARGS) { return launch_f32(MOE_BWD_WGRAD_PASS); }

extern "C" int moe_bwd_wgrad_bf16(MOE_BWD_WGRAD_ARGS) { return launch_bf16(MOE_BWD_WGRAD_PASS); }

// Scratch floats K7 needs on ``device`` at this shape and compute dtype; -1
// if the device's SM count cannot be read
extern "C" long long moe_bwd_wgrad_scratch_floats(int device, int n, int d, int experts, int v,
                                                  int bf16) {
  if (!bf16) return (long long)f32_scratch_floats(n, d, experts, v);
  const int sms = device_sms(device);
  return sms <= 0 ? -1 : (long long)bf16_plan(n, d, experts, v, sms).floats;
}
