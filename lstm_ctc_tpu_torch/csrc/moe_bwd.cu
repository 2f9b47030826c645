// K6 and K8: the MoE head's fused expert mix, backward to x and the gate.
//
// Replaces the TPU kernels lstm_ctc_tpu/ops/moe_pallas.py _bwd_kernel
// (:271-280, K6, launched by _pallas_bwd :391) and _bwd_kernel_noemit
// (:282-287, K8, launched by _pallas_bwd_noemit :475), whose math is
// _dz_core (:222-243) and _bwd_dz (:245-269).  From the stash th = tanh(x·W
// + b) [N, E·V] that K5 wrote, the output cotangent gout [N, V], the gate
// [N, E] and the same hash mask m at global (n, e·V + v):
//
//   a     = tau · th · m
//   dz    = gate[n, e] · gout[n, v] · tau (1 - th²) · m
//   dgate = sum_v gout[n, v] · a[n, e, v]             float32
//   dx    = dz (compute dtype) · Wᵀ                     float32 sums
//
// K6 also writes dz in the compute dtype, for the weight gradient dw =
// xᵀ·dz that stays one torch.matmul outside (as it is one XLA dot outside
// the Pallas kernel there).  K8, the first pass of the opt-in "twokernel"
// backward, does not: K9 (moe_wgrad.cu) recomputes dz for dw and db.
//
// What bounds it on the H100: bytes.  At N = 14336, D = 640, E = V = 72 it
// reads th (149 MB in bf16) and writes dz (149 MB), dx (37 MB) and small
// rest, ~353 MB or 0.105 ms at 3.35 TB/s, against 2·N·D·E·V = 95.1 GFLOP
// of the dx product (0.096 ms on the bf16 tensor cores).  K8 writes no dz
// and is bound by its operations.
//
// Design: a [NB, D] float32 dx tile of a row tile is too large for one
// block's registers (64 × 640 × 4 bytes), so one block owns a (row tile of
// NB rows, slice of 128 columns of D) and loops over the experts.  For
// each expert it computes the elementwise dz of its row tile into shared
// memory (rounded to the compute dtype) and stages W_eᵀ for its slice
// ([V][128], zero padded); the two are double-buffered, so one barrier a
// expert suffices, and the product dz_e · W_eᵀ accumulates in registers
// (bf16: ldmatrix + mma.sync; float32: FMA, no TF32).  Only the blocks of
// slice 0 write dz and dgate; the others recompute dz and read the row
// tile's th from L2.  dgate sums the 16 lanes of a row with shuffles in a
// fixed order.  No atomics: the result does not depend on the schedule.

#include "tile_product.cuh"

namespace {

constexpr int kSlice = 128;     // columns of D per block (the product's N)
constexpr int kRowLanes = 16;   // threads per row in the dz stage

struct BwdLayout {
  Layout l;               // product: K = V, N = kSlice
  size_t dz_elems, w_elems, buf_bytes;
};

template <typename T>
__host__ __device__ BwdLayout bwd_layout(int v) {
  BwdLayout b;
  b.l = layout<T>(v, kSlice);
  b.dz_elems = (size_t)Tile<T>::kRows * b.l.ldx;  // dz tile [NB][ldx]
  b.w_elems = (size_t)b.l.dp * b.l.ldw;           // W_eᵀ slice [vp16][ldw]
  b.buf_bytes = sizeof(T) * (b.dz_elems + b.w_elems);
  return b;
}

template <typename T>
size_t bwd_smem(int v) {
  const BwdLayout b = bwd_layout<T>(v);
  const size_t z_bytes = sizeof(float) * Tile<T>::kRows * (size_t)b.l.ldz;
  return 2 * b.buf_bytes > z_bytes ? 2 * b.buf_bytes : z_bytes;
}

template <typename T, bool kEmit>
__global__ void __launch_bounds__(kThreads) moe_bwd_kernel(
    const T* __restrict__ th,        // [N, E·V] compute dtype
    const T* __restrict__ w,         // [D, E·V] compute dtype
    const float* __restrict__ gate,  // [N, E]
    const float* __restrict__ gout,  // [N, V]
    const int32_t* __restrict__ seed_dev,  // [1] (read if dropout)
    int n, int d, int experts, int v, float tau, float keep_prob,
    float* __restrict__ dx,          // [N, D]
    float* __restrict__ dgate,       // [N, E]
    T* __restrict__ dz_out) {        // [N, E·V] (K6)
  constexpr int kRows = Tile<T>::kRows;
  constexpr int kRowsPerPass = kThreads / kRowLanes;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const BwdLayout bl = bwd_layout<T>(v);
  const Layout& l = bl.l;
  // the D slices of one row tile are neighbours in the grid, so they run
  // together and share the tile's th through L2
  const int d0 = blockIdx.x * kSlice, n0 = blockIdx.y * kRows;
  const bool lead = blockIdx.x == 0;  // writes dz and dgate
  const int ev = experts * v;
  const bool dropout = keep_prob < 1.0f;
  const float inv_keep = 1.0f / keep_prob;
  const uint32_t seed = dropout ? (uint32_t)seed_dev[0] : 0u;
  const int rlane = threadIdx.x % kRowLanes, rsub = threadIdx.x / kRowLanes;

  typename Product<T>::Acc acc;
  acc.zero();
  for (int e = 0; e < experts; ++e) {
    T* dzs = reinterpret_cast<T*>(smem_raw + (e & 1) * bl.buf_bytes);
    T* ws = dzs + bl.dz_elems;
    // W_eᵀ for this slice: ws[c][j] = W[d0 + j, e·V + c], zero padded
    for (int i = threadIdx.x; i < kSlice * l.dp; i += kThreads) {
      const int j = i / l.dp, c = i - j * l.dp;
      ws[c * l.ldw + j] = (c < v && d0 + j < d) ? w[(size_t)(d0 + j) * ev + e * v + c]
                                                : Dtype<T>::from_float(0.0f);
    }
    // dz of the row tile for expert e, and dgate[:, e]
    for (int r0 = 0; r0 < kRows; r0 += kRowsPerPass) {
      const int r = r0 + rsub, nn = n0 + r;
      const bool row_ok = nn < n;
      const float g = row_ok ? gate[(size_t)nn * experts + e] : 0.0f;
      float dg = 0.0f;
#pragma unroll
      for (int jc = 0; jc < kMaxV / kRowLanes; ++jc) {
        const int c = rlane + kRowLanes * jc;
        if (c < l.dp) {
          float dz = 0.0f;
          if (row_ok && c < v) {
            const float t = Dtype<T>::to_float(th[(size_t)nn * ev + e * v + c]);
            const float q = gout[(size_t)nn * v + c];
            float a = tau * t;
            dz = g * q * (tau * (1.0f - t * t));
            if (dropout) {
              const float m = drop_factor((uint32_t)nn, (uint32_t)(e * v + c), seed,
                                          keep_prob, inv_keep);
              a *= m;
              dz *= m;
            }
            dg = fmaf(q, a, dg);
          }
          const T dzc = Dtype<T>::from_float(dz);
          dzs[r * l.ldx + c] = dzc;
          if (kEmit && lead && row_ok && c < v) dz_out[(size_t)nn * ev + e * v + c] = dzc;
        }
      }
#pragma unroll
      for (int off = kRowLanes / 2; off > 0; off >>= 1)
        dg += __shfl_xor_sync(0xffffffffu, dg, off);
      if (lead && row_ok && rlane == 0) dgate[(size_t)nn * experts + e] = dg;
    }
    __syncthreads();
    acc.product(dzs, ws, 0, l.dp, l);
  }

  __syncthreads();  // every warp is done with the buffers zs aliases
  float* zs = reinterpret_cast<float*>(smem_raw);
  acc.store(zs, l);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * kSlice; i += kThreads) {
    const int r = i / kSlice, j = i - r * kSlice;
    if (n0 + r < n && d0 + j < d) dx[(size_t)(n0 + r) * d + d0 + j] = zs[r * l.ldz + j];
  }
}

template <typename T>
int launch(int device, const void* th, const void* w, const void* gate,
           const void* gout, const void* seed, int n, int d, int experts, int v,
           float tau, float keep_prob, void* dx, void* dgate, void* dz,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  if (v <= 0 || v > kMaxV || d <= 0 || experts <= 0) return cudaErrorInvalidValue;
  if (keep_prob < 1.0f && seed == nullptr) return cudaErrorInvalidValue;
  if ((n + Tile<T>::kRows - 1) / Tile<T>::kRows > 65535) return cudaErrorInvalidValue;
  const size_t smem = bwd_smem<T>(v);
  const dim3 grid((d + kSlice - 1) / kSlice, (n + Tile<T>::kRows - 1) / Tile<T>::kRows);
  if (dz != nullptr) {
    err = set_smem(moe_bwd_kernel<T, true>, smem);
    if (err != cudaSuccess) return err;
    moe_bwd_kernel<T, true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const T*)th, (const T*)w, (const float*)gate, (const float*)gout,
        (const int32_t*)seed, n, d, experts, v, tau, keep_prob, (float*)dx,
        (float*)dgate, (T*)dz);
  } else {
    err = set_smem(moe_bwd_kernel<T, false>, smem);
    if (err != cudaSuccess) return err;
    moe_bwd_kernel<T, false><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const T*)th, (const T*)w, (const float*)gate, (const float*)gout,
        (const int32_t*)seed, n, d, experts, v, tau, keep_prob, (float*)dx,
        (float*)dgate, nullptr);
  }
  return cudaGetLastError();
}

}  // namespace

// dz == NULL launches K8 (no dz stream); otherwise K6
#define MOE_BWD_ARGS                                                          \
  int device, const void *th, const void *w, const void *gate,               \
      const void *gout, const void *seed, int n, int d, int experts, int v,  \
      float tau, float keep_prob, void *dx, void *dgate, void *dz, void *stream
#define MOE_BWD_PASS \
  device, th, w, gate, gout, seed, n, d, experts, v, tau, keep_prob, dx, dgate, dz, stream

extern "C" int moe_bwd_f32(MOE_BWD_ARGS) { return launch<float>(MOE_BWD_PASS); }

extern "C" int moe_bwd_bf16(MOE_BWD_ARGS) {
  return launch<__nv_bfloat16>(MOE_BWD_PASS);
}
