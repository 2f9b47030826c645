// K2's weight-gradient pass (lstm_bwd.cu runs it after the recurrence): the
// products the TPU kernel accumulates in VMEM step by step
// (lstm_ctc_tpu/ops/lstm_pallas.py :331-371), over the streams the
// recurrence wrote, for both directions g:
//
//   dwh[g]   = Σ_(t,b) h_prev_kept[g]ᵀ · dgates[g]   M = P, N = 4H
//   dproj[g] = Σ_(t,b) out_blk[g]ᵀ · dout_p[g]        M = H, N = P
//
// with K = T·B rows each, operands rounded to the compute dtype, float32
// sums; then common.cuh's fixed-order split_sum_kernel adds the row
// splits' partial sums of each product, and the recurrence's per-row-tile
// peephole partials.
//
// In bf16 the products run on the tensor cores: a block owns a 64x128
// output tile of one direction and one split of the rows, and stages both
// operands (which arrive with the rows as their leading index) chunk by
// chunk of 32 rows into shared memory as [k][m] and [k][n], 16 bytes a
// thread, double-buffered, loading the next chunk into registers while the
// tensor cores work on the current one; ldmatrix.trans gives the
// fragments of both, and mma.sync m16n8k16 accumulates in float32.  Eight
// warps of 32x32 each.  In float32 (never TF32) the products are
// lstm_bwd_common.cuh's FMA tile GEMM.  Its own
// translation unit, since lstm_bwd_common.cuh and lstm_cluster.cuh (the
// recurrence's) define the same names.

#include <type_traits>

#include "lstm_bwd_common.cuh"
#include "lstm_bwd_entry.cuh"

namespace {

constexpr int kTM = 64, kTN = 128, kTK = 32;  // tensor-core tile and row chunk
constexpr int kTThreads = 256;
constexpr int kLdA = kTM + 8, kLdB = kTN + 8;  // 16 bytes of padding a row

// One operand of a weight-gradient product: row k = s·B + b of group
// (direction) g is [width] values of a [S, 2B, width] stream at step s or,
// with `prev`, at step s - 1 times keep[s, b] (the states a step starts
// from; zero at s = 0).
template <typename X>
struct Stream {
  const X* x;
  const float* keep;
  int batch, width;
  bool prev;
  // the row's first value (null: a zero row) and its scale
  __device__ const X* row(int g, int k, float* scale) const {
    const int s = k / batch, b = k - s * batch;
    *scale = prev && keep ? keep[(size_t)s * batch + b] : 1.0f;
    if (prev && s == 0) return nullptr;
    return x + ((size_t)(prev ? s - 1 : s) * 2 * batch + (size_t)g * batch + b) * width;
  }
  // one value, as lstm_bwd_common.cuh's FMA product reads its operands
  __device__ float operator()(int g, int s, int b, int m) const {
    float scale;
    const X* r = row(g, s * batch + b, &scale);
    return r ? scale * ld(r, m) : 0.0f;
  }
};

// eight values of a row from column c, as four bf16 pairs: one 16-byte load
// in bf16 (two in float32) when they lie inside the row and aligned, else
// one at a time (zero past `cols`)
template <typename X>
__device__ __forceinline__ uint4 load8(const X* row, float scale, int c, int cols,
                                       bool vec) {
  float v[8];
  if (row != nullptr && vec && c + 8 <= cols) {
    if constexpr (std::is_same<X, float>::value) {
      const float4 lo = *reinterpret_cast<const float4*>(row + c);
      const float4 hi = *reinterpret_cast<const float4*>(row + c + 4);
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    } else {
      const uint4 q = *reinterpret_cast<const uint4*>(row + c);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
        v[2 * i] = __low2float(h);
        v[2 * i + 1] = __high2float(h);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = row != nullptr && c + i < cols ? Dtype<X>::to_float(row[c + i]) : 0.0f;
  }
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i] * scale, v[2 * i + 1] * scale);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// partial[split][g][m][n] = Σ over the split's rows k of a(g, k)[m] ·
// bm(g, k)[n], operands rounded to bf16.  Each thread stages 8 columns of
// one row of A and of two rows of B a chunk.
template <typename XA, typename XB>
__global__ void __launch_bounds__(kTThreads) tc_wgrad_kernel(
    Stream<XA> a, Stream<XB> bm, int rows, int M, int N, int split_rows,
    float* __restrict__ partial) {
  __shared__ __align__(16) __nv_bfloat16 as[2][kTK][kLdA];
  __shared__ __align__(16) __nv_bfloat16 bs[2][kTK][kLdB];
  const int g = blockIdx.z % 2, split = blockIdx.z / 2;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  const int k_begin = split * split_rows;
  const int k_end = min(rows, k_begin + split_rows);
  // A: row tid / 8, columns 8·(tid % 8); B: rows tid / 16 and + 16,
  // columns 8·(tid % 16)
  const int ka = tid >> 3, ca = 8 * (tid & 7), kb = tid >> 4, cb = 8 * (tid & 15);
  const bool vec_a = a.width * sizeof(XA) % 16 == 0;
  const bool vec_b = bm.width * sizeof(XB) % 16 == 0;
  uint4 ra, rb[2];
  auto fetch = [&](int k0) {
    float scale = 0.0f;
    const XA* pa = k0 + ka < k_end ? a.row(g, k0 + ka, &scale) : nullptr;
    ra = load8(pa, scale, m0 + ca, M, vec_a);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const XB* pb = k0 + kb + 16 * j < k_end ? bm.row(g, k0 + kb + 16 * j, &scale) : nullptr;
      rb[j] = load8(pb, scale, n0 + cb, N, vec_b);
    }
  };
  auto stash = [&](int buf) {
    *reinterpret_cast<uint4*>(&as[buf][ka][ca]) = ra;
#pragma unroll
    for (int j = 0; j < 2; ++j) *reinterpret_cast<uint4*>(&bs[buf][kb + 16 * j][cb]) = rb[j];
  };
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;
  if (k_begin < k_end) {
    fetch(k_begin);
    stash(0);
  }
  __syncthreads();
  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kTK) {
    const bool more = k0 + kTK < k_end;
    if (more) fetch(k0 + kTK);
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      // A is [k][m]: the four matrices (k 0-7 | 8-15) x (m 0-7 | 8-15) in
      // the order a0..a3 wants them; B is [k][n], as mma_product reads it
      uint32_t fa[2][4], fb[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4_trans(fa[i], &as[buf][kk + (lane >> 4) * 8 + (lane & 7)]
                                 [wm + i * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4_trans(fb[j], &bs[buf][kk + (lane & 15)][wn + j * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_16816(acc[i][2 * j], fa[i], fb[j][0], fb[j][1]);
          mma_16816(acc[i][2 * j + 1], fa[i], fb[j][2], fb[j][3]);
        }
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  // lane holds rows lane / 4 and + 8, columns 2·(lane % 4) and + 1 of each
  // 8-column tile
  float* out = partial + ((size_t)split * 2 + g) * M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + (lane >> 2) + 8 * h;
        const int n = n0 + wn + j * 8 + 2 * (lane & 3);
        if (m >= M) continue;
        if (n < N) out[(size_t)m * N + n] = acc[i][j][2 * h];
        if (n + 1 < N) out[(size_t)m * N + n + 1] = acc[i][j][2 * h + 1];
      }
}

// Row splits of a tensor-core product: enough that its tiles fill the card
// about twice over, none shorter than 256 rows.
__host__ int tc_splits(int rows, int groups, int M, int N) {
  const int tiles = groups * cdiv(M, kTM) * cdiv(N, kTN);
  const int want = cdiv(264, tiles), most = cdiv(rows, 256);
  const int s = want < most ? want : most;
  return s < 1 ? 1 : s;
}

__host__ int splits_of(bool bf16, int rows, int M, int N) {
  return bf16 ? tc_splits(rows, 2, M, N) : wgrad_splits(rows, 2, M, N);
}

// scratch floats of one product's partial sums (the larger of the two
// dtypes' splits)
__host__ size_t product_floats(int rows, int M, int N) {
  const int a = splits_of(true, rows, M, N), b = splits_of(false, rows, M, N);
  return (size_t)(a > b ? a : b) * 2 * M * N;
}

// One product's partial sums into `partial`; *splits is how many.
template <bool kBf16, typename XA, typename XB>
cudaError_t product(Stream<XA> a, Stream<XB> b, int steps, int batch, int M, int N,
                    float* partial, int* splits, cudaStream_t stream) {
  const int rows = steps * batch;
  *splits = splits_of(kBf16, rows, M, N);
  if constexpr (kBf16) {
    const int split_rows = cdiv(cdiv(rows, *splits), kTK) * kTK;
    dim3 grid(cdiv(N, kTN), cdiv(M, kTM), 2 * *splits);
    tc_wgrad_kernel<XA, XB><<<grid, kTThreads, 0, stream>>>(a, b, rows, M, N, split_rows,
                                                            partial);
  } else {
    const int split_rows = cdiv(cdiv(rows, *splits), kDepth) * kDepth;
    dim3 grid(cdiv(N, kTile), cdiv(M, kTile), 2 * *splits);
    wgrad_kernel<Stream<XA>, Stream<XB>><<<grid, 256, 0, stream>>>(
        a, b, false, steps, 2, batch, M, N, split_rows, partial);
  }
  return cudaGetLastError();
}

template <typename T, typename S>
int run(const void* h_all, const void* keep, const void* dgates,
        const void* outb, const void* doutp, const float* peep_part,
        int peep_tiles, int steps, int batch, int H, int P, void* dwh,
        void* dproj, void* dpeep, float* scratch, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int rows = steps * batch;
  float* wh_part = scratch;
  float* pj_part = wh_part + product_floats(rows, P, 4 * H);
  int splits = 0;
  const S *h = (const S*)h_all, *dg = (const S*)dgates;
  const float* kp = (const float*)keep;
  cudaError_t err = product<kBf16>(Stream<S>{h, kp, batch, P, true},
                                   Stream<S>{dg, nullptr, batch, 4 * H, false}, steps,
                                   batch, P, 4 * H, wh_part, &splits, stream);
  if (err != cudaSuccess) return err;
  split_sum_kernel<<<264, 256, 0, stream>>>(wh_part, splits, (size_t)2 * P * 4 * H,
                                            (float*)dwh);
  if (outb) {
    const T *ob = (const T*)outb, *dp = (const T*)doutp;
    err = product<kBf16>(Stream<T>{ob, nullptr, batch, H, false},
                         Stream<T>{dp, nullptr, batch, P, false}, steps, batch, H, P,
                         pj_part, &splits, stream);
    if (err != cudaSuccess) return err;
    split_sum_kernel<<<264, 256, 0, stream>>>(pj_part, splits, (size_t)2 * H * P,
                                              (float*)dproj);
  }
  if (peep_part)
    split_sum_kernel<<<cdiv(2 * 3 * H, 256), 256, 0, stream>>>(
        peep_part, peep_tiles, (size_t)2 * 3 * H, (float*)dpeep);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lstm_bwd_wgrad(int bf16, int store_bf16, const void* h_all,
                              const void* keep, const void* dgates,
                              const void* outb, const void* doutp,
                              const float* peep_part, int peep_tiles, int steps,
                              int batch, int units, int out_dim, void* dwh,
                              void* dproj, void* dpeep, float* scratch,
                              void* stream) {
  using bf = __nv_bfloat16;
  auto go = [&](auto compute, auto store) {
    using T = decltype(compute);
    using S = decltype(store);
    return run<T, S>(h_all, keep, dgates, outb, doutp, peep_part, peep_tiles, steps,
                     batch, units, out_dim, dwh, dproj, dpeep, scratch,
                     (cudaStream_t)stream);
  };
  if (bf16) return store_bf16 ? go(bf(), bf()) : go(bf(), 0.0f);
  return store_bf16 ? go(0.0f, bf()) : go(0.0f, 0.0f);
}

extern "C" long long lstm_bwd_wgrad_scratch_floats(int steps, int batch, int units,
                                                   int out_dim) {
  const int rows = steps * batch;
  return (long long)(product_floats(rows, out_dim, 4 * units) +
                     product_floats(rows, units, out_dim));
}
