// The weight-gradient passes of K2 (lstm_bwd.cu) and K13 (lstm_stack_bwd.cu),
// which they run after their recurrences: the products the TPU kernels
// accumulate in VMEM step by step (lstm_ctc_tpu/ops/lstm_pallas.py
// :331-371, lstm_stack_pallas.py :328-371), over the streams the
// recurrences wrote, for each group g (a direction of K2, a layer of K13):
//
//   K2:  dwh[g]   = Σ_(t,b) h_prev_kept[g]ᵀ · dgates[g]   M = P, N = 4H
//   K13: dwz[g]   = Σ_(s,b) [in_prev, h_prev][g]ᵀ · dgates[g]   M = 2P, N = 4H
//   both: dproj[g] = Σ out_blk[g]ᵀ · dout_p[g]             M = H, N = P
//
// with K = steps·B rows each, operands rounded to the compute dtype,
// float32 sums; then common.cuh's fixed-order split_sum_kernel adds the row
// splits' partial sums of each product, and the recurrences' per-row-tile
// peephole (and K13's bias) partials.
//
// In bf16 the products run on the tensor cores: a block owns a 64x128
// output tile of one group and one split of the rows, and stages both
// operands (which arrive with the rows as their leading index) chunk by
// chunk of 32 rows into shared memory as [k][m] and [k][n], 16 bytes a
// thread, double-buffered, loading the next chunk into registers while the
// tensor cores work on the current one; ldmatrix.trans gives the
// fragments of both, and mma.sync m16n8k16 accumulates in float32.  Eight
// warps of 32x32 each.  In float32 (never TF32) the products are an FMA
// tile GEMM (wgrad_kernel).  K13's gate inputs before its recurrence
// (lstm_stack_gate_inputs) are the same two products with the depth as the
// rows.

#include <type_traits>

#include "common.cuh"
#include "lstm_bwd_entry.cuh"

namespace {

constexpr int kTile = 128;  // FMA wgrad output tile
constexpr int kDepth = 16;  // FMA wgrad k-chunk

template <typename X>
__device__ __forceinline__ float ld(const X* p, size_t i) {
  return Dtype<X>::to_float(p[i]);
}

// partial[split][g][m][n] = Σ over the split's rows (s, b) of
// a(g, s, b)[m] · bm(g, s, b)[n] in float32 FMA (never TF32), the rows
// k = s·B + b.  A block owns a 128x128 tile, a thread 8x8 of it.
template <typename A, typename Bm>
__global__ void __launch_bounds__(256) wgrad_kernel(
    A a, Bm bm, int steps, int groups, int batch, int M,
    int N, int split_rows, float* __restrict__ partial) {
  __shared__ __align__(16) float as[kDepth][kTile];
  __shared__ __align__(16) float bs[kDepth][kTile];
  const int g = blockIdx.z % groups, split = blockIdx.z / groups;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k_begin = split * split_rows;
  const int k_end = min(steps * batch, k_begin + split_rows);
  float acc[8][8] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += kDepth) {
    for (int i = tid; i < kDepth * kTile; i += 256) {
      const int kk = i / kTile, j = i - kk * kTile;
      const int k = k0 + kk;
      float av = 0.0f, bv = 0.0f;
      if (k < k_end) {
        const int s = k / batch, b = k - s * batch;
        if (m0 + j < M) av = a(g, s, b, m0 + j);
        if (n0 + j < N) bv = bm(g, s, b, n0 + j);
      }
      as[kk][j] = av;
      bs[kk][j] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][tx * 8 + 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = partial + ((size_t)split * groups + g) * M * N;
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= M) continue;
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 8 + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// Rows per split of a weight-gradient product: enough splits that the
// tiles of every group fill the card about twice over, and no split
// shorter than 512 rows.
__host__ int wgrad_splits(int rows, int groups, int M, int N) {
  const int tiles = groups * cdiv(M, kTile) * cdiv(N, kTile);
  int splits = cdiv(264, tiles);
  splits = splits < 1 ? 1 : splits;
  const int most = cdiv(rows, 512);
  return splits < most ? splits : (most < 1 ? 1 : most);
}


constexpr int kTM = 64, kTN = 128, kTK = 32;  // tensor-core tile and row chunk
constexpr int kTThreads = 256;
constexpr int kLdA = kTM + 8, kLdB = kTN + 8;  // 16 bytes of padding a row

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

// eight float32 values as four bf16 pairs
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

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
  // one value, as wgrad_kernel reads its operands
  __device__ float operator()(int g, int s, int b, int m) const {
    float scale;
    const X* r = row(g, s * batch + b, &scale);
    return r ? scale * ld(r, m) : 0.0f;
  }
  // columns c .. c+7 of row k, as bf16 pairs (tc_wgrad_kernel's loads)
  __device__ uint4 load8(int g, int k, int c, int cols) const {
    float scale = 0.0f;
    const X* r = row(g, k, &scale);
    return ::load8(r, scale, c, cols, width * sizeof(X) % 16 == 0);
  }
};

// K13's operands, over the stack's [S, L·B, width] streams (group g a
// layer).  Rows: row k = s·B + b of layer g, at step s.
template <typename X>
struct StackRows {
  const X* x;
  int layers, batch, width;
  __device__ const X* row(int g, int k) const {
    const int s = k / batch, b = k - s * batch;
    return x + (((size_t)s * layers + g) * batch + b) * width;
  }
  __device__ float operator()(int g, int s, int b, int m) const {
    return ld(row(g, s * batch + b), m);
  }
  __device__ uint4 load8(int g, int k, int c, int cols) const {
    return ::load8(row(g, k), 1.0f, c, cols, width * sizeof(X) % 16 == 0);
  }
};

// z = [in_prev, h_prev] of row k = s·B + b of layer g, the operand the
// gates were made from: in_prev is layer g-1's chain at s-1 (zero for
// layer 0 and at s = 0), h_prev the layer's h at s-1 (hinit rounded to the
// store dtype at s = 0); 2P columns.
template <typename X>
struct StackZ {
  const X* chain;
  const X* h_all;
  const float* hinit;
  int layers, batch, P;
  __device__ float operator()(int g, int s, int b, int m) const {
    const size_t lb = (size_t)layers * batch;
    if (m < P)
      return g > 0 && s > 0 ? ld(chain, ((size_t)(s - 1) * lb + (size_t)(g - 1) * batch + b) * P + m)
                            : 0.0f;
    m -= P;
    return s > 0 ? ld(h_all, ((size_t)(s - 1) * lb + (size_t)g * batch + b) * P + m)
                 : Dtype<X>::to_float(Dtype<X>::from_float(hinit[((size_t)g * batch + b) * P + m]));
  }
  __device__ uint4 load8(int g, int k, int c, int cols) const {
    const int s = k / batch, b = k - s * batch;
    const size_t lb = (size_t)layers * batch;
    // eight columns inside one half, from a stored row: one vector load
    if (s > 0 && P * sizeof(X) % 16 == 0 && c + 8 <= cols && (c + 8 <= P || c >= P)) {
      if (c < P)
        return ::load8(g > 0 ? chain + ((size_t)(s - 1) * lb + (size_t)(g - 1) * batch + b) * P
                             : nullptr, 1.0f, c, P, true);
      return ::load8(h_all + ((size_t)(s - 1) * lb + (size_t)g * batch + b) * P, 1.0f, c - P,
                     P, true);
    }
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = c + i < cols ? (*this)(g, s, b, c + i) : 0.0f;
    return pack8(v);
  }
};

// K13's gate inputs gxl[g] = in_prev·wx_(g+1) for the layers above 0: a
// product over the depth P, its "rows" k the input index p.  A(g, p)[m],
// m = s·B + b, is layer g's chain at s-1 (zero at s = 0), gathered down a
// column; B(g, p)[n] is row p of wx_(g+1), the first P rows of wz[g+1].
template <typename X>
struct ChainCols {
  const X* chain;
  int layers, batch, P;
  __device__ float operator()(int g, int p, int, int m) const {
    const int s = m / batch, b = m - s * batch;
    return s > 0 ? ld(chain, (((size_t)(s - 1) * layers + g) * batch + b) * P + p) : 0.0f;
  }
  __device__ uint4 load8(int g, int p, int c, int cols) const {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = c + i < cols ? (*this)(g, p, 0, c + i) : 0.0f;
    return pack8(v);
  }
};

template <typename X>
struct WxRows {
  const X* wz;
  int P, N;
  __device__ const X* row(int g, int p) const {
    return wz + ((size_t)(g + 1) * 2 * P + p) * N;
  }
  __device__ float operator()(int g, int p, int, int n) const { return ld(row(g, p), n); }
  __device__ uint4 load8(int g, int p, int c, int cols) const {
    return ::load8(row(g, p), 1.0f, c, cols, N * sizeof(X) % 16 == 0);
  }
};

// partial[split][g][m][n] = Σ over the split's rows k of a(g, k)[m] ·
// bm(g, k)[n], operands rounded to bf16.  Each thread stages 8 columns of
// one row of A and of two rows of B a chunk.
template <typename OA, typename OB>
__global__ void __launch_bounds__(kTThreads) tc_wgrad_kernel(
    OA a, OB bm, int groups, int rows, int M, int N, int split_rows,
    float* __restrict__ partial) {
  __shared__ __align__(16) __nv_bfloat16 as[2][kTK][kLdA];
  __shared__ __align__(16) __nv_bfloat16 bs[2][kTK][kLdB];
  const int g = blockIdx.z % groups, split = blockIdx.z / groups;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  const int k_begin = split * split_rows;
  const int k_end = min(rows, k_begin + split_rows);
  // A: row tid / 8, columns 8·(tid % 8); B: rows tid / 16 and + 16,
  // columns 8·(tid % 16)
  const int ka = tid >> 3, ca = 8 * (tid & 7), kb = tid >> 4, cb = 8 * (tid & 15);
  uint4 ra, rb[2];
  auto fetch = [&](int k0) {
    ra = k0 + ka < k_end ? a.load8(g, k0 + ka, m0 + ca, M) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      rb[j] = k0 + kb + 16 * j < k_end ? bm.load8(g, k0 + kb + 16 * j, n0 + cb, N)
                                       : make_uint4(0, 0, 0, 0);
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
  float* out = partial + ((size_t)split * groups + g) * M * N;
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

__host__ int splits_of(bool bf16, int rows, int groups, int M, int N) {
  return bf16 ? tc_splits(rows, groups, M, N) : wgrad_splits(rows, groups, M, N);
}

// scratch floats of one product's partial sums (the larger of the two
// dtypes' splits)
__host__ size_t product_floats(int rows, int groups, int M, int N) {
  const int a = splits_of(true, rows, groups, M, N), b = splits_of(false, rows, groups, M, N);
  return (size_t)(a > b ? a : b) * groups * M * N;
}

// One product's partial sums into `partial`, then their fixed-order sum
// into `out` [groups, M, N].
template <bool kBf16, typename OA, typename OB>
cudaError_t product(OA a, OB b, int steps, int groups, int batch, int M, int N,
                    float* partial, void* out, cudaStream_t stream) {
  const int rows = steps * batch;
  const int splits = splits_of(kBf16, rows, groups, M, N);
  if constexpr (kBf16) {
    const int split_rows = cdiv(cdiv(rows, splits), kTK) * kTK;
    dim3 grid(cdiv(N, kTN), cdiv(M, kTM), groups * splits);
    tc_wgrad_kernel<OA, OB><<<grid, kTThreads, 0, stream>>>(a, b, groups, rows, M, N,
                                                            split_rows, partial);
  } else {
    const int split_rows = cdiv(cdiv(rows, splits), kDepth) * kDepth;
    dim3 grid(cdiv(N, kTile), cdiv(M, kTile), groups * splits);
    wgrad_kernel<OA, OB><<<grid, 256, 0, stream>>>(a, b, steps, groups, batch, M, N,
                                                   split_rows, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_sum_kernel<<<264, 256, 0, stream>>>(partial, splits, (size_t)groups * M * N,
                                            (float*)out);
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
  float* pj_part = wh_part + product_floats(rows, 2, P, 4 * H);
  const S *h = (const S*)h_all, *dg = (const S*)dgates;
  const float* kp = (const float*)keep;
  cudaError_t err = product<kBf16>(Stream<S>{h, kp, batch, P, true},
                                   Stream<S>{dg, nullptr, batch, 4 * H, false}, steps, 2,
                                   batch, P, 4 * H, wh_part, dwh, stream);
  if (err != cudaSuccess) return err;
  if (outb) {
    const T *ob = (const T*)outb, *dp = (const T*)doutp;
    err = product<kBf16>(Stream<T>{ob, nullptr, batch, H, false},
                         Stream<T>{dp, nullptr, batch, P, false}, steps, 2, batch, H, P,
                         pj_part, dproj, stream);
    if (err != cudaSuccess) return err;
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
  return (long long)(product_floats(rows, 2, out_dim, 4 * units) +
                     product_floats(rows, 2, units, out_dim));
}

namespace {

template <typename T, typename S>
int stack_run(const void* chain, const void* h_all, const float* hinit, const void* dgates,
              const void* outb, const void* doutp, int steps, int layers, int batch,
              int H, int P, void* dwz, void* dproj, float* scratch, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int rows = steps * batch;
  float* z_part = scratch;
  float* pj_part = z_part + product_floats(rows, layers, 2 * P, 4 * H);
  cudaError_t err = product<kBf16>(
      StackZ<S>{(const S*)chain, (const S*)h_all, hinit, layers, batch, P},
      StackRows<S>{(const S*)dgates, layers, batch, 4 * H}, steps, layers, batch, 2 * P,
      4 * H, z_part, dwz, stream);
  if (err != cudaSuccess || !outb) return err;
  return product<kBf16>(StackRows<T>{(const T*)outb, layers, batch, H},
                        StackRows<T>{(const T*)doutp, layers, batch, P}, steps, layers,
                        batch, H, P, pj_part, dproj, stream);
}

}  // namespace

extern "C" int lstm_stack_wgrad(int bf16, int store_bf16, const void* chain,
                                const void* h_all, const float* hinit,
                                const void* dgates, const void* outb, const void* doutp,
                                int steps, int layers, int batch, int units, int out_dim,
                                void* dwz, void* dproj, float* scratch, void* stream) {
  using bf = __nv_bfloat16;
  auto go = [&](auto compute, auto store) {
    using T = decltype(compute);
    using S = decltype(store);
    return stack_run<T, S>(chain, h_all, hinit, dgates, outb, doutp, steps, layers, batch,
                           units, out_dim, dwz, dproj, scratch, (cudaStream_t)stream);
  };
  if (bf16) return store_bf16 ? go(bf(), bf()) : go(bf(), 0.0f);
  return store_bf16 ? go(0.0f, bf()) : go(0.0f, 0.0f);
}

extern "C" int lstm_stack_gate_inputs(int bf16, int store_bf16, const void* chain,
                                      const void* wz, int steps, int layers, int batch,
                                      int units, int out_dim, float* gxl, void* stream) {
  if (layers < 2 || steps <= 0 || batch <= 0) return cudaSuccess;
  const int M = steps * batch, N = 4 * units, P = out_dim, groups = layers - 1;
  cudaStream_t st = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  auto go = [&](auto compute, auto store) {
    using T = decltype(compute);
    using S = decltype(store);
    const ChainCols<S> a{(const S*)chain, layers, batch, P};
    const WxRows<T> b{(const T*)wz, P, N};
    if constexpr (std::is_same<T, bf>::value) {
      dim3 grid(cdiv(N, kTN), cdiv(M, kTM), groups);
      tc_wgrad_kernel<ChainCols<S>, WxRows<T>><<<grid, kTThreads, 0, st>>>(
          a, b, groups, P, M, N, cdiv(P, kTK) * kTK, gxl);
    } else {
      dim3 grid(cdiv(N, kTile), cdiv(M, kTile), groups);
      wgrad_kernel<ChainCols<S>, WxRows<T>><<<grid, 256, 0, st>>>(
          a, b, P, groups, 1, M, N, cdiv(P, kDepth) * kDepth, gxl);
    }
    return (int)cudaGetLastError();
  };
  if (bf16) return store_bf16 ? go(bf(), bf()) : go(bf(), 0.0f);
  return store_bf16 ? go(0.0f, bf()) : go(0.0f, 0.0f);
}

extern "C" long long lstm_stack_wgrad_scratch_floats(int steps, int layers, int batch,
                                                     int units, int out_dim) {
  const int rows = steps * batch;
  return (long long)(product_floats(rows, layers, 2 * out_dim, 4 * units) +
                     product_floats(rows, layers, units, out_dim));
}
