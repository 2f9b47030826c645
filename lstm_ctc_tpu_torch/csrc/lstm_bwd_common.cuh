// Shared pieces of the unidirectional stack's backward (lstm_stack_bwd.cu,
// K13): one block of kThreads threads owns kRows batch rows and walks the
// steps in reverse, its products split over all threads (4 columns and a
// slice of k each) with the weights read from L2; the partial sums of a
// split product are added in a fixed order.  Its weight gradients are one
// tiled FMA GEMM over the steps·batch rows of each group (layer), reading
// its operands through row accessors; K2's float32 weight gradients
// (lstm_bwd_wgrad.cu, a direction a group) are the same GEMM.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kRows = 2;        // batch rows per block
constexpr int kMaxSlices = 16;  // most k-slices one product is split into
constexpr int kTile = 128;      // wgrad output tile
constexpr int kDepth = 16;      // wgrad k-chunk
constexpr int kPeepRows = 256;  // rows of one peephole partial sum

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return Dtype<T>::to_float(Dtype<T>::from_float(v));
}

template <typename T>
__device__ __forceinline__ float ld(const T* p, size_t i) {
  return Dtype<T>::to_float(p[i]);
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

struct Split {
  int per, slices;
};

__host__ __device__ Split split_of(int cols, int depth) {
  int most = kThreads / (cols / 4);
  most = most < 1 ? 1 : (most > kMaxSlices ? kMaxSlices : most);
  Split sp;
  sp.per = cdiv(depth, most);
  sp.slices = cdiv(depth, sp.per);
  return sp;
}

// part[s][r][cols] = Σ over the s-th slice of k of a[r][k]·w[k][cols]:
// a is [kRows][lda] float in shared memory (already rounded), w is
// [depth][cols] with row stride ldw in global memory.
template <typename W>
__device__ void block_product(const float* a, int lda, int depth,
                              const W* __restrict__ w, int ldw, int cols,
                              float* part) {
  const Split sp = split_of(cols, depth);
  const int quads = cols / 4;
  for (int task = threadIdx.x; task < quads * sp.slices; task += kThreads) {
    const int g = task % quads, s = task / quads;
    const int k0 = s * sp.per, k1 = min(depth, k0 + sp.per);
    float acc[kRows][4] = {};
    // unrolled so that several loads of w are in flight at once: each
    // load is an L2 round trip, and the loop is bound by their latency
#pragma unroll 8
    for (int k = k0; k < k1; ++k) {
      float wv[4];
      load4(w + (size_t)k * ldw + 4 * g, wv);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float av = a[r * lda + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av, wv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      *reinterpret_cast<float4*>(part + ((size_t)s * kRows + r) * cols + 4 * g) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

__device__ __forceinline__ float part_sum(const float* part, int slices,
                                          int cols, int r, int c) {
  float v = 0.0f;
  for (int s = 0; s < slices; ++s) v += part[((size_t)s * kRows + r) * cols + c];
  return v;
}

// What a weight-gradient product reads at row (s, b) of group g (a
// direction of K2, a layer of K13), column m: a [S, G·B, width] stream.
template <typename X>
struct Rows {
  const X* x;
  int step_rows, batch, width;  // step_rows = G·B
  __device__ float operator()(int g, int s, int b, int m) const {
    return ld(x, ((size_t)s * step_rows + (size_t)g * batch + b) * width + m);
  }
};

// partial[split][g][m][n] = Σ over the split's rows (s, b) of
// a(g, s, b)[m] · bm(g, s, b)[n]; operands rounded to bf16 when round_bf16.
// A block owns a 128x128 tile, a thread 8x8 of it.
template <typename A, typename Bm>
__global__ void __launch_bounds__(256) wgrad_kernel(
    A a, Bm bm, bool round_bf16, int steps, int groups, int batch, int M,
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
      if (round_bf16) {
        av = rnd<__nv_bfloat16>(av);
        bv = rnd<__nv_bfloat16>(bv);
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

// out [G, M, N] = one weight-gradient product over the steps·batch rows of
// each group, split over the rows, the partials in `partial`, summed in a
// fixed order
template <typename A, typename Bm>
cudaError_t wgrad(A x, Bm y, bool round_bf16, int steps, int groups,
                  int batch, int M, int N, float* partial, void* out,
                  cudaStream_t stream) {
  const int rows = steps * batch;
  const int splits = wgrad_splits(rows, groups, M, N);
  const int split_rows = cdiv(cdiv(rows, splits), kDepth) * kDepth;
  dim3 grid(cdiv(N, kTile), cdiv(M, kTile), groups * splits);
  wgrad_kernel<A, Bm><<<grid, 256, 0, stream>>>(
      x, y, round_bf16, steps, groups, batch, M, N, split_rows, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_sum_kernel<<<264, 256, 0, stream>>>(partial, splits,
                                            (size_t)groups * M * N, (float*)out);
  return cudaGetLastError();
}

}  // namespace
