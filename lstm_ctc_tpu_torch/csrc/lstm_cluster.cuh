// The cluster machinery of the LSTM kernels (lstm_fwd.cu, K1;
// lstm_stack_fwd.cu, K12; lstm_bwd.cu, K2, which keeps its own products and
// adds the split cluster barrier): an 8-block cluster per tile of R batch
// rows, each block owning 1/8 of the hidden units (all four gates of them) and of the
// projection columns; its slices of the recurrent and projection weights
// stay in its shared memory (bf16) or are read from L2 (float32).  Per step:
// the gate sums of the owned units from the full rounded h (mma_product or
// fma_product), the cell update, the rounded cell output written into every
// block of the cluster (share_slice), the owned projection columns, and the
// new rounded h written into every block.  See lstm_fwd.cu for the design.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;    // blocks per cluster
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlices = 16; // most k-slices one FMA product is split into

__host__ __device__ constexpr int round_up(int v, int m) { return cdiv(v, m) * m; }
__host__ __device__ constexpr size_t align128(size_t v) { return (v + 127) / 128 * 128; }

template <typename T>
constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// one per-step state, in float32 or bfloat16
__device__ __forceinline__ void put_state(void* p, size_t i, float v, bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// How an FMA product is split over the threads: each task owns 4 columns
// and `per` rows of k (a multiple of 4).  With the tensor cores each warp
// owns one 16-column tile and `per` 16-deep steps of k.
struct Split {
  int per, slices;
};

__host__ __device__ Split fma_split(int cols, int depth) {
  int most = kThreads / (cols / 4);
  most = most < 1 ? 1 : (most > kMaxSlices ? kMaxSlices : most);
  Split sp;
  sp.per = round_up(cdiv(depth, most), 4);
  sp.slices = cdiv(depth, sp.per);
  return sp;
}

// the k-split, into at most `most` slices, that gives the busiest warp the
// fewest 16-deep steps
__host__ __device__ Split mma_split(int cols, int depth, int most = kMaxSlices) {
  const int steps = cdiv(depth, 16), tiles = cols / 16;
  Split best = {steps, 1};
  int best_cost = cdiv(tiles, kWarps) * steps;
  for (int ks = 2; ks <= most && ks <= steps; ++ks) {
    const int per = cdiv(steps, ks);
    const int cost = cdiv(tiles * cdiv(steps, per), kWarps) * per;
    if (cost < best_cost) {
      best_cost = cost;
      best.per = per;
      best.slices = cdiv(steps, per);
    }
  }
  return best;
}

// Shared-memory plan, common to host and device.  US, PS: units and
// projection columns per block; HS, QS: row strides of the full cell
// output and of the full h (8·US, 8·PS, plus 16 bytes so that rows fall on
// other banks); arow: rows of those buffers (16 for the tensor cores, else
// R); prow: rows of each partial-sum block (8 for the tensor cores, else
// R); LWA, LWD: row strides of the bf16 weight slices in shared memory
// (also padded by 16 bytes); weight_bytes: their size (0 in f32, whose
// slices stay in global memory).
struct Plan {
  int us, ps, hs, qs, own, arow, prow, part, lwa, lwd;
  Split gates, proj;
  size_t off_cell, off_c, off_h, off_stage, off_part, base_bytes,
      weight_bytes;
};

template <typename T>
__host__ __device__ Plan plan(int units, int out_dim, bool has_proj, int rows) {
  Plan p;
  p.us = round_up(cdiv(units, kCluster), 8);
  p.ps = has_proj ? round_up(cdiv(out_dim, kCluster), 16) : p.us;
  const int pad = 16 / (int)sizeof(T);
  p.hs = kCluster * p.us + pad;
  p.qs = kCluster * p.ps + pad;
  p.own = has_proj ? p.ps : p.us;
  p.arow = kMma<T> ? 16 : rows;
  p.prow = kMma<T> ? 8 : rows;
  const int g = 4 * p.us;
  p.gates = kMma<T> ? mma_split(g, out_dim) : fma_split(g, out_dim);
  p.proj = kMma<T> ? mma_split(p.ps, units) : fma_split(p.ps, units);
  const int part_gates = p.gates.slices * p.prow * g;
  const int part_proj = has_proj ? p.proj.slices * p.prow * p.ps : 0;
  p.part = part_gates > part_proj ? part_gates : part_proj;
  const int stage = p.us > p.ps ? p.us : p.ps;
  p.off_cell = align128(sizeof(T) * (size_t)p.arow * p.qs);
  p.off_c = p.off_cell + align128(sizeof(T) * (size_t)p.arow * p.hs);
  p.off_h = p.off_c + align128(sizeof(float) * (size_t)rows * p.us);
  p.off_stage = p.off_h + align128(sizeof(float) * (size_t)rows * p.own);
  p.off_part = p.off_stage + align128(sizeof(T) * (size_t)rows * stage);
  p.base_bytes = p.off_part + align128(sizeof(float) * (size_t)p.part);
  p.lwa = g + pad;
  p.lwd = p.ps + pad;
  p.weight_bytes = !kMma<T> ? 0 : sizeof(T) *
      ((size_t)round_up(out_dim, 16) * p.lwa
       + (has_proj ? (size_t)round_up(units, 16) * p.lwd : 0));
  return p;
}

// part[s][r][cols] = sum over the s-th slice of k of a[r][k] · w[k][cols],
// in float32 FMA; a is [R][lda] float in shared memory, w is [depth][cols]
// with row stride ldw (shared or global memory).
template <int R>
__device__ __forceinline__ void fma_product(const float* a, int lda,
                                            int depth, const float* w,
                                            int ldw, int cols, Split sp,
                                            float* part) {
  const int quads = cols / 4;
  for (int task = threadIdx.x; task < quads * sp.slices; task += kThreads) {
    const int g = task % quads, s = task / quads;
    const int k0 = s * sp.per, k1 = min(depth, k0 + sp.per);
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    int k = k0;
    for (; k + 4 <= k1; k += 4) {
      float av[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(a + r * lda + k);
        av[r][0] = v.x;
        av[r][1] = v.y;
        av[r][2] = v.z;
        av[r][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float wv[4];
        load4(w + (size_t)(k + kk) * ldw + 4 * g, wv);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r][kk], wv[c], acc[r][c]);
      }
    }
    for (; k < k1; ++k) {
      float wv[4];
      load4(w + (size_t)k * ldw + 4 * g, wv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float av = a[r * lda + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av, wv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      *reinterpret_cast<float4*>(part + ((size_t)s * R + r) * cols + 4 * g) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// The same product on the tensor cores, both operands in shared memory: a
// is [16][lda] bf16 (rows past R are zero), w is [depth rounded to 16]
// [cols] bf16 with row stride ldw; part[s] is [8][cols] (rows < R <= 8).
// A warp owns one 16-column tile and `per` 16-deep steps of k.
__device__ __forceinline__ void mma_product(const __nv_bfloat16* a, int lda,
                                            int depth, const __nv_bfloat16* w,
                                            int ldw, int cols, Split sp,
                                            float* part) {
  const int lane = threadIdx.x & 31;
  const int tiles = cols / 16, steps = cdiv(depth, 16);
  // ldmatrix row addresses: a rows m = lane % 16 at k + 8·(lane / 16);
  // w rows k = lane % 16 at column n + 8·(lane / 16)
  const __nv_bfloat16* a_lane = a + (lane & 15) * lda + (lane >> 4) * 8;
  const __nv_bfloat16* w_lane = w + (size_t)(lane & 15) * ldw + (lane >> 4) * 8;
  for (int task = threadIdx.x / 32; task < tiles * sp.slices; task += kWarps) {
    const int n = task % tiles, s = task / tiles;
    const int k0 = s * sp.per, k1 = min(steps, k0 + sp.per);
    float d[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int k = k0; k < k1; ++k) {
      uint32_t fa[4], fb[4];
      ldsm_x4(fa, a_lane + k * 16);
      ldsm_x4_trans(fb, w_lane + (size_t)k * 16 * ldw + n * 16);
      mma_16816(d[0], fa, fb[0], fb[1]);
      mma_16816(d[1], fa, fb[2], fb[3]);
    }
    // lane holds rows lane / 4 (and + 8: padding, dropped), columns
    // 2·(lane % 4) and + 1 of each 8-column half
    float* dst = part + ((size_t)s * 8 + (lane >> 2)) * cols + n * 16 + 2 * (lane & 3);
    *reinterpret_cast<float2*>(dst) = make_float2(d[0][0], d[0][1]);
    *reinterpret_cast<float2*>(dst + 8) = make_float2(d[1][0], d[1][1]);
  }
}

// The two halves of a cluster barrier (arrive releases this thread's writes,
// wait acquires the others'): work that neither reads what other blocks
// write before the barrier nor writes what they read after it can run
// between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Write stage [nr][width] (this block's slice) into rows of `target`
// (stride `stride`, columns col0 ..) in every block of the cluster, as
// 16-byte stores.
template <typename T>
__device__ __forceinline__ void share_slice(cg::cluster_group& cluster,
                                            const T* stage, int nr, int width,
                                            T* target, int stride, int col0) {
  const int n16 = width * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < kCluster * nr * n16; i += kThreads) {
    const int peer = i / (nr * n16), e = i - peer * nr * n16;
    const int r = e / n16, c = e - r * n16;
    T* dst = cluster.map_shared_rank(target, peer) + r * stride + col0;
    reinterpret_cast<uint4*>(dst)[c] =
        reinterpret_cast<const uint4*>(stage + r * width)[c];
  }
}

// rows x cols elements (cols · sizeof(T) a multiple of 16) from a dense
// global array into shared memory with row stride ld
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src,
                                          int cols, int rows) {
  const int n16 = cols * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < rows * n16; i += kThreads) {
    const int r = i / n16, c = i - r * n16;
    reinterpret_cast<uint4*>(dst + (size_t)r * ld)[c] =
        reinterpret_cast<const uint4*>(src + (size_t)r * cols)[c];
  }
}

}  // namespace
