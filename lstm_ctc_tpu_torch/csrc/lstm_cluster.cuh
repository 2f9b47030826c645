// The cluster machinery of the LSTM kernels (lstm_fwd.cu, K1;
// lstm_stack_fwd.cu, K12; lstm_bwd.cu, K2; lstm_stack_bwd.cu, K13): an
// 8-block cluster per tile of R batch rows (16 blocks where an 8-block plan
// does not fit, up to 2048 units), each block owning 1/8 (1/16) of
// the hidden units (all four gates of them) and of the projection columns; its
// slices of the recurrent and projection weights stay in its shared memory
// (bf16) or are read from L2 (float32).  Per step of a forward: the gate
// sums of the owned units from the full rounded h (mma_product or
// fma_product), the cell update, the rounded cell output written into every
// block of the cluster (share_slice), the owned projection columns, and the
// new rounded h written into every block.  The backwards add the products
// with float32 adds of each 16-deep step (mma_product_f32add) and the
// weights used transposed (fma_product_nk), the split cluster barrier; the
// stacks add the products of a layer's input side off its recurrence (K12's
// input_product, K13's din product, both from frag_step's 16-byte
// fragments) and the step counters through which a layer's clusters hand
// their results to the next layer's (wait_blocks, publish).  K1 has its
// own plan and products (mma_product_t: the weights as mma's A, the rows as
// its n) and hands its slices off point to point (send_slice, st.async on
// the receiver's mbarrier) instead of through cluster barriers.  See
// lstm_fwd.cu for the design.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;       // blocks per cluster where an 8-block plan fits
constexpr int kWideCluster = 16;  // past that: the H100's non-portable most
constexpr int kBlockUnits = 64;   // hidden units a block of an 8-block K12 or K13 owns, at most
constexpr int kLayerUnits = 128;  // the same of K1 and K2, and of 16 blocks (H <= 2048)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlices = 16; // most k-slices one FMA product is split into
// the streamed plans' ring (below): a chunk's bytes, about (at least 16
// rows), and the ring's slots, at most (2 at least)
constexpr int kChunkBytes = 24576;
constexpr int kMaxSlots = 4;
// a streamed plan's `cap` that holds every 16-deep step of wh resident, and
// refuses the shape where they do not all fit (the ring then streams only
// proj's rows): the plans' forced launches time it against the resident
// plan; -1 holds as many as fit
constexpr int kAllHeld = -2;
// the phases a streamed layer kernel's clock64 stamps sum (K1: lstm_fwd.cu,
// K2: lstm_bwd_streamed.cu)
constexpr int kStampPhases = 6;

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

// The cell phase of the 16-block plans of K12 and K13 (bf16, resident or
// streamed): thread tid owns unit tid % US of rows tid / US, + kThreads /
// US, .. below R, so a block takes more rows than it has threads for
// units; kThreadRows such rows at most
constexpr int kThreadRows = 8;

__host__ __device__ constexpr int thread_rows(int rows, int us) {
  return cdiv(rows, kThreads / us);
}

// a cell-phase thread's rows at most with R rows a cluster, at any US up to
// `units` (kLayerUnits, or kBlockUnits where a plan takes several rows a
// thread only up to 64 units a block): the bound of its unrolled loop
__host__ __device__ constexpr int cell_rows(int rows, int units = kLayerUnits) {
  return cdiv(rows, kThreads / units) < kThreadRows ? cdiv(rows, kThreads / units)
                                                    : kThreadRows;
}

// Whether a plan of C blocks takes several rows a cell-phase thread: the
// bf16 plans of 16 blocks (K12: R of {4, 8, 16, 32}; K13: the streamed
// plan's kernel, with every weight held on the resident plan); the 8-block
// and float32 plans take one
template <typename T>
__host__ __device__ constexpr bool multi_row(int C) {
  return kMma<T> && C == kWideCluster;
}

// Whether K12 carries c in the registers of its cell-phase threads (the
// resident plan of several rows a thread, at up to kBlockUnits units a
// block) or in shared memory [R][US]
template <typename T>
__host__ __device__ constexpr bool c_in_regs(int rows, int C, bool stream) {
  return multi_row<T>(C) && !stream && cell_rows(rows, kBlockUnits) > 1;
}

// K12's shared-memory plan with C blocks a cluster, common to host and
// device.  US, PS: units and projection columns per block; HS, QS: row
// strides of the full cell output and of the full h (C·US, C·PS, plus 16
// bytes so that rows fall on other banks); arow: rows of those buffers
// (the tensor cores' A operands: 8 up to 8 rows, loaded once for mma's 16,
// else R rounded up to 16-row tiles; R in float32); prow: rows of each
// partial-sum block (arow in bf16); c: the carried c [R][US], in shared
// memory unless the plan is the resident one of 16 blocks in bf16 with
// several rows a cell-phase thread (cell_rows(R, kBlockUnits) > 1), whose
// threads keep it in registers; LWA, LWD: row strides of the bf16
// weight slices in shared memory (padded by 16 bytes, LWD not with 16
// blocks, as K1's); off_w, bytes:
// where they start, and the block's shared memory in all (in f32, whose
// slices stay in global memory, off_w = bytes).  The cell output's buffer
// exists only with a projection.  The region of the partial sums also
// holds the input rows a layer stages for a chunk's product (srows rows
// of the padded input width: kStage, or half of it where a stage of kStage
// rows would not fit, in a resident plan, or would be past kStageBytes, in
// the streamed one): the stage is used before a chunk's steps, the partial
// sums within a step, and both only by the block's own threads.
//
// The streamed plan (bf16, `stream`): the partial sums are the complete
// sums [arow][4·US] and [arow][PS] (streamed_product adds the k-slices
// itself); after the stage, the ring's barriers and slots, then wh's
// first `res` 16-deep steps (at most `cap` where cap >= 0) at row stride
// LWA, as the wrapper lays every row out in global memory; wsteps,
// psteps: 16-deep steps of wh (P) and proj (H); cw, cp: steps a chunk of
// each; nw, np: chunks a step; res_bytes, stream_bytes: a block's weight
// bytes held, and streamed a step.
constexpr int kStage = 32;
constexpr size_t kStageBytes = 65536;

struct Plan {
  int us, ps, hs, qs, own, arow, prow, part, lwa, lwd, srows;
  Split gates, proj;
  size_t off_cell, off_c, off_h, off_stage, off_part, off_w, bytes;
  int wsteps, psteps, res, cw, cp, nw, np, slots;
  size_t slot, off_bar, off_ring;
  long long res_bytes, stream_bytes;
};

template <typename T>
__host__ __device__ Plan plan(int units, int out_dim, bool has_proj, int rows, int C,
                              bool stream = false, int cap = -1) {
  Plan p = {};
  p.us = round_up(cdiv(units, C), 8);
  p.ps = has_proj ? round_up(cdiv(out_dim, C), 16) : p.us;
  const int pad = 16 / (int)sizeof(T);
  p.hs = C * p.us + pad;
  p.qs = C * p.ps + pad;
  p.own = has_proj ? p.ps : p.us;
  p.arow = kMma<T> ? (rows > 8 ? round_up(rows, 16) : 8) : rows;
  p.prow = p.arow;
  const int g = 4 * p.us;
  p.gates = kMma<T> ? mma_split(g, out_dim) : fma_split(g, out_dim);
  p.proj = kMma<T> ? mma_split(p.ps, units) : fma_split(p.ps, units);
  const int part_gates = stream ? p.arow * g : p.gates.slices * p.prow * g;
  const int part_proj = !has_proj ? 0 : stream ? p.arow * p.ps : p.proj.slices * p.prow * p.ps;
  p.part = part_gates > part_proj ? part_gates : part_proj;
  p.lwa = g + pad;
  p.lwd = p.ps + (C == kCluster ? pad : 0);
  const size_t part_bytes = sizeof(float) * (size_t)p.part;
  const int stage = p.us > p.ps ? p.us : p.ps;
  p.off_cell = align128(sizeof(T) * (size_t)p.arow * p.qs);
  p.off_c = p.off_cell + (has_proj ? align128(sizeof(T) * (size_t)p.arow * p.hs) : 0);
  p.off_h = p.off_c + (c_in_regs<T>(rows, C, stream) ? 0
                                                     : align128(sizeof(float) * (size_t)rows * p.us));
  p.off_stage = p.off_h + align128(sizeof(float) * (size_t)rows * p.own);
  p.off_part = p.off_stage + align128(sizeof(T) * (size_t)rows * stage);
  const size_t weights = !kMma<T> ? 0 : sizeof(T) *
      ((size_t)round_up(out_dim, 16) * p.lwa
       + (has_proj ? (size_t)round_up(units, 16) * p.lwd : 0));
  const size_t row_in = sizeof(T) * (size_t)(round_up(out_dim, 16) + pad);
  p.srows = kStage;
  if (stream ? kStage * row_in > kStageBytes
             : p.off_part + align128(kStage * row_in > part_bytes ? kStage * row_in : part_bytes) +
                       weights > kMaxSmemPerBlock)
    p.srows = kStage / 2;
  const size_t in_stage = p.srows * row_in;
  p.off_w = p.off_part + align128(part_bytes > in_stage ? part_bytes : in_stage);
  p.bytes = p.off_w + weights;
  if (!stream) return p;
  p.wsteps = cdiv(out_dim, 16);
  p.psteps = has_proj ? cdiv(units, 16) : 0;
  const size_t wrow = sizeof(T) * 16 * (size_t)p.lwa, prow_b = sizeof(T) * 16 * (size_t)p.ps;
  p.cw = kChunkBytes / wrow > 1 ? (int)(kChunkBytes / wrow) : 1;
  p.cp = !has_proj ? 0 : kChunkBytes / prow_b > 1 ? (int)(kChunkBytes / prow_b) : 1;
  p.slot = align128(p.cw * wrow > p.cp * prow_b ? p.cw * wrow : p.cp * prow_b);
  p.off_bar = p.off_w;
  p.off_ring = p.off_bar + 128;
  const size_t left = kMaxSmemPerBlock > p.off_ring ? kMaxSmemPerBlock - p.off_ring : 0;
  p.slots = left / p.slot < (size_t)kMaxSlots ? (int)(left / p.slot) : kMaxSlots;
  p.off_w = p.off_ring + p.slots * p.slot;
  const int fit = (int)((left - p.slots * p.slot) / wrow);
  p.res = fit < p.wsteps ? fit : p.wsteps;
  if (cap >= 0 && cap < p.res) p.res = cap;
  p.nw = cdiv(p.wsteps - p.res, p.cw);
  p.np = has_proj ? cdiv(p.psteps, p.cp) : 0;
  p.bytes = p.off_w + p.res * wrow;
  p.res_bytes = (long long)p.res * 16 * g * sizeof(T);
  p.stream_bytes = (long long)(p.wsteps - p.res) * 16 * g * sizeof(T) +
                   (long long)p.psteps * 16 * p.ps * sizeof(T);
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

// ldmatrix of two 8x8 bf16 matrices, each lane giving one row
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

// The same product on the tensor cores, both operands in shared memory: a
// is [AROW][lda] bf16 (rows past R are zero), w is [depth rounded to
// 16][cols] bf16 with row stride ldw; part[s] is [AROW][cols].  At AROW 8
// the rows of a are loaded once by ldmatrix.x2 and are mma's rows 8-15
// again, whose sums are never stored; at 16 and 32 a is one or two whole
// 16-row tiles (ldmatrix.x4), which share each B fragment.  A row's sums
// do not depend on the rows beside it, so a row gives the same bits at any
// AROW.  A warp owns one 16-column tile and `per` 16-deep steps of k.
template <int AROW>
__device__ __forceinline__ void mma_product(const __nv_bfloat16* a, int lda,
                                            int depth, const __nv_bfloat16* w,
                                            int ldw, int cols, Split sp,
                                            float* part) {
  static_assert(AROW == 8 || AROW == 16 || AROW == 32, "8 rows, or one or two 16-row tiles");
  constexpr int MT = AROW == 8 ? 1 : AROW / 16;  // mma's 16-row tiles
  const int lane = threadIdx.x & 31;
  const int tiles = cols / 16, steps = cdiv(depth, 16);
  // ldmatrix row addresses: a rows m = lane % 16 at k + 8·(lane / 16)
  // (AROW 8: m = lane % 8 at k + 8·(lane / 8 % 2)); w rows k = lane % 16
  // at column n + 8·(lane / 16)
  const __nv_bfloat16* a_lane = AROW == 8 ? a + (lane & 7) * lda + ((lane >> 3) & 1) * 8
                                          : a + (lane & 15) * lda + (lane >> 4) * 8;
  const __nv_bfloat16* w_lane = w + (size_t)(lane & 15) * ldw + (lane >> 4) * 8;
  for (int task = threadIdx.x / 32; task < tiles * sp.slices; task += kWarps) {
    const int n = task % tiles, s = task / tiles;
    const int k0 = s * sp.per, k1 = min(steps, k0 + sp.per);
    float d[MT][2][4] = {};
    for (int k = k0; k < k1; ++k) {
      uint32_t fa[MT][4], fb[4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if constexpr (AROW == 8) {
          uint32_t fr[2];
          ldsm_x2(fr, a_lane + k * 16);
          fa[m][0] = fa[m][1] = fr[0];
          fa[m][2] = fa[m][3] = fr[1];
        } else {
          ldsm_x4(fa[m], a_lane + (size_t)m * 16 * lda + k * 16);
        }
      }
      ldsm_x4_trans(fb, w_lane + (size_t)k * 16 * ldw + n * 16);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_16816(d[m][0], fa[m], fb[0], fb[1]);
        mma_16816(d[m][1], fa[m], fb[2], fb[3]);
      }
    }
    // lane holds rows lane / 4 and + 8 of each tile (at AROW 8 the second
    // a copy, not stored), columns 2·(lane % 4) and + 1 of each 8-column
    // half
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float* dst = part + ((size_t)s * AROW + 16 * m + (lane >> 2)) * cols + n * 16 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(dst) = make_float2(d[m][0][0], d[m][0][1]);
      *reinterpret_cast<float2*>(dst + 8) = make_float2(d[m][1][0], d[m][1][1]);
      if constexpr (AROW > 8) {
        *reinterpret_cast<float2*>(dst + 8 * cols) = make_float2(d[m][0][2], d[m][0][3]);
        *reinterpret_cast<float2*>(dst + 8 * cols + 8) = make_float2(d[m][1][2], d[m][1][3]);
      }
    }
  }
}

// d += a·b as mma_16816, but not volatile: a product has no effect beyond
// its result, so the compiler may place it after later fragment loads, and
// a warp's chain of 16-deep steps runs its loads ahead of its products
// (volatile asm keeps program order: each step would wait out its loads)
__device__ __forceinline__ void mma_16816_free(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
// (stride `stride`, columns col0 ..) in every block of the C-block
// cluster, as 16-byte stores.
template <typename T, int C>
__device__ __forceinline__ void share_slice(cg::cluster_group& cluster,
                                            const T* stage, int nr, int width,
                                            T* target, int stride, int col0) {
  const int n16 = width * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < C * nr * n16; i += kThreads) {
    const int peer = i / (nr * n16), e = i - peer * nr * n16;
    const int r = e / n16, c = e - r * n16;
    T* dst = cluster.map_shared_rank(target, peer) + r * stride + col0;
    reinterpret_cast<uint4*>(dst)[c] =
        reinterpret_cast<const uint4*>(stage + r * width)[c];
  }
}

// K1's products on the tensor cores with the roles turned: part[s][n][c]
// (row stride ldp) = Σ over the s-th slice of k of a[n][k]·w[k][c], for
// the (at most 8) rows n of a, as wᵀ·aᵀ: a 16-column tile of w (read
// transposed) is mma's A, the 8 rows of a its B (n = 8), so no padding
// rows are multiplied (half the mma of mma_product), and each warp loads
// its B fragments once for all its tiles.  Warp (g, s) owns tiles [g·tiles, (g+1)·tiles) and
// the 16-deep steps [s·per, (s+1)·per); each tile's steps are summed in
// order into one accumulator, the slices in slice order by the reader.
// KMAX and TMAX bound per and tiles at compile time, so that the loads of
// a warp are issued ahead of its mma: steps past a slice's end multiply a
// zero B fragment and tiles past the group's end go to a discarded
// accumulator.  A lane stores rows 2·(lane % 4) and + 1 of columns lane / 4
// and + 8: with ldp ≡ 4 (mod 16) the four lanes of a column store to four
// banks (at ldp a multiple of 32 they would share one).
struct TSplit {
  int per, slices, groups, tiles;
};

// the split with the fewest slices whose per and tiles fit KMAX and TMAX
// and whose slices x groups fit the block's warps (per = 0: none fits)
__host__ __device__ inline TSplit tsplit(int cols, int depth, int kmax, int tmax) {
  const int tm = cols / 16, ks = cdiv(depth, 16);
  for (int per = kmax; per >= 1; --per) {
    const int slices = cdiv(ks, per), groups = cdiv(tm, tmax);
    if (slices * groups <= kWarps) {
      const int tiles = cdiv(tm, groups);
      return TSplit{per, slices, cdiv(tm, tiles), tiles};
    }
  }
  return TSplit{0, 0, 0, 0};
}

template <int KMAX, int TMAX>
__device__ __forceinline__ void mma_product_t(const __nv_bfloat16* a, int lda, int depth,
                                              const __nv_bfloat16* w, int ldw, int cols,
                                              TSplit sp, float* part, int ldp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  if (warp >= sp.slices * sp.groups) return;
  const int s = warp % sp.slices, g = warp / sp.slices;
  const int tm = cols / 16, steps = cdiv(depth, 16);
  const int k0 = s * sp.per, nk = min(steps, k0 + sp.per) - k0;
  const int t0 = g * sp.tiles, nt = min(tm, t0 + sp.tiles) - t0;
  // B, the rows of a: rows n = lane % 8 at k + 8·(lane / 8 % 2)
  const __nv_bfloat16* b_lane = a + (lane & 7) * lda + ((lane >> 3) & 1) * 8 + k0 * 16;
  // A, a tile of w read transposed: rows k = lane % 16 at column
  // 8·(lane / 16) of the tile, as mma_product reads its B
  const __nv_bfloat16* w_lane = w + (size_t)((lane & 15) + k0 * 16) * ldw + (lane >> 4) * 8 + t0 * 16;
  uint32_t fb[KMAX][2];
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) {
    ldsm_x2(fb[kk], b_lane + min(kk, nk - 1) * 16);
    if (kk >= nk) fb[kk][0] = fb[kk][1] = 0u;
  }
  float d[TMAX][4] = {};
#pragma unroll
  for (int i = 0; i < TMAX; ++i) {
    const __nv_bfloat16* wt = w_lane + min(i, nt - 1) * 16;
#pragma unroll
    for (int kk = 0; kk < KMAX; ++kk) {
      uint32_t fw[4];
      ldsm_x4_trans(fw, wt + (size_t)min(kk, nk - 1) * 16 * ldw);
      const uint32_t fa[4] = {fw[0], fw[2], fw[1], fw[3]};
      mma_16816(d[i], fa, fb[kk][0], fb[kk][1]);
    }
  }
  // lane holds columns 16·tile + lane / 4 (and + 8) of rows 2·(lane % 4)
  // and + 1
  float* dst = part + ((size_t)s * 8 + 2 * (lane & 3)) * ldp + t0 * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < TMAX; ++i) {
    if (i < nt) {
      dst[i * 16] = d[i][0];
      dst[i * 16 + ldp] = d[i][1];
      dst[i * 16 + 8] = d[i][2];
      dst[i * 16 + ldp + 8] = d[i][3];
    }
  }
}

// Point-to-point hand-offs inside a cluster (K1): a block writes its slice
// into every block's buffer with st.async, each 16-byte store completing its
// bytes on the receiving block's mbarrier; a receiver arms its own barrier
// for the bytes of a phase (arrive.expect_tx, count 1) and waits on that
// phase's parity.  Unlike a cluster barrier this orders nothing else: the
// sender's other loads and stores, global ones included, are not waited
// for, and a block waits for the slices it reads, not for every block.
// the address of `p` in the shared memory of the cluster's block `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_async16(uint32_t dst, const uint4& v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// One value a thread, the threads of a slice in element order, the lane's
// value going to element `at` of `target`: groups of E = 16 / sizeof(T)
// lanes (E-aligned, within a row of the slice) gather their values into
// 16 bytes by shuffles, and lane p of a group stores them into the blocks
// p, p + E, .. of the cluster at the group's first element, completing 16
// bytes on each one's `bar` (C blocks: 16-byte stores to C / E peers a
// lane).  Every lane of the warp calls it (the shuffles); only lanes with
// `send` store.
template <typename T, int C>
__device__ __forceinline__ void send_slice(float v, bool send, const T* target, int at,
                                           uint64_t* bar) {
  constexpr int E = 16 / (int)sizeof(T);
  const int lane = threadIdx.x & 31, g0 = lane & ~(E - 1), p = lane - g0;
  uint32_t word;
  if constexpr (sizeof(T) == 2) {
    const uint32_t bits = __bfloat16_as_ushort(__float2bfloat16(v));
    word = bits | (__shfl_down_sync(0xffffffffu, bits, 1) << 16);  // even lanes
  } else {
    word = __float_as_uint(v);
  }
  constexpr int step = 4 / (int)sizeof(T);  // lanes a 32-bit word
  uint4 q;
  q.x = __shfl_sync(0xffffffffu, word, g0);
  q.y = __shfl_sync(0xffffffffu, word, g0 + step);
  q.z = __shfl_sync(0xffffffffu, word, g0 + 2 * step);
  q.w = __shfl_sync(0xffffffffu, word, g0 + 3 * step);
  if (send) {
#pragma unroll
    for (int peer = p; peer < C; peer += E)
      st_async16(cluster_addr(target + at - p, peer), q, cluster_addr(bar, peer));
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

template <typename X>
__device__ __forceinline__ float ld(const X* p, size_t i) {
  return Dtype<X>::to_float(p[i]);
}

// part[s] = a · w over the s-th slice of k on the tensor cores, as
// mma_product (part [8][cols] a slice), but a is [8][lda] bf16 (rows past
// R zero; mma's rows 8-15 are rows 0-7 again, their sums never stored, so
// the rows of a are loaded once, by ldmatrix.x2), each 16-deep step is summed by the tensor cores
// into a zero accumulator and the steps are added in float32 rounded to
// nearest: a long sum keeps the accuracy of an FMA chain (near a
// cancellation in dc_new the tensor cores' own running sum, aligned and
// rounded their own way, moved dgates by more than a bf16 rounding step),
// and the steps' mma do not wait on one another.  w is [depth rounded to
// 16][cols] (kNK false: fragments by ldmatrix.trans) or [cols][ldw], one
// row per output column with k contiguous (kNK true: a weight used
// transposed, fragments by ldmatrix).
// mma_product_f32add over `tiles` 16-column tiles of w, its sums stored at
// columns col0 .. of part[s] ([AROW][ldp] a slice): K2's and K13's streamed
// plans run it on one chunk of rows at a time; mma_product_f32add is all of
// w at once.  AROW 16: a holds 16 rows, mma's whole A (ldmatrix.x4), and
// every row of its sums is stored.
template <bool kNK, int AROW = 8>
__device__ __forceinline__ void mma_f32add_tiles(const __nv_bfloat16* a, int lda, int depth,
                                                 const __nv_bfloat16* w, int ldw, int tiles,
                                                 Split sp, float* part, int ldp, int col0);

template <bool kNK>
__device__ __forceinline__ void mma_product_f32add(const __nv_bfloat16* a, int lda,
                                                   int depth, const __nv_bfloat16* w,
                                                   int ldw, int cols, Split sp,
                                                   float* part) {
  mma_f32add_tiles<kNK>(a, lda, depth, w, ldw, cols / 16, sp, part, cols, 0);
}

template <bool kNK, int AROW>
__device__ __forceinline__ void mma_f32add_tiles(const __nv_bfloat16* a, int lda, int depth,
                                                 const __nv_bfloat16* w, int ldw, int tiles,
                                                 Split sp, float* part, int ldp, int col0) {
  static_assert(AROW == 8 || AROW == 16, "8 rows, or mma's 16");
  const int lane = threadIdx.x & 31;
  const int steps = cdiv(depth, 16);
  // rows m = lane % 8 at k + 8·(lane / 8 % 2): A's fragments a0 = a1 and
  // a2 = a3 (AROW 16: rows lane % 16 at k + 8·(lane / 16))
  const __nv_bfloat16* a_lane = AROW == 8 ? a + (lane & 7) * lda + ((lane >> 3) & 1) * 8
                                          : a + (lane & 15) * lda + (lane >> 4) * 8;
  // kNK: w rows n = 8·(lane / 16) + lane % 8 at k + 8·((lane / 8) % 2), the
  // four matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15,
  // k 8-15), the b0 and b1 of each 8-column half; else w rows k = lane % 16
  // at column n + 8·(lane / 16)
  const __nv_bfloat16* w_lane =
      kNK ? w + (size_t)((lane >> 4) * 8 + (lane & 7)) * ldw + ((lane >> 3) & 1) * 8
          : w + (size_t)(lane & 15) * ldw + (lane >> 4) * 8;
  for (int task = threadIdx.x / 32; task < tiles * sp.slices; task += kWarps) {
    const int n = task % tiles, s = task / tiles;
    const int k0 = s * sp.per, k1 = min(steps, k0 + sp.per);
    float d[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    // the steps' products are independent: unrolled, their loads and mma
    // run ahead of the adds
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      uint32_t fa[4], fb[4];
      if constexpr (AROW == 8) {
        uint32_t fr[2];
        ldsm_x2(fr, a_lane + k * 16);
        fa[0] = fa[1] = fr[0];
        fa[2] = fa[3] = fr[1];
      } else {
        ldsm_x4(fa, a_lane + k * 16);
      }
      if constexpr (kNK)
        ldsm_x4(fb, w_lane + (size_t)n * 16 * ldw + k * 16);
      else
        ldsm_x4_trans(fb, w_lane + (size_t)k * 16 * ldw + n * 16);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_16816(z, fa, fb[2 * h], fb[2 * h + 1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) d[h][i] += z[i];
      }
    }
    // lane holds rows lane / 4 (and + 8: padding, dropped at AROW 8),
    // columns 2·(lane % 4) and + 1 of each 8-column half
    float* dst = part + ((size_t)s * AROW + (lane >> 2)) * ldp + col0 + n * 16 + 2 * (lane & 3);
    *reinterpret_cast<float2*>(dst) = make_float2(d[0][0], d[0][1]);
    *reinterpret_cast<float2*>(dst + 8) = make_float2(d[1][0], d[1][1]);
    if constexpr (AROW == 16) {
      *reinterpret_cast<float2*>(dst + 8 * ldp) = make_float2(d[0][2], d[0][3]);
      *reinterpret_cast<float2*>(dst + 8 * ldp + 8) = make_float2(d[1][2], d[1][3]);
    }
  }
}

// fma_product with w stored the other way, [cols][ldw]
// float, k contiguous; rows of w at or past `rows` are taken as zero.  depth
// is a multiple of 4.
template <int R>
__device__ __forceinline__ void fma_product_nk(const float* a, int lda, int depth,
                                               const float* w, int ldw, int cols,
                                               int rows, Split sp, float* part) {
  const int quads = cols / 4;
  for (int task = threadIdx.x; task < quads * sp.slices; task += kThreads) {
    const int g = task % quads, s = task / quads;
    const int k0 = s * sp.per, k1 = min(depth, k0 + sp.per);
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    for (int k = k0; k < k1; k += 4) {
      float av[R][4], wv[4][4];
#pragma unroll
      for (int r = 0; r < R; ++r) load4(a + r * lda + k, av[r]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = 4 * g + c;
        if (n < rows) {
          load4(w + (size_t)n * ldw + k, wv[c]);
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wv[c][kk] = 0.0f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r][kk], wv[c][kk], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      *reinterpret_cast<float4*>(part + ((size_t)s * R + r) * cols + 4 * g) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// Input products of a layer, off its recurrence (K12, a chunk of steps at a
// time): out(i, c) = Σ_k a(i, k)·w[c][k] for rows i < n, each a (step,
// batch row) pair, and the block's gate columns c < cols, plus bias_of(c),
// handed to put(i, c, v).  (The bias of a thread's columns is loaded once,
// before the loop: a load between the stores of put would wait out an L2
// round trip each.)  a(i, k, v) gives the inputs k .. k+3 of row i as
// float32 (zero past the depth; rounded to T here); w is the block's rows
// of the layer's wx, [cols][ldw] with k contiguous and zero past the depth
// (ldw a multiple of 16), read from L2 at every use.  The rows are staged
// srows at a time (a multiple of 16, at most kStage) into `as` ([srows][lda]
// T in shared memory), each thread's loads of a stage in flight together.  bf16: a warp owns a
// 16-column tile and both 16-row tiles of a stage, its B fragments loaded
// from L2 straight into registers and its A fragments from shared memory,
// 16 bytes a lane (frag_step); float32: a thread owns a column and 8 rows,
// FMA.

// One 32-deep step of d += a · b on the tensor cores, from fragments each
// lane loads as 16 bytes: qa0 and qa1 hold k = 8·(lane % 4) .. + 7 of A's
// rows lane / 4 and + 8, qb the same k of B's column lane / 4 (B stored a
// column to a row, k contiguous).  The k of a 32-deep step are taken in
// another order than mma's (its k 2·t, 2·t+1, 2·t+8, 2·t+9 of each 16 are
// this lane's 4·j .. 4·j+3, for the two 16-deep halves j): the same for A
// and B, so the sum is the same, and each lane's loads are whole 16 bytes.
__device__ __forceinline__ void frag_step(float (&d)[4], const uint4& qa0, const uint4& qa1,
                                          const uint4& qb) {
  const uint32_t a0[4] = {qa0.x, qa1.x, qa0.y, qa1.y};
  const uint32_t a1[4] = {qa0.z, qa1.z, qa0.w, qa1.w};
  mma_16816(d, a0, qb.x, qb.y);
  mma_16816(d, a1, qb.z, qb.w);
}

// values k .. k+3 of a row of `depth` values (zero past it), from L2: one
// vector load when `vec` (the row's start is 16-byte aligned in float32,
// 8-byte in bf16) and all four lie inside the row
template <typename X>
__device__ __forceinline__ void row4(const X* row, int k, int depth, bool vec,
                                     float (&v)[4]) {
  if (vec && k + 4 <= depth) {
    if constexpr (std::is_same<X, float>::value) {
      const float4 q = __ldcg(reinterpret_cast<const float4*>(row + k));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      const uint2 q = __ldcg(reinterpret_cast<const uint2*>(row + k));
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
      v[0] = __low2float(lo);
      v[1] = __high2float(lo);
      v[2] = __low2float(hi);
      v[3] = __high2float(hi);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = k + c < depth ? Dtype<X>::to_float(row[k + c]) : 0.0f;
  }
}

template <typename T, typename A, typename Bias, typename Put>
__device__ __forceinline__ void input_product(int n, int depth, const A& a, T* as,
                                              int lda, const T* __restrict__ w,
                                              int ldw, int cols, Bias bias_of, Put put,
                                              int srows = kStage) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int dpad = kMma<T> ? round_up(depth, 16) : round_up(depth, 4);
  // bf16: a warp owns at most one 16-column tile when cols <= 256 (US <=
  // 64), whose bias its lanes load once (past that each tile's bias is
  // loaded as the tile starts); its lane's four columns' bias
  float bcol[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  if constexpr (kMma<T>) {
    const int tile = tid / 32;
    if (tile < cols / 16)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) bcol[h][e] = bias_of(tile * 16 + 8 * h + 2 * (lane & 3) + e);
  }
  for (int i0 = 0; i0 < n; i0 += srows) {
    const int rows = min(srows, n - i0);
    const int dq = dpad / 4;
    for (int e0 = 0; e0 < srows * dq; e0 += 8 * kThreads) {
      float v[8][4];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads + tid, r = e / dq, k = 4 * (e - r * dq);
        if (e < srows * dq && r < rows && k < depth) {
          a(i0 + r, k, v[u]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) v[u][c] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads + tid, r = e / dq, k = 4 * (e - r * dq);
        if (e < srows * dq)
#pragma unroll
          for (int c = 0; c < 4; ++c) as[r * lda + k + c] = Dtype<T>::from_float(v[u][c]);
      }
    }
    __syncthreads();
    if constexpr (kMma<T>) {
      const int g = lane >> 2, t4 = lane & 3;
      const int mt = cdiv(rows, 16);
      for (int tile = tid / 32; tile < cols / 16; tile += kWarps) {
        // past 256 columns a warp owns several tiles: each tile's bias
        // anew (the next stage's first tile too)
        if (cols > 16 * kWarps)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) bcol[h][e] = bias_of(tile * 16 + 8 * h + 2 * t4 + e);
        float d[2][2][4] = {};
        // B rows n = 16·tile + 8·h + g, eight k from 8·t4 of each 32-deep
        // step (frag_step's order)
        const T* w_lane = w + (size_t)(tile * 16 + g) * ldw + 8 * t4;
        const T* a_lane = as + g * lda + 8 * t4;
        // kBatch 32-deep steps at a time: their B loads are issued together
        // before the products (the mma asm keeps program order, so loads
        // interleaved with them would each wait out an L2 round trip)
        constexpr int kBatch = 4;
        for (int k0 = 0; k0 < dpad; k0 += 32 * kBatch) {
          uint4 qb[kBatch][2];
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int k = k0 + 32 * u;
              qb[u][h] = k + 8 * t4 + 8 <= dpad
                             ? __ldg(reinterpret_cast<const uint4*>(w_lane + (size_t)h * 8 * ldw + k))
                             : make_uint4(0u, 0u, 0u, 0u);
            }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int k = k0 + 32 * u;
            if (k >= dpad) break;
            const bool in = k + 8 * t4 + 8 <= dpad;
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              if (m < mt) {
                const uint4 z = make_uint4(0u, 0u, 0u, 0u);
                const T* ap = a_lane + m * 16 * lda + k;
                const uint4 qa0 = in ? *reinterpret_cast<const uint4*>(ap) : z;
                const uint4 qa1 = in ? *reinterpret_cast<const uint4*>(ap + 8 * lda) : z;
                frag_step(d[m][0], qa0, qa1, qb[u][0]);
                frag_step(d[m][1], qa0, qa1, qb[u][1]);
              }
            }
          }
        }
        // lane holds rows lane / 4 and + 8, columns 2·(lane % 4) and + 1
        // of each 8-column half
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = m * 16 + (lane >> 2) + 8 * (e >> 1);
              if (r < rows)
                put(i0 + r, tile * 16 + 8 * h + 2 * (lane & 3) + (e & 1),
                    d[m][h][e] + bcol[h][e & 1]);
            }
      }
    } else {
      for (int task = tid; task < cols * (srows / 8); task += kThreads) {
        const int c = task % cols, rg = task / cols;
        if (rg * 8 >= rows) continue;
        const float b = bias_of(c);
        float acc[8] = {};
        for (int k = 0; k < dpad; k += 4) {
          float wv[4];
          load4(reinterpret_cast<const float*>(w) + (size_t)c * ldw + k, wv);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            float av[4];
            load4(reinterpret_cast<const float*>(as) + (rg * 8 + r) * lda + k, av);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) acc[r] = fmaf(av[kk], wv[kk], acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (rg * 8 + r < rows) put(i0 + rg * 8 + r, c, acc[r] + b);
      }
    }
    __syncthreads();
  }
}

// The step counters of a stack's clusters: each block of a cluster counts
// the steps whose results it has written (int32, zero at launch).  publish:
// every thread's writes are fenced, then one thread stores the count.
__device__ __forceinline__ void publish(int* counter, int done) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicExch(counter, done);
}

// Wait until each of the C counters of another cluster (counters[0..C-1])
// reaches `want`; the data they count is then read from L2 (__ldcg).
// Thread q < C keeps in `seen` the last count it read of counter q and
// polls only when that is short.  A wait of seconds means a fault: the
// launch ends with an error rather than hang (a step takes microseconds).
template <int C>
__device__ __forceinline__ void wait_blocks(int* counters, int want, int& seen) {
  if (threadIdx.x < C && seen < want) {
    int* c = counters + threadIdx.x;
    for (long long spins = 0; (seen = atomicAdd(c, 0)) < want; ++spins) {
      if (spins > (1LL << 26)) __trap();
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// The cluster launch of a layer kernel (K1, K2) over 2·ceil(B/R) clusters
// of C blocks (a direction and row tile each), with `smem` bytes a block:
// its configuration, and the occupancy API's clusters resident at once in
// `fit`
template <typename K>
cudaError_t cluster_config(K kernel, int batch, int R, int C, size_t smem, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int* fit) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (C > kCluster) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C * cdiv(batch, R), 2, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  *fit = 0;
  return cudaOccupancyMaxActiveClusters(fit, (const void*)kernel, cfg);
}

// ---- the streamed plans (K1, K2, K12, K13): weight slices past shared
// memory (K1's products: streamed_product_t; K12's: streamed_product; K2's
// and K13's passes: bwd_dob_pass, bwd_wh_pass) ----
//
// A block keeps the first rows of its wh slice in shared memory and
// streams the rest of its weights from L2 at every step, in a fixed
// sequence of chunks (whole 16-deep k-steps of one matrix, laid out by the
// wrapper as they lie in shared memory, so a chunk is one dense run of
// bytes) through a ring of `depth` slots: chunk n lands in slot n % depth
// by one bulk copy (cp.async.bulk) that completes its bytes on the slot's
// barrier, whose phase n / depth the readers wait for.  A slot is refilled
// with chunk n + depth by thread 0 right after the block barrier that ends
// every thread's reads of chunk n, so up to `depth` chunks are in flight,
// and the chunks of the next product (the next step's, too: the weights do
// not depend on the step) land while the block does other work.  Only
// chunks of the sequence are issued, so none is in flight when the block
// exits.  Tried on the card and not kept: copying a chunk row by row
// (the rows unpadded in global memory), a ring of 8 slots (whose plans
// keep less of wh resident), and every thread's cp.async pieces of a chunk
// in place of the bulk copy; none ran faster.
// (kChunkBytes, kMaxSlots and kAllHeld are at the top.)

// `bytes` (a multiple of 16) from global into this block's shared memory,
// completing them on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

struct Ring {
  unsigned char* base;
  uint64_t* full;  // one barrier a slot
  int depth;
  size_t slot;     // bytes a slot
  template <typename T>
  __device__ T* at(int n) const {
    return reinterpret_cast<T*>(base + (size_t)(n % depth) * slot);
  }
  __device__ void wait(int n) const { mbar_wait(full + n % depth, (uint32_t)(n / depth) & 1u); }
  // one thread: chunk n, `bytes` from `src`, into its slot, the slot's
  // barrier armed for them
  __device__ void issue(int n, const void* src, uint32_t bytes) const {
    mbar_expect(full + n % depth, bytes);
    bulk_load(base + (size_t)(n % depth) * slot, src, bytes, full + n % depth);
  }
};

// The k-steps of one pass over a weight matrix's rows: the resident rows
// first (steps [0, res) at `res_w`, row stride ldres), then the ring's
// chunks of `chunk` steps (row stride ldw) from chunk `n` on, each waited
// for, read by visit(w, step within the chunk's rows, global step), then
// released: a block barrier, and thread 0 issues chunk n + depth when it
// is below `total`.  Every thread of the block calls it.  n is advanced.
template <typename Visit, typename Issue>
__device__ __forceinline__ void stream_pass(int steps, const __nv_bfloat16* res_w, int ldres,
                                            int res, const Ring& ring, int ldw, int chunk,
                                            int& n, int total, Issue issue, Visit visit) {
  int j = 0;
  for (; j < res && j < steps; ++j) visit(res_w, ldres, j, j);
  while (j < steps) {
    ring.wait(n);
    const __nv_bfloat16* w = ring.at<const __nv_bfloat16>(n);
    const int j1 = min(steps, j + chunk);
    for (int k = 0; j < j1; ++j, ++k) visit(w, ldw, k, j);
    __syncthreads();
    if (threadIdx.x == 0 && n + ring.depth < total) issue(n + ring.depth);
    ++n;
  }
}

// K1's products on the streamed plan (mma_product_t's roles: a tile of the
// weights, read transposed, as mma's A, the rows of a as its n): out[r][c]
// (row stride ldo) = init(r, c), then + the sum of each k-slice of `per`
// 16-deep steps, in slice order, each slice summed on the tensor cores in
// step order into a zero accumulator: mma_product_t's slices, added as its
// reader adds them (so a shape that fits both plans gives the same bits on
// both).  a holds NT n8 tiles of rows (8 or 16 rows; rows past R zero),
// which share each A fragment of the weights, so one pass over the ring
// serves 16 rows; a row's sums do not depend on the rows beside it, so a
// row gives the same bits at any NT.  Warp w owns the tiles w, w + 16, ..
// (TMAX at most) over the whole depth.
template <int TMAX, int NT, typename Init, typename Issue>
__device__ __forceinline__ void streamed_product_t(const __nv_bfloat16* a, int lda, int depth,
                                                   int cols, int per, const __nv_bfloat16* res_w,
                                                   int ldres, int res, const Ring& ring, int ldw,
                                                   int chunk, int& n, int total, Issue issue,
                                                   Init init, float* out, int ldo) {
  static_assert(NT == 1 || NT == 2, "8 or 16 rows");
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int tm = cols / 16;
  float acc[TMAX][NT][4], d[TMAX][NT][4];
#pragma unroll
  for (int i = 0; i < TMAX; ++i) {
    const int c = (warp + kWarps * i) * 16 + (lane >> 2);
    const bool in = warp + kWarps * i < tm;
#pragma unroll
    for (int m = 0; m < NT; ++m) {
      const int r = 8 * m + 2 * (lane & 3);
      acc[i][m][0] = in ? init(r, c) : 0.0f;
      acc[i][m][1] = in ? init(r + 1, c) : 0.0f;
      acc[i][m][2] = in ? init(r, c + 8) : 0.0f;
      acc[i][m][3] = in ? init(r + 1, c + 8) : 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][m][e] = 0.0f;
    }
  }
  const __nv_bfloat16* b_lane = a + (lane & 7) * lda + ((lane >> 3) & 1) * 8;
  const int wrow = lane & 15, wcol = (lane >> 4) * 8;
  stream_pass(cdiv(depth, 16), res_w, ldres, res, ring, ldw, chunk, n, total, issue,
              [&](const __nv_bfloat16* w, int ld, int k, int j) {
                if (j > 0 && j % per == 0) {
#pragma unroll
                  for (int i = 0; i < TMAX; ++i)
#pragma unroll
                    for (int m = 0; m < NT; ++m)
#pragma unroll
                      for (int e = 0; e < 4; ++e) {
                        acc[i][m][e] += d[i][m][e];
                        d[i][m][e] = 0.0f;
                      }
                }
                uint32_t fb[NT][2];
#pragma unroll
                for (int m = 0; m < NT; ++m) ldsm_x2(fb[m], b_lane + (size_t)m * 8 * lda + j * 16);
#pragma unroll
                for (int i = 0; i < TMAX; ++i) {
                  const int t = warp + kWarps * i;
                  if (t < tm) {
                    uint32_t fw[4];
                    ldsm_x4_trans(fw, w + (size_t)(k * 16 + wrow) * ld + wcol + t * 16);
                    const uint32_t fa[4] = {fw[0], fw[2], fw[1], fw[3]};
#pragma unroll
                    for (int m = 0; m < NT; ++m) mma_16816(d[i][m], fa, fb[m][0], fb[m][1]);
                  }
                }
              });
#pragma unroll
  for (int i = 0; i < TMAX; ++i) {
    const int t = warp + kWarps * i;
    if (t < tm)
#pragma unroll
      for (int m = 0; m < NT; ++m) {
        float* dst = out + (size_t)(8 * m + 2 * (lane & 3)) * ldo + t * 16 + (lane >> 2);
        dst[0] = acc[i][m][0] + d[i][m][0];
        dst[ldo] = acc[i][m][1] + d[i][m][1];
        dst[8] = acc[i][m][2] + d[i][m][2];
        dst[ldo + 8] = acc[i][m][3] + d[i][m][3];
      }
  }
}

// The same with mma_product's roles (K12 on the streamed plan): the rows
// of a as mma's A, a 16-column tile of the weights as its B (two n = 8
// halves), each k-slice of `per` steps summed by the tensor cores into one
// accumulator in step order, as mma_product sums it, and the slices added
// in slice order onto init, as mma_product's reader adds them: a shape
// that fits both plans gives the same bits on both.  a holds AROW rows
// (rows past R zero): 8, loaded once by ldmatrix.x2 (mma's rows 8-15 their
// copy, never stored), or one or two whole 16-row tiles (ldmatrix.x4),
// which share each B fragment, so one pass over the chunks serves them
// all.  A row's sums do not depend on the rows beside it, so a row gives
// the same bits at any AROW.  out[r][c] (row stride ldo) for r < AROW;
// warp w owns the tiles w, w + 16, .. (TMAX at most) over the whole depth.
template <int TMAX, int AROW, typename Init, typename Issue>
__device__ __forceinline__ void streamed_product(const __nv_bfloat16* a, int lda, int depth,
                                                 int cols, int per, const __nv_bfloat16* res_w,
                                                 int ldres, int res, const Ring& ring, int ldw,
                                                 int chunk, int& n, int total, Issue issue,
                                                 Init init, float* out, int ldo) {
  static_assert(AROW == 8 || AROW == 16 || AROW == 32, "8 rows, or one or two 16-row tiles");
  constexpr int MT = AROW == 8 ? 1 : AROW / 16;  // mma's 16-row tiles
  constexpr int RH = AROW == 8 ? 1 : 2;          // rows a lane stores of a tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int tm = cols / 16, row = lane >> 2, col = 2 * (lane & 3);
  float acc[TMAX][MT][2][2 * RH], d[TMAX][MT][2][4];
#pragma unroll
  for (int i = 0; i < TMAX; ++i) {
    const bool in = warp + kWarps * i < tm;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = (warp + kWarps * i) * 16 + 8 * h + col;
#pragma unroll
        for (int e = 0; e < RH; ++e) {
          acc[i][m][h][2 * e] = in ? init(16 * m + row + 8 * e, c) : 0.0f;
          acc[i][m][h][2 * e + 1] = in ? init(16 * m + row + 8 * e, c + 1) : 0.0f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) d[i][m][h][e] = 0.0f;
      }
  }
  const __nv_bfloat16* a_lane = AROW == 8 ? a + (lane & 7) * lda + ((lane >> 3) & 1) * 8
                                          : a + (lane & 15) * lda + (lane >> 4) * 8;
  const int wrow = lane & 15, wcol = (lane >> 4) * 8;
  stream_pass(cdiv(depth, 16), res_w, ldres, res, ring, ldw, chunk, n, total, issue,
              [&](const __nv_bfloat16* w, int ld, int k, int j) {
                if (j > 0 && j % per == 0) {
#pragma unroll
                  for (int i = 0; i < TMAX; ++i)
#pragma unroll
                    for (int m = 0; m < MT; ++m)
#pragma unroll
                      for (int h = 0; h < 2; ++h) {
#pragma unroll
                        for (int e = 0; e < 2 * RH; ++e) acc[i][m][h][e] += d[i][m][h][e];
#pragma unroll
                        for (int e = 0; e < 4; ++e) d[i][m][h][e] = 0.0f;
                      }
                }
                uint32_t fa[MT][4];
#pragma unroll
                for (int m = 0; m < MT; ++m) {
                  if constexpr (AROW == 8) {
                    uint32_t fr[2];
                    ldsm_x2(fr, a_lane + j * 16);
                    fa[m][0] = fa[m][1] = fr[0];
                    fa[m][2] = fa[m][3] = fr[1];
                  } else {
                    ldsm_x4(fa[m], a_lane + (size_t)m * 16 * lda + j * 16);
                  }
                }
#pragma unroll
                for (int i = 0; i < TMAX; ++i) {
                  const int t = warp + kWarps * i;
                  if (t < tm) {
                    uint32_t fb[4];
                    ldsm_x4_trans(fb, w + (size_t)(k * 16 + wrow) * ld + wcol + t * 16);
#pragma unroll
                    for (int m = 0; m < MT; ++m) {
                      mma_16816(d[i][m][0], fa[m], fb[0], fb[1]);
                      mma_16816(d[i][m][1], fa[m], fb[2], fb[3]);
                    }
                  }
                }
              });
#pragma unroll
  for (int i = 0; i < TMAX; ++i) {
    const int t = warp + kWarps * i;
    if (t < tm)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < RH; ++e)
            *reinterpret_cast<float2*>(out + (size_t)(16 * m + row + 8 * e) * ldo + t * 16 +
                                       8 * h + col) =
                make_float2(acc[i][m][h][2 * e] + d[i][m][h][2 * e],
                            acc[i][m][h][2 * e + 1] + d[i][m][h][2 * e + 1]);
  }
}

// ---- the backwards' passes on the streamed plan (K2, K13) ----
//
// dout_blk over proj's chunks of rows (the units), each chunk's sums
// complete: mma_f32add_tiles over the chunk's 16-row tiles, part[s][AROW][nd]
// as the resident plans' slices; then the chunk's release (a block barrier,
// thread 0 issues chunk n + slots below `total`).  np chunks of cu tiles,
// utiles in all.  Every thread of the block calls it.
template <int AROW = 8, typename Issue>
__device__ __forceinline__ void bwd_dob_pass(const __nv_bfloat16* dq, int lda, int p16,
                                             const Ring& ring, int lpj, int np, int cu,
                                             int utiles, Split dob, float* part, int nd, int& n,
                                             int total, Issue issue) {
  for (int i = 0; i < np; ++i) {
    ring.wait(n);
    const int t0 = i * cu, nt = min(cu, utiles - t0);
    mma_f32add_tiles<true, AROW>(dq, lda, p16, ring.at<const __nv_bfloat16>(n), lpj, nt, dob,
                                 part, nd, 16 * t0);
    __syncthreads();
    if (threadIdx.x == 0 && n + ring.depth < total) issue(n + ring.depth);
    ++n;
  }
}

// The pass over wh's rows p (wsteps 16-deep steps: `res` resident at
// res_w, the rest streamed in chunks of cw, rows of stride lws): a chunk of
// rows p holds every weight that dh_prev's columns p need (their whole
// depth, the G = 4·US gate columns), and a slice of the depth of the gate
// sums, so one pass serves both.  With `dh_on`, dh_prev's partial dgates ·
// wh_qᵀ (gq [AROW][ldg], gsteps 16-deep steps of G): the 16 columns p of a
// chunk's tile j on two warps, 15 - (2·j + h) % 16 for the 8-column half h,
// each summing its half over the whole depth in one chain, its sums of rows
// r < rows handed to put_dh(r, p, columns p and p + 1); with `gate_on`, the
// gate sums init(r, c) + hq · wh_q (hq [AROW][lda]; warp w owns the tiles w
// and w + 16 over the whole pass) into gsum [rows][G], which holds their
// init and finished slices (each lane its own elements).  Each in the
// resident plans' k-slices (`gates`, `dh`) as mma_product_f32add sums them
// (each 16-deep step into a zero accumulator, added in float32), added in
// slice order: the bits of the resident plans.  A operands of AROW rows: 8,
// loaded once for mma's 16 (rows 8-15 a copy, never stored), or a whole
// 16-row tile; a row's sums do not depend on the rows beside it, so a row
// gives the same bits at any AROW.  The products are not volatile, so a
// warp's loads run ahead of them.  kHeld (every step of wh resident, no
// ring: K13's resident plan of 16 blocks): a warp runs its dh_prev
// half-tiles first, then its gate tiles over all the steps in one tight
// loop, where interleaving them step by step, as the ring's chunks need,
// left each step's loads and products waiting on one another: the same
// sums in the same order.  K2 and K13 on the streamed plan run it.
template <int AROW, bool kHeld, typename Init, typename Issue, typename PutDh>
__device__ __forceinline__ void bwd_wh_pass(bool dh_on, bool gate_on, const __nv_bfloat16* hq,
                                            int lda, const __nv_bfloat16* gq, int ldg, int G,
                                            int wsteps, int gsteps, Split gates, Split dh,
                                            const __nv_bfloat16* res_w, int lws, int res,
                                            const Ring& ring, int cw, int& n, int total,
                                            Issue issue, Init init, int rows, float* gsum,
                                            PutDh put_dh) {
  static_assert(AROW == 8 || AROW == 16, "8 rows, or mma's 16");
  constexpr int RH = AROW == 8 ? 1 : 2;  // rows a lane stores: lane / 4 (and + 8)
  typedef __nv_bfloat16 T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int gtiles = G / 16, row = lane >> 2, col = 2 * (lane & 3);
  // A's rows: lane % 8 at k + 8·(lane / 8 % 2) (AROW 16: lane % 16 at k +
  // 8·(lane / 16))
  const int a_row = AROW == 8 ? lane & 7 : lane & 15;
  const int a_off = AROW == 8 ? ((lane >> 3) & 1) * 8 : (lane >> 4) * 8;
  const T* a_h = hq + a_row * lda + a_off;
  const T* a_g = gq + a_row * ldg + a_off;
  auto frag_a = [&](uint32_t (&fa)[4], const T* p) {
    if constexpr (AROW == 8) {
      uint32_t fr[2];
      ldsm_x2(fr, p);
      fa[0] = fa[1] = fr[0];
      fa[2] = fa[3] = fr[1];
    } else {
      ldsm_x4(fa, p);
    }
  };
  // the lane's gate-sum elements: tile i, half h, element e (rows row and
  // row + 8, columns c and c + 1)
  auto gate_at = [&](int i, int h, int e, int& r, int& c) {
    const int t = warp + kWarps * i;
    r = row + 8 * (e >> 1);
    c = t * 16 + 8 * h + col + (e & 1);
    return gate_on && t < gtiles && r < rows;
  };
  float gd[2][2][2 * RH];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2 * RH; ++e) {
        int r, c;
        if (gate_at(i, h, e, r, c)) gsum[(size_t)r * G + c] = init(r, c);
        gd[i][h][e] = 0.0f;
      }
  // add the slice's sums onto gsum
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2 * RH; ++e) {
          int r, c;
          if (gate_at(i, h, e, r, c)) gsum[(size_t)r * G + c] += gd[i][h][e];
          gd[i][h][e] = 0.0f;
        }
  };
  // the gate sums' 16-deep step j (at row k of w)
  auto gate_step = [&](const T* w, int ldw, int k, int j) {
    if (j > 0 && j % gates.per == 0) flush();
    uint32_t fa[4];
    frag_a(fa, a_h + j * 16);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = warp + kWarps * i;
      if (t < gtiles) {
        uint32_t fb[4];
        ldsm_x4_trans(fb, w + (size_t)(k * 16 + (lane & 15)) * ldw + (lane >> 4) * 8 + t * 16);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_16816_free(z, fa, fb[2 * h], fb[2 * h + 1]);
#pragma unroll
          for (int e = 0; e < 2 * RH; ++e) gd[i][h][e] += z[e];
        }
      }
    }
  };
  // dh_prev's columns 16·j + 8·h .. + 7 (at rows 16·k + 8·h of w), over
  // the whole depth of G
  auto dh_half = [&](const T* w, int ldw, int k, int j, int h) {
    // B: wh's rows n = 16·k + 8·h + lane % 8 at k + 8·(lane / 8 % 2)
    const T* w_lane = w + (size_t)(k * 16 + 8 * h + (lane & 7)) * ldw + ((lane >> 3) & 1) * 8;
    // each k-slice's steps summed in order into d (a zero
    // accumulator a step, as mma_f32add_tiles), the slices in order
    // into acc; a step's fragments are loaded while the step before
    // multiplies
    float acc[2 * RH];
#pragma unroll
    for (int e = 0; e < 2 * RH; ++e) acc[e] = 0.0f;
    for (int s0 = 0; s0 < gsteps; s0 += dh.per) {
      const int s1 = min(gsteps, s0 + dh.per);
      float d[2 * RH];
#pragma unroll
      for (int e = 0; e < 2 * RH; ++e) d[e] = 0.0f;
      auto step = [&](const uint32_t (&fa)[4], const uint32_t (&fb)[2]) {
        float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_16816_free(z, fa, fb[0], fb[1]);
#pragma unroll
        for (int e = 0; e < 2 * RH; ++e) d[e] += z[e];
      };
      uint32_t fa0[4], fb0[2], fa1[4], fb1[2];
      frag_a(fa0, a_g + s0 * 16);
      ldsm_x2(fb0, w_lane + s0 * 16);
      int kk = s0;
      for (; kk + 1 < s1; kk += 2) {
        frag_a(fa1, a_g + (kk + 1) * 16);
        ldsm_x2(fb1, w_lane + (kk + 1) * 16);
        step(fa0, fb0);
        if (kk + 2 < s1) {
          frag_a(fa0, a_g + (kk + 2) * 16);
          ldsm_x2(fb0, w_lane + (kk + 2) * 16);
        }
        step(fa1, fb1);
      }
      if (kk < s1) step(fa0, fb0);
#pragma unroll
      for (int e = 0; e < 2 * RH; ++e) acc[e] += d[e];
    }
#pragma unroll
    for (int e = 0; e < RH; ++e)
      if (row + 8 * e < rows)
        put_dh(row + 8 * e, 16 * j + 8 * h + col, acc[2 * e], acc[2 * e + 1]);
  };
  if constexpr (kHeld) {
    // the half-tiles m = 2·j + h of this warp: 15 - warp, + 16, ..
    if (dh_on)
      for (int m = kWarps - 1 - warp; m < 2 * wsteps; m += kWarps)
        dh_half(res_w, lws, m >> 1, m >> 1, m & 1);
    if (gate_on) {
#pragma unroll 4
      for (int j = 0; j < wsteps; ++j) gate_step(res_w, lws, j, j);
    }
  } else {
    stream_pass(wsteps, res_w, lws, res, ring, lws, cw, n, total, issue,
                [&](const T* w, int ldw, int k, int j) {
                  if (gate_on) gate_step(w, ldw, k, j);
                  if (dh_on) {
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                      if (warp == kWarps - 1 - (2 * j + h) % kWarps) dh_half(w, ldw, k, j, h);
                  }
                });
  }
  if (gate_on) flush();
  __syncthreads();
}

}  // namespace
