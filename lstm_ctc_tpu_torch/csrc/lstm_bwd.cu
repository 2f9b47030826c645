// Kernel K2: one BLSTM layer's whole-sequence backward, both directions,
// with the weight gradients of the recurrence.
//
// Replaces the TPU kernel lstm_ctc_tpu/ops/lstm_pallas.py _make_bwd_kernel
// (fold_dx=False, :134-418), launched by pallas_bwd (:518) from the VJP
// fused_bwd (:597-619).  Steps run T-1 .. 0, carrying (dc, dh), the
// cotangents of the carried states, from (dcfin, dhfin).  Each step
// (:230-319) recomputes the gates from the stored previous states
// (c_prev, h_prev, zeroed at packed-segment starts), then
//   dout_p = m·(dout + dh),  dout_blk = dout_p·projᵀ,
//   do, dc_new (+ the o-peephole term), df, di, dj,
//   dc_prev = dc_new·sf + (1-m)·dc (+ the f and i peephole terms),
//   dh_prev = (1-m)·dh + dgates·whᵀ,
// and the keep channel zeroes (dc_prev, dh_prev) at segment starts.  Past
// the length m = 0 and dc, dh pass through unchanged.  dgates is emitted
// in the store dtype; dx, dwx and dbias are products over it outside the
// kernel, as XLA does them outside the TPU kernel.
//
// The weight gradients (:331-371) are this file's own kernels too, over
// per-step stashes the recurrence writes (c_new, the pre-projection output
// out_blk, dout_p; the TPU kernel keeps them in VMEM):
//   dwh = Σ_(t,b) h_prevᵀ·dgates,  dproj = Σ out_blkᵀ·dout_p  (wgrad_kernel),
//   dpeep = Σ dgates_i·c_prev, Σ dgates_f·c_prev, Σ dgates_o·c_new
//   (peep_partial_kernel, then peep_sum_kernel, in a fixed order).
// Operands of every product are rounded to the compute dtype; sums, the
// carry and every output except dgates stay float32.  The float32 path
// uses FMA only, never TF32.
//
// What bounds it on the H100: like the forward, the recurrence is
// sequential, so each step's latency counts; a step reads the direction's
// wh twice (as wh and whᵀ) and proj once, 1.8 MB in bf16 at H = P = 320.
// This first version is the simple one: one block per (direction, tile of
// kRows batch rows) owns the time loop and reads the weights from L2 at
// every step, with FMA products split over all threads (4 columns and a
// slice of k each).  Holding the weights in a cluster's shared memory, as
// the forward does, needs a cluster-wide reduction for the two transposed
// products (the split dimension is the one summed over) and is later work.
// The weight-gradient products are plain tiled FMA GEMMs over the
// T·B rows (128x128 output tiles, 8x8 a thread), split over the rows so
// that the card is full, with the partial sums added in a fixed order.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kRows = 2;        // batch rows per block
constexpr int kMaxSlices = 16;  // most k-slices one product is split into
constexpr int kTile = 128;      // wgrad output tile
constexpr int kDepth = 16;      // wgrad k-chunk
constexpr int kPeepRows = 256;  // rows of one peephole partial sum

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

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
// [depth][cols] row-major in global memory.
template <typename W>
__device__ void block_product(const float* a, int lda, int depth,
                              const W* __restrict__ w, int cols, float* part) {
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
      load4(w + (size_t)k * cols + 4 * g, wv);
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

// Shared-memory plan (floats): operands and carries, then the partials.
struct Plan {
  size_t a_h, a_dp, cp, dc, dh, dp, gates, dob, a_dg, part, total;
};

__host__ __device__ Plan plan(int H, int P) {
  Plan p;
  const int G = 4 * H;
  size_t o = 0;
  p.a_h = o;   o += (size_t)kRows * P;
  p.a_dp = o;  o += (size_t)kRows * P;
  p.cp = o;    o += (size_t)kRows * H;
  p.dc = o;    o += (size_t)kRows * H;
  p.dh = o;    o += (size_t)kRows * P;
  p.dp = o;    o += (size_t)kRows * P;
  p.gates = o; o += (size_t)kRows * G;
  p.dob = o;   o += (size_t)kRows * H;
  p.a_dg = o;  o += (size_t)kRows * G;
  o = (o + 3) / 4 * 4;  // 16-byte aligned partials
  p.part = o;
  const size_t pg = (size_t)split_of(G, P).slices * G;
  const size_t pp = (size_t)split_of(H, P).slices * H;
  const size_t ph = (size_t)split_of(P, G).slices * P;
  size_t most = pg > pp ? pg : pp;
  most = most > ph ? most : ph;
  p.total = o + kRows * most;
  return p;
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads) lstm_bwd_kernel(
    const float* __restrict__ gx,     // [T, 2B, 4H]
    const int* __restrict__ lengths,  // [B]
    const float* __restrict__ keep,   // [T, B] or null
    const S* __restrict__ c_all,      // [T, 2B, H] store dtype
    const S* __restrict__ h_all,      // [T, 2B, P] store dtype
    const T* __restrict__ wh,         // [2, P, 4H]
    const T* __restrict__ wht,        // [2, 4H, P]
    const T* __restrict__ projt,      // [2, P, H] or null (P == H)
    const float* __restrict__ peep,   // [2, 3, H] or null
    float forget_bias,
    const float* __restrict__ dout,   // [T, 2B, P]
    const float* __restrict__ dcfin,  // [2B, H]
    const float* __restrict__ dhfin,  // [2B, P]
    int steps, int batch, int H, int P,
    S* __restrict__ dgates,           // [T, 2B, 4H]
    float* __restrict__ cnew_st,      // [T, 2B, H]
    float* __restrict__ outb_st,      // [T, 2B, H] or null
    float* __restrict__ doutp_st,     // [T, 2B, P] or null
    float* __restrict__ dc_in,        // [T, 2B, H] or null
    float* __restrict__ dh_in) {      // [T, 2B, P] or null
  const int dir = blockIdx.y, b0 = blockIdx.x * kRows;
  const int nr = min(kRows, batch - b0);
  const int G = 4 * H, tid = threadIdx.x;
  const bool has_proj = projt != nullptr;
  const Plan pl = plan(H, P);
  extern __shared__ __align__(16) float sm[];
  float *a_h = sm + pl.a_h, *a_dp = sm + pl.a_dp, *cp = sm + pl.cp;
  float *dc = sm + pl.dc, *dh = sm + pl.dh, *dp = sm + pl.dp;
  float *gates = sm + pl.gates, *dob = sm + pl.dob, *a_dg = sm + pl.a_dg;
  float* part = sm + pl.part;
  for (int i = tid; i < (int)pl.part; i += kThreads) sm[i] = 0.0f;
  __syncthreads();
  const size_t frow = (size_t)dir * batch + b0;
  for (int i = tid; i < nr * H; i += kThreads)
    dc[i] = dcfin[(frow + i / H) * H + i % H];
  for (int i = tid; i < nr * P; i += kThreads)
    dh[i] = dhfin[(frow + i / P) * P + i % P];
  const T* wh_d = wh + (size_t)dir * P * G;
  const T* wht_d = wht + (size_t)dir * G * P;
  const T* pj_d = has_proj ? projt + (size_t)dir * P * H : nullptr;
  const float* pd = peep ? peep + (size_t)dir * 3 * H : nullptr;
  const Split sg = split_of(G, P), sp = split_of(H, P), sh = split_of(P, G);
  __syncthreads();

  for (int t = steps - 1; t >= 0; --t) {
    const size_t row0 = (size_t)t * 2 * batch + frow;   // this step's rows
    const size_t prev0 = row0 - 2 * (size_t)batch;      // the step before
    // 1. operands: the previous states, dout_p; the incoming carries
    for (int i = tid; i < nr * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      const float kp = keep ? keep[(size_t)t * batch + b0 + r] : 1.0f;
      const float m = t < lengths[b0 + r] ? 1.0f : 0.0f;
      const float hp = t > 0 ? kp * ld(h_all, (prev0 + r) * P + p) : 0.0f;
      a_h[r * P + p] = rnd<T>(hp);
      const float v = m * (dout[(row0 + r) * P + p] + dh[i]);
      dp[i] = v;
      a_dp[r * P + p] = rnd<T>(v);
      if (doutp_st) doutp_st[(row0 + r) * P + p] = v;
      if (dh_in) dh_in[(row0 + r) * P + p] = dh[i];
    }
    for (int i = tid; i < nr * H; i += kThreads) {
      const int r = i / H, u = i - r * H;
      const float kp = keep ? keep[(size_t)t * batch + b0 + r] : 1.0f;
      cp[i] = t > 0 ? kp * ld(c_all, (prev0 + r) * H + u) : 0.0f;
      if (dc_in) dc_in[(row0 + r) * H + u] = dc[i];
    }
    __syncthreads();
    // 2. the gates, recomputed
    block_product(a_h, P, P, wh_d, G, part);
    __syncthreads();
    for (int i = tid; i < nr * G; i += kThreads) {
      const int r = i / G, g = i - r * G;
      gates[i] = gx[(row0 + r) * G + g] + part_sum(part, sg.slices, G, r, g);
    }
    __syncthreads();
    // 3. dout_blk = dout_p · projᵀ
    if (has_proj) {
      block_product(a_dp, P, P, pj_d, H, part);
      __syncthreads();
      for (int i = tid; i < nr * H; i += kThreads)
        dob[i] = part_sum(part, sp.slices, H, i / H, i % H);
    } else {
      for (int i = tid; i < nr * H; i += kThreads) dob[i] = dp[i];
    }
    __syncthreads();
    // 4. the cell's backward, one (row, unit) a thread
    for (int i = tid; i < nr * H; i += kThreads) {
      const int r = i / H, u = i - r * H;
      const float* g = gates + r * G;
      const float m = t < lengths[b0 + r] ? 1.0f : 0.0f;
      const float kp = keep ? keep[(size_t)t * batch + b0 + r] : 1.0f;
      const float c0 = cp[i];
      float gi = g[u], gf = g[2 * H + u], go = g[3 * H + u];
      if (pd) {
        gi += pd[u] * c0;
        gf += pd[H + u] * c0;
      }
      const float si = sigmoidf(gi), tj = tanhf(g[H + u]);
      const float sf = sigmoidf(gf + forget_bias);
      const float cn = sf * c0 + si * tj;
      if (pd) go += pd[2 * H + u] * cn;
      const float so = sigmoidf(go), tc = tanhf(cn);
      const float db = dob[i];
      const float d_o = db * tc * so * (1.0f - so);
      float dcn = db * so * (1.0f - tc * tc) + m * dc[i];
      if (pd) dcn += d_o * pd[2 * H + u];
      const float d_f = dcn * c0 * sf * (1.0f - sf);
      const float d_i = dcn * tj * si * (1.0f - si);
      const float d_j = dcn * si * (1.0f - tj * tj);
      float dcp = dcn * sf + (1.0f - m) * dc[i];
      if (pd) dcp += d_f * pd[H + u] + d_i * pd[u];
      dc[i] = kp * dcp;
      const float dgv[4] = {d_i, d_j, d_f, d_o};
      S* dg_row = dgates + (row0 + r) * G;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dg_row[k * H + u] = Dtype<S>::from_float(dgv[k]);
        a_dg[r * G + k * H + u] = rnd<T>(dgv[k]);
      }
      cnew_st[(row0 + r) * H + u] = cn;
      if (outb_st) outb_st[(row0 + r) * H + u] = so * tc;
    }
    __syncthreads();
    // 5. dh_prev = (1-m)·dh + dgates · whᵀ
    block_product(a_dg, G, G, wht_d, P, part);
    __syncthreads();
    for (int i = tid; i < nr * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      const float m = t < lengths[b0 + r] ? 1.0f : 0.0f;
      const float kp = keep ? keep[(size_t)t * batch + b0 + r] : 1.0f;
      dh[i] = kp * ((1.0f - m) * dh[i] + part_sum(part, sh.slices, P, r, p));
    }
    __syncthreads();
  }
}

// partial[split][dir][m][n] = Σ over the split's rows (t, b) of
// a(t, b)[m] · bm(t, b)[n], over the rows of one direction of [T, 2B, ·]
// streams; with a_prev, a(t, b) is row (t-1, b) times keep[t, b] (zeros at
// t = 0), the states a step starts from.  Operands rounded to bf16 when
// round_bf16.  A block owns a 128x128 tile, a thread 8x8 of it.
template <typename TA, typename TB>
__global__ void __launch_bounds__(256) wgrad_kernel(
    const TA* __restrict__ a, const TB* __restrict__ bm,
    const float* __restrict__ keep, bool a_prev, bool round_bf16,
    int steps, int batch, int M, int N, int split_rows,
    float* __restrict__ partial) {
  __shared__ __align__(16) float as[kDepth][kTile];
  __shared__ __align__(16) float bs[kDepth][kTile];
  const int dir = blockIdx.z & 1, split = blockIdx.z >> 1;
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
        const int t = k / batch, b = k - t * batch;
        const size_t row = (size_t)t * 2 * batch + (size_t)dir * batch + b;
        if (m0 + j < M && (!a_prev || t > 0)) {
          const size_t arow = a_prev ? row - 2 * (size_t)batch : row;
          av = ld(a, arow * M + m0 + j);
          if (a_prev && keep) av *= keep[(size_t)t * batch + b];
        }
        if (n0 + j < N) bv = ld(bm, row * N + n0 + j);
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
  float* out = partial + ((size_t)split * 2 + dir) * M * N;
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= M) continue;
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 8 + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// out[i] = Σ over splits of partial[split][i], in split order
__global__ void split_sum_kernel(const float* __restrict__ partial,
                                 int splits, size_t count,
                                 float* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int s = 0; s < splits; ++s) v += partial[s * count + i];
    out[i] = v;
  }
}

// Rows per split of a weight-gradient product: enough splits that the
// tiles of both directions fill the card about twice over, and no split
// shorter than 512 rows.
__host__ int wgrad_splits(int rows, int M, int N) {
  const int tiles = 2 * cdiv(M, kTile) * cdiv(N, kTile);
  int splits = cdiv(264, tiles);
  splits = splits < 1 ? 1 : splits;
  const int most = cdiv(rows, 512);
  return splits < most ? splits : (most < 1 ? 1 : most);
}

// Scratch floats K2 needs: the split partials of both products and the
// peephole partials.
__host__ size_t scratch_floats(int steps, int batch, int H, int P) {
  const int rows = steps * batch;
  return (size_t)wgrad_splits(rows, P, 4 * H) * 2 * P * 4 * H
         + (size_t)wgrad_splits(rows, H, P) * 2 * H * P
         + (size_t)cdiv(rows, kPeepRows) * 2 * 3 * H;
}

// partial[chunk][dir][3][H]: the three peephole sums over kPeepRows rows
template <typename S>
__global__ void __launch_bounds__(256) peep_partial_kernel(
    const S* __restrict__ dgates, const S* __restrict__ c_all,
    const float* __restrict__ cnew, const float* __restrict__ keep,
    int steps, int batch, int H, float* __restrict__ partial) {
  const int chunk = blockIdx.x, dir = blockIdx.y, G = 4 * H;
  const int rows = steps * batch;
  const int k0 = chunk * kPeepRows, k1 = min(rows, k0 + kPeepRows);
  for (int u = threadIdx.x; u < H; u += 256) {
    float si = 0.0f, sf = 0.0f, so = 0.0f;
    for (int k = k0; k < k1; ++k) {
      const int t = k / batch, b = k - t * batch;
      const size_t row = (size_t)t * 2 * batch + (size_t)dir * batch + b;
      float c0 = 0.0f;
      if (t > 0) {
        c0 = ld(c_all, (row - 2 * (size_t)batch) * H + u);
        if (keep) c0 *= keep[(size_t)t * batch + b];
      }
      si = fmaf(ld(dgates, row * G + u), c0, si);
      sf = fmaf(ld(dgates, row * G + 2 * H + u), c0, sf);
      so = fmaf(ld(dgates, row * G + 3 * H + u), cnew[row * H + u], so);
    }
    float* out = partial + ((size_t)chunk * 2 + dir) * 3 * H;
    out[u] = si;
    out[H + u] = sf;
    out[2 * H + u] = so;
  }
}

// dpeep[dir][3][H] = Σ over chunks of the partials, in chunk order
__global__ void peep_sum_kernel(const float* __restrict__ partial, int chunks,
                                int H, float* __restrict__ dpeep) {
  const int dir = blockIdx.x;
  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) {
    float v = 0.0f;
    for (int c = 0; c < chunks; ++c) v += partial[((size_t)c * 2 + dir) * 3 * H + i];
    dpeep[(size_t)dir * 3 * H + i] = v;
  }
}

struct Args {
  const void *gx, *lengths, *keep, *c_all, *h_all, *wh, *wht, *projt, *peep;
  float forget_bias;
  const void *dout, *dcfin, *dhfin;
  int steps, batch, units, out_dim;
  void *dgates, *cnew_st, *outb_st, *doutp_st, *dc_in, *dh_in;
  void *dwh, *dproj, *dpeep, *scratch;
  cudaStream_t stream;
};

// out [2, M, N] = the weight-gradient product, split over the rows, the
// partials in `partial`, summed in a fixed order
template <typename TA, typename TB>
cudaError_t wgrad(const Args& a, const TA* x, const TB* y, bool a_prev,
                  bool round_bf16, int M, int N, float* partial, void* out) {
  const int rows = a.steps * a.batch;
  const int splits = wgrad_splits(rows, M, N);
  const int split_rows = cdiv(cdiv(rows, splits), kDepth) * kDepth;
  dim3 grid(cdiv(N, kTile), cdiv(M, kTile), 2 * splits);
  wgrad_kernel<TA, TB><<<grid, 256, 0, a.stream>>>(
      x, y, (const float*)a.keep, a_prev, round_bf16, a.steps, a.batch, M, N,
      split_rows, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t count = (size_t)2 * M * N;
  split_sum_kernel<<<264, 256, 0, a.stream>>>(partial, splits, count,
                                              (float*)out);
  return cudaGetLastError();
}

template <typename T, typename S>
int launch(int device, const Args& a) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int H = a.units, P = a.out_dim;
  if (a.batch <= 0 || a.steps <= 0) return cudaSuccess;
  if (H <= 0 || P <= 0 || H % 4 || P % 4 || (!a.projt && P != H))
    return cudaErrorInvalidValue;
  const Plan pl = plan(H, P);
  const size_t smem = pl.total * sizeof(float);
  if (smem > kMaxSmemPerBlock) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(lstm_bwd_kernel<T, S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(cdiv(a.batch, kRows), 2);
  lstm_bwd_kernel<T, S><<<grid, kThreads, smem, a.stream>>>(
      (const float*)a.gx, (const int*)a.lengths, (const float*)a.keep,
      (const S*)a.c_all, (const S*)a.h_all, (const T*)a.wh, (const T*)a.wht,
      (const T*)a.projt, (const float*)a.peep, a.forget_bias,
      (const float*)a.dout, (const float*)a.dcfin, (const float*)a.dhfin,
      a.steps, a.batch, H, P, (S*)a.dgates, (float*)a.cnew_st,
      (float*)a.outb_st, (float*)a.doutp_st, (float*)a.dc_in, (float*)a.dh_in);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  const int rows = a.steps * a.batch;
  float* wh_partial = (float*)a.scratch;
  float* proj_partial = wh_partial + (size_t)wgrad_splits(rows, P, 4 * H) * 2 * P * 4 * H;
  float* peep_partial = proj_partial + (size_t)wgrad_splits(rows, H, P) * 2 * H * P;
  err = wgrad(a, (const S*)a.h_all, (const S*)a.dgates, true, bf16, P, 4 * H,
              wh_partial, a.dwh);
  if (err != cudaSuccess) return err;
  if (a.projt) {
    err = wgrad(a, (const float*)a.outb_st, (const float*)a.doutp_st, false,
                bf16, H, P, proj_partial, a.dproj);
    if (err != cudaSuccess) return err;
  }
  if (a.peep) {
    const int chunks = cdiv(a.steps * a.batch, kPeepRows);
    peep_partial_kernel<S><<<dim3(chunks, 2), 256, 0, a.stream>>>(
        (const S*)a.dgates, (const S*)a.c_all, (const float*)a.cnew_st,
        (const float*)a.keep, a.steps, a.batch, H, peep_partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    peep_sum_kernel<<<2, 256, 0, a.stream>>>(peep_partial, chunks, H,
                                             (float*)a.dpeep);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

#define LSTM_BWD_ARGS                                                          \
  int device, const void *gx, const void *lengths, const void *keep,          \
      const void *c_all, const void *h_all, const void *wh, const void *wht,  \
      const void *projt, const void *peep, float forget_bias,                 \
      const void *dout, const void *dcfin, const void *dhfin, int steps,      \
      int batch, int units, int out_dim, int store_bf16, void *dgates,        \
      void *cnew_st, void *outb_st, void *doutp_st, void *dc_in, void *dh_in, \
      void *dwh, void *dproj, void *dpeep, void *scratch, void *stream
#define LSTM_BWD_PACK                                                          \
  Args{gx, lengths, keep, c_all, h_all, wh, wht, projt, peep, forget_bias,    \
       dout, dcfin, dhfin, steps, batch, units, out_dim, dgates, cnew_st,     \
       outb_st, doutp_st, dc_in, dh_in, dwh, dproj, dpeep, scratch,           \
       (cudaStream_t)stream}

extern "C" int lstm_bwd_f32(LSTM_BWD_ARGS) {
  return store_bf16 ? launch<float, __nv_bfloat16>(device, LSTM_BWD_PACK)
                    : launch<float, float>(device, LSTM_BWD_PACK);
}

extern "C" int lstm_bwd_bf16(LSTM_BWD_ARGS) {
  return store_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(device, LSTM_BWD_PACK)
                    : launch<__nv_bfloat16, float>(device, LSTM_BWD_PACK);
}

extern "C" long long lstm_bwd_scratch_floats(int steps, int batch, int units,
                                             int out_dim) {
  return (long long)scratch_floats(steps, batch, units, out_dim);
}
