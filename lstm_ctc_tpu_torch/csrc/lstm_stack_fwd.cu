// Kernel K12: a whole unidirectional LSTM stack's forward (the lstm and
// cudnnlstm families), every layer in one launch.
//
// Replaces the TPU kernel lstm_ctc_tpu/ops/lstm_stack_pallas.py
// _make_fwd_kernel (:64-181), launched by pallas_fwd (:430) from
// lstm_stack_fused (:615).  The TPU kernel runs a diagonal wavefront: at step
// s, layer l runs time t = s - l, for S = T + L - 1 steps, and its outputs
// are laid out by s.  This kernel computes the same function with the same
// layout and the same masks: for each layer l and each s in [0, S),
//   in(s)   = layer l-1's chain at s-1 (zero at s = 0 and for layer 0),
//   gates   = (l == 0 ? gx0[s] : in(s)·wx_l + bias_l) + h·wh_l,
//   the TF cell (gate order i, j, f, o; peepholes; sigmoid(f + forget_bias);
//   the projection), masked by m = mask[s, l·B + b] (c and h freeze where
//   m = 0),
//   chain   = m·outp + residual_l·in(s), then the hash dropout at (row
//   s·L·B + l·B + b, column p), then chain·a_l + b_l (eval-mode BN),
// and writes chain, the carried c and h after each step, the last layer's
// chain as `out` (float32), and the final states.  Steps where a layer is
// not live (m = 0 for every row) run like any other, as in the wavefront.
//
// What bounds it on the H100: as for K1, the recurrence is sequential and
// each step's latency counts.  The TPU kernel keeps all L layers' [wx; wh]
// and proj in VMEM (7.4 MB in bf16 at L = 4, H = P = 320); one layer's
// [wx; wh] plus proj is 1.84 MB, 230 KB a block in an 8-block cluster, which
// does not fit one block's 227 KB of shared memory.
//
// Design: the wavefront, in chunks.  One 8-block cluster per (layer, tile
// of R batch rows) owns that layer's rows for the whole sequence, with K1's
// step loop (lstm_cluster.cuh): block q keeps its slices of wh_l and proj_l
// in shared memory for the whole launch.  The sequence is cut into chunks
// of K steps (the lag).  For chunk c a layer l >= 1 first waits until layer
// l-1's eight blocks of the same rows have counted the chunk's inputs
// (their chains up to the chunk's last step but one), then computes the
// chunk's input product in(s)·wx_l + bias_l for its owned units on the
// tensor cores (input_product: the chunk's K·R (step, row) pairs 32 at a
// time, wx_l's rows of the block read from L2 and amortised over them)
// into a float32 ring gxl, runs the chunk's steps with gxl as its gx, and
// counts the chunk's chains (a fence, then an atomic store; the next layer
// reads them from L2).  So layer l runs chunk c while layer l-1 runs chunk
// c+1, and the sequential chain is about S + (L-1)·K steps, where running
// the layers one after another took L·S.  Layer 0's input product gx0 is a
// GEMM outside, as it is outside the TPU kernel; gx0 stays float32 here
// (JAX rounds it to the compute dtype, :670; a bfloat16-only difference,
// ROADMAP queue 3).  A layer's chain goes to a float32 scratch of its own
// (the last layer's is `out`).
//
// Layers wait on the layer below, so all L clusters of a row tile must be
// resident together: the launcher takes R from {4, 6, 8, 12} and as many
// row tiles a launch (a wave) as the occupancy API says are resident for
// all L layers at once; the fewest waves win, then the smallest R (B = 32
// at L = 4: R = 12, 3 tiles, 12 clusters, one wave).  A fault that stalls
// a wait traps instead of hanging.  The grid puts the lower layers first.
// K = min(8, max(2, ceil(S / 8))): 8 for the training and serving
// sequences (16 and 32 measured slower: PERF.md), 3 for a streaming chunk
// of 16 rows (S = 19 at L = 4).
//
// Operands of every product are rounded to the compute dtype; sums, the
// carries and `out` stay float32; chain, c_all and h_all are written in the
// store dtype (float32 or, with states_bf16, bfloat16) when non-null.

#include "lstm_cluster.cuh"

namespace {

// the input rows a block stages for a chunk's product: kStage rows of the
// padded input width
template <typename T>
__host__ __device__ size_t in_stage_bytes(int P) {
  return align128(sizeof(T) * (size_t)kStage * (round_up(P, 16) + 16 / (int)sizeof(T)));
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads) stack_fwd_kernel(
    const int* __restrict__ seed,       // [1] or null (no dropout)
    const float* __restrict__ gx0,      // [S, B, 4H] layer 0's x·wx0 + b0
    const float* __restrict__ mask,     // [S, L·B]
    const T* __restrict__ wx_rows,      // [L, 8, 4, US, P16] (layer 0 unread)
    const T* __restrict__ wh_sl,        // [L, 8, P16, 4, US]
    const T* __restrict__ proj_sl,      // [L, 8, H16, PS] or null (P == H)
    const float* __restrict__ bias,     // [L, 4H] (layer 0 unread)
    const float* __restrict__ peep,     // [L, 3, H] or null
    const float* __restrict__ cinit,    // [L·B, H]
    const float* __restrict__ hinit,    // [L·B, P]
    const float* __restrict__ aff_a,    // [L, P] or null
    const float* __restrict__ aff_b,    // [L, P] or null
    float forget_bias, float keep_prob,
    int residual,                       // bit l: layer l adds its input
    int steps, int layers, int batch, int units, int out_dim,
    float* __restrict__ out,            // [S, B, P]
    void* __restrict__ chain,           // [S, L·B, P] or null
    void* __restrict__ c_all,           // [S, L·B, H] or null
    void* __restrict__ h_all,           // [S, L·B, P] or null
    bool states_bf16,
    float* __restrict__ cfin,           // [L·B, H]
    float* __restrict__ hfin,           // [L·B, P]
    float* __restrict__ gxl,            // scratch [L, K, B, 4H]
    float* __restrict__ in32,           // scratch [L-1, S, B, P]
    int* __restrict__ counters,         // [L, tiles, 8], zero at the first wave
    int tile0, int tiles, int lag) {
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int l = blockIdx.y, tile = tile0 + blockIdx.x / kCluster;
  const int b0 = tile * R;
  const int nr = min(R, batch - b0);
  const int H = units, P = out_dim, LB = layers * batch;
  const bool has_proj = proj_sl != nullptr;
  const Plan pl = plan<T>(H, P, has_proj, R);
  const int US = pl.us, PS = pl.ps, G = 4 * US, own = pl.own, prow = pl.prow;
  const int u0 = q * US, nu = max(0, min(US, H - u0));
  const int p0 = q * PS, np = max(0, min(PS, P - p0));
  const int own_n = has_proj ? np : nu, own_0 = has_proj ? p0 : u0;
  const int P16 = round_up(P, 16), lda_in = P16 + 16 / (int)sizeof(T);
  const int tid = threadIdx.x;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* hq = reinterpret_cast<T*>(smem_raw);                    // [arow][QS] h
  T* cellf = reinterpret_cast<T*>(smem_raw + pl.off_cell);   // [arow][HS]
  float* c_own = reinterpret_cast<float*>(smem_raw + pl.off_c);  // [R][US]
  float* h_own = reinterpret_cast<float*>(smem_raw + pl.off_h);  // [R][own]
  T* stage = reinterpret_cast<T*>(smem_raw + pl.off_stage);  // [R][US or PS]
  float* part = reinterpret_cast<float*>(smem_raw + pl.off_part);
  T* wh_s = reinterpret_cast<T*>(smem_raw + pl.base_bytes);  // bf16 slices
  T* pj_s = wh_s + (size_t)P16 * pl.lwa;
  T* ain = reinterpret_cast<T*>(smem_raw + pl.base_bytes + pl.weight_bytes);

  const size_t slot = (size_t)l * kCluster + q;
  const size_t wh_elems = (size_t)P16 * G;
  const size_t pj_elems = has_proj ? (size_t)round_up(H, 16) * PS : 0;
  const size_t plane = (size_t)steps * batch * P;  // one [S, B, P] chain
  const size_t lrow = (size_t)l * batch + b0;      // the tile's first row in [L·B]
  const T* wx_g = wx_rows + slot * wh_elems;
  const T* wh_g = wh_sl + slot * wh_elems;
  const T* pj_g = has_proj ? proj_sl + slot * pj_elems : nullptr;
  const float* prev = l > 0 ? in32 + (size_t)(l - 1) * plane : nullptr;
  float* next = l == layers - 1 ? out : in32 + (size_t)l * plane;
  float* ring = gxl + (size_t)l * lag * batch * 4 * H;
  const bool res = l > 0 && ((residual >> l) & 1);
  const float* pd = peep ? peep + (size_t)l * 3 * H : nullptr;
  const float* aa = aff_a ? aff_a + (size_t)l * P : nullptr;
  const float* ab = aff_b ? aff_b + (size_t)l * P : nullptr;
  const T zero = Dtype<T>::from_float(0.0f);
  const bool drop = seed != nullptr && keep_prob < 1.0f;
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;
  const float inv_keep = 1.0f / keep_prob;
  int* const below = l > 0 ? counters + ((size_t)(l - 1) * tiles + tile) * kCluster : nullptr;
  int* const mine = counters + ((size_t)l * tiles + tile) * kCluster + q;

  // the finished chain value of (step s, row r, column p)
  auto finish = [&](float v, int s, int r, int p) {
    if (drop)
      v *= drop_factor((uint32_t)((size_t)s * LB + lrow + r), (uint32_t)p, sd,
                       keep_prob, inv_keep);
    if (aa) v = v * aa[p] + ab[p];
    return v;
  };
  // the row of gate inputs of step s (of the current chunk from s0)
  auto gx_row = [&](int s, int s0, int r) -> const float* {
    return l == 0 ? gx0 + ((size_t)s * batch + b0 + r) * 4 * H
                  : ring + ((size_t)(s - s0) * batch + b0 + r) * 4 * H;
  };

  // the layer's recurrent weights and its initial states
  if constexpr (kMma<T>) {
    copy_rows(wh_s, pl.lwa, wh_g, G, P16);
    if (has_proj) copy_rows(pj_s, pl.lwd, pj_g, PS, round_up(H, 16));
  }
  for (int i = tid; i < pl.arow * pl.qs; i += kThreads) {
    const int r = i / pl.qs, k = i - r * pl.qs;
    hq[i] = Dtype<T>::from_float(r < nr && k < P ? hinit[(lrow + r) * P + k] : 0.0f);
  }
  for (int i = tid; i < pl.arow * pl.hs; i += kThreads) cellf[i] = zero;
  for (int i = tid; i < R * US; i += kThreads) {
    const int r = i / US, j = i - r * US;
    c_own[i] = r < nr && j < nu ? cinit[(lrow + r) * H + u0 + j] : 0.0f;
  }
  for (int i = tid; i < R * own; i += kThreads) {
    const int r = i / own, j = i - r * own;
    h_own[i] = r < nr && j < own_n ? hinit[(lrow + r) * P + own_0 + j] : 0.0f;
  }
  cluster.sync();  // every block's states and weights are in place

  // phase b: thread (rb, jb) owns one unit of one row
  const int rb = tid / US, jb = tid - rb * US;
  const bool in_b = tid < R * US && rb < nr;
  const bool own_b = in_b && jb < nu;
  const int ub = u0 + jb;

  int seen = 0;  // thread q < 8: the count last read of block q below
  for (int s0 = 0; s0 < steps; s0 += lag) {
    const int s1 = min(steps, s0 + lag);
    // 1. layer l >= 1: the chunk's input product, once layer l-1 has
    // counted the chains it reads (up to step s1 - 2)
    if (l > 0) {
      wait_blocks(below, s1 - 1, seen);
      input_product<T>(
          (s1 - s0) * nr, P,
          [&](int i, int k, float (&v)[4]) {
            const int s = s0 + i / nr, r = i % nr;
            if (s > 0) {
              row4(prev + ((size_t)(s - 1) * batch + b0 + r) * P, k, P, P % 4 == 0, v);
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c) v[c] = 0.0f;
            }
          },
          ain, lda_in, wx_g, P16, G,
          [&](int c) {
            const int k = c / US, j = c - k * US;
            return j < nu ? bias[(size_t)l * 4 * H + k * H + u0 + j] : 0.0f;
          },
          [&](int i, int c, float v) {
            const int s = s0 + i / nr, r = i % nr, k = c / US, j = c - k * US;
            if (j < nu) ring[((size_t)(s - s0) * batch + b0 + r) * 4 * H + k * H + u0 + j] = v;
          });
    }
    float gnext[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (own_b) {
      const float* g = gx_row(s0, s0, rb);
#pragma unroll
      for (int k = 0; k < 4; ++k) gnext[k] = g[k * H + ub];
    }

    // 2. the chunk's steps (K1's step loop, with the chain and the layer's
    // rows)
    for (int s = s0; s < s1; ++s) {
      const size_t srow = (size_t)s * LB + lrow;    // rows of [S, L·B, ·]
      const size_t brow = (size_t)s * batch + b0;   // rows of [S, B, ·]

      // a. gate sums for the owned units
      if constexpr (kMma<T>)
        mma_product(hq, pl.qs, P, wh_s, pl.lwa, G, pl.gates, part, prow);
      else
        fma_product<R>(hq, pl.qs, P, wh_g, G, G, pl.gates, part);
      if (has_proj)
        __syncthreads();
      else
        cluster.sync();  // every block is done reading hq before b rewrites it

      // b. cell update of the owned units
      if (in_b) {
        float share = 0.0f;
        if (own_b) {
          float gate[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float v = gnext[k];
            for (int sl = 0; sl < pl.gates.slices; ++sl)
              v += part[((size_t)sl * prow + rb) * G + k * US + jb];
            gate[k] = v;
          }
          const int ib = rb * US + jb;
          const float cp = c_own[ib];
          if (pd) {
            gate[0] += pd[ub] * cp;
            gate[2] += pd[H + ub] * cp;
          }
          const float cn = sigmoidf(gate[2] + forget_bias) * cp
                           + sigmoidf(gate[0]) * tanhf(gate[1]);
          if (pd) gate[3] += pd[2 * H + ub] * cn;
          const float o = sigmoidf(gate[3]) * tanhf(cn);
          const float m = mask[srow + rb];
          const float cv = m * cn + (1.0f - m) * cp;
          c_own[ib] = cv;
          if (c_all) put_state(c_all, (srow + rb) * H + ub, cv, states_bf16);
          if (has_proj) {
            share = o;
          } else {
            const float hv = m * o + (1.0f - m) * h_own[ib];
            h_own[ib] = hv;
            if (h_all) put_state(h_all, (srow + rb) * P + ub, hv, states_bf16);
            float ch = m * o;
            if (res && s > 0) ch += __ldcg(prev + (brow - batch + rb) * P + ub);
            ch = finish(ch, s, rb, ub);
            next[(brow + rb) * P + ub] = ch;
            if (chain) put_state(chain, (srow + rb) * P + ub, ch, states_bf16);
            share = hv;
          }
          if (s + 1 < s1) {
            const float* g = gx_row(s + 1, s0, rb);
#pragma unroll
            for (int k = 0; k < 4; ++k) gnext[k] = g[k * H + ub];
          }
        }
        stage[rb * US + jb] = Dtype<T>::from_float(share);
      }
      __syncthreads();
      if (has_proj)
        share_slice(cluster, stage, nr, US, cellf, pl.hs, u0);
      else
        share_slice(cluster, stage, nr, US, hq, pl.qs, u0);
      cluster.sync();
      if (!has_proj) continue;

      // d. the owned projection columns
      if constexpr (kMma<T>)
        mma_product(cellf, pl.hs, H, pj_s, pl.lwd, PS, pl.proj, part, prow);
      else
        fma_product<R>(cellf, pl.hs, H, pj_g, PS, PS, pl.proj, part);
      __syncthreads();

      // e. masking, the chain; share the new h slice
      for (int i = tid; i < nr * PS; i += kThreads) {
        const int r = i / PS, j = i - r * PS;
        float share = 0.0f;
        if (j < np) {
          const int p = p0 + j;
          float o = 0.0f;
          for (int sl = 0; sl < pl.proj.slices; ++sl)
            o += part[((size_t)sl * prow + r) * PS + j];
          const float m = mask[srow + r];
          const float hv = m * o + (1.0f - m) * h_own[i];
          h_own[i] = hv;
          if (h_all) put_state(h_all, (srow + r) * P + p, hv, states_bf16);
          float ch = m * o;
          if (res && s > 0) ch += __ldcg(prev + (brow - batch + r) * P + p);
          ch = finish(ch, s, r, p);
          next[(brow + r) * P + p] = ch;
          if (chain) put_state(chain, (srow + r) * P + p, ch, states_bf16);
          share = hv;
        }
        stage[i] = Dtype<T>::from_float(share);
      }
      __syncthreads();
      share_slice(cluster, stage, nr, PS, hq, pl.qs, p0);
      cluster.sync();
    }
    // 3. the chunk's chains of this block's columns are counted for the
    // layer above
    if (l + 1 < layers) publish(mine, s1);
  }

  // the layer's final states
  for (int i = tid; i < nr * US; i += kThreads) {
    const int r = i / US, j = i - r * US;
    if (j < nu) cfin[(lrow + r) * H + u0 + j] = c_own[i];
  }
  for (int i = tid; i < nr * own; i += kThreads) {
    const int r = i / own, j = i - r * own;
    if (j < own_n) hfin[(lrow + r) * P + own_0 + j] = h_own[i];
  }
}

struct StackArgs {
  const void *seed, *gx0, *mask, *wx_rows, *wh_sl, *proj_sl, *bias, *peep;
  const void *cinit, *hinit, *aff_a, *aff_b;
  float forget_bias, keep_prob;
  int residual, steps, layers, batch, units, out_dim;
  void *out, *chain, *c_all, *h_all;
  bool states_bf16;
  void *cfin, *hfin, *scratch;
  cudaStream_t stream;
};

// How K12 launches: rows a cluster, row tiles, tiles a wave, waves, the
// lag K, dynamic shared memory a block (rows = 0: not with this R).
struct Launch {
  int rows, tiles, per_wave, waves, lag;
  size_t smem;
};

__host__ int lag_of(int steps) {
  const int k = cdiv(steps, 8);
  return k < 2 ? 2 : (k > 8 ? 8 : k);
}

// The scratch: the gxl ring [L, K, B, 4H], the chains of layers 0 .. L-2
// [L-1, S, B, P] (float32), the counters [L, tiles, 8] (int32).
__host__ size_t scratch_floats(const StackArgs& a, const Launch& how) {
  return (size_t)a.layers * how.lag * a.batch * 4 * a.units
         + (size_t)(a.layers - 1) * a.steps * a.batch * a.out_dim
         + (size_t)a.layers * how.tiles * kCluster;
}

// Whether a block of R rows a cluster fits this shape: its slices' threads
// and its shared memory (`smem`) within a block's.  Host arithmetic only.
template <typename T, int R>
__host__ bool fits(int units, int out_dim, bool has_proj, size_t* smem) {
  const Plan pl = plan<T>(units, out_dim, has_proj, R);
  *smem = pl.base_bytes + pl.weight_bytes + in_stage_bytes<T>(out_dim);
  return R * pl.us <= kThreads && *smem <= kMaxSmemPerBlock;
}

template <typename T, int R>
cudaError_t config(const StackArgs& a, cudaLaunchConfig_t* cfg,
                   cudaLaunchAttribute* attr, Launch* how) {
  how->rows = 0;
  size_t smem;
  if (!fits<T, R>(a.units, a.out_dim, a.proj_sl != nullptr, &smem)) return cudaSuccess;
  auto kernel = stack_fwd_kernel<T, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = cdiv(a.batch, R);
  *cfg = {};
  cfg->gridDim = dim3(kCluster, a.layers, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = a.stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, (const void*)kernel, cfg);
  if (err != cudaSuccess) return err;
  const int per_wave = min(tiles, fit / a.layers);
  if (per_wave < 1) return cudaSuccess;
  how->rows = R;
  how->tiles = tiles;
  how->per_wave = per_wave;
  how->waves = cdiv(tiles, per_wave);
  how->lag = lag_of(a.steps);
  how->smem = smem;
  return cudaSuccess;
}

// every wave: all L layers of its row tiles, resident together
template <typename T, int R>
cudaError_t run(const StackArgs& a, const Launch& how) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch again;
  cudaError_t err = config<T, R>(a, &cfg, attr, &again);
  if (err != cudaSuccess) return err;
  const int H = a.units, P = a.out_dim, L = a.layers;
  float* gxl = (float*)a.scratch;
  float* in32 = gxl + (size_t)L * how.lag * a.batch * 4 * H;
  int* counters = (int*)(in32 + (size_t)(L - 1) * a.steps * a.batch * P);
  err = cudaMemsetAsync(counters, 0, sizeof(int) * L * how.tiles * kCluster, a.stream);
  if (err != cudaSuccess) return err;
  for (int tile0 = 0; tile0 < how.tiles; tile0 += how.per_wave) {
    const int n = min(how.per_wave, how.tiles - tile0);
    cfg.gridDim = dim3(kCluster * n, L, 1);
    err = cudaLaunchKernelEx(
        &cfg, stack_fwd_kernel<T, R>, (const int*)a.seed, (const float*)a.gx0,
        (const float*)a.mask, (const T*)a.wx_rows, (const T*)a.wh_sl,
        (const T*)a.proj_sl, (const float*)a.bias, (const float*)a.peep,
        (const float*)a.cinit, (const float*)a.hinit, (const float*)a.aff_a,
        (const float*)a.aff_b, a.forget_bias, a.keep_prob, a.residual, a.steps,
        a.layers, a.batch, a.units, a.out_dim, (float*)a.out, a.chain, a.c_all,
        a.h_all, a.states_bf16, (float*)a.cfin, (float*)a.hfin, gxl, in32, counters,
        tile0, how.tiles, how.lag);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// The R of {4, 6, 8, 12} with the fewest waves, then the smallest; no R:
// the launch is refused (bf16 slices wider than shared memory, as K1's).
template <typename T>
cudaError_t choose(const StackArgs& a, Launch* how) {
  how->rows = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch c;
  cudaError_t err;
#define TRY(R)                                                          \
  err = config<T, R>(a, &cfg, attr, &c);                                \
  if (err != cudaSuccess) return err;                                   \
  if (c.rows && (!how->rows || c.waves < how->waves)) *how = c;
  TRY(4) TRY(6) TRY(8) TRY(12)
#undef TRY
  return how->rows ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename T>
int launch(int device, const StackArgs& a) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (a.batch <= 0 || a.steps <= 0 || a.layers <= 0) return cudaSuccess;
  if (a.units <= 0 || a.out_dim <= 0 || (!a.proj_sl && a.out_dim != a.units) ||
      (a.aff_a == nullptr) != (a.aff_b == nullptr))
    return cudaErrorInvalidValue;
  Launch how;
  err = choose<T>(a, &how);
  if (err != cudaSuccess) return err;
  switch (how.rows) {
    case 4: return run<T, 4>(a, how);
    case 6: return run<T, 6>(a, how);
    case 8: return run<T, 8>(a, how);
    default: return run<T, 12>(a, how);
  }
}

}  // namespace

#define LSTM_STACK_FWD_ARGS                                                    \
  int device, const void *seed, const void *gx0, const void *mask,            \
      const void *wx_rows, const void *wh_sl, const void *proj_sl,            \
      const void *bias, const void *peep, const void *cinit,                  \
      const void *hinit, const void *aff_a, const void *aff_b,                \
      float forget_bias, float keep_prob, int residual, int steps,            \
      int layers, int batch, int units, int out_dim, void *out, void *chain,  \
      void *c_all, void *h_all, int states_bf16, void *cfin, void *hfin,      \
      void *scratch, void *stream
#define LSTM_STACK_FWD_PACK                                                    \
  StackArgs{seed, gx0, mask, wx_rows, wh_sl, proj_sl, bias, peep, cinit,      \
            hinit, aff_a, aff_b, forget_bias, keep_prob, residual, steps,     \
            layers, batch, units, out_dim, out, chain, c_all, h_all,          \
            states_bf16 != 0, cfin, hfin, scratch, (cudaStream_t)stream}

extern "C" int lstm_stack_fwd_f32(LSTM_STACK_FWD_ARGS) {
  return launch<float>(device, LSTM_STACK_FWD_PACK);
}

extern "C" int lstm_stack_fwd_bf16(LSTM_STACK_FWD_ARGS) {
  return launch<__nv_bfloat16>(device, LSTM_STACK_FWD_PACK);
}

// Whether K12 has a launch plan for this shape (1) or not (0): some R of
// choose's whose block fits, host arithmetic only, no CUDA call.  The
// clusters the card holds at once, which config also asks, are not counted.
extern "C" int lstm_stack_fwd_fits(int units, int out_dim, int has_proj, int bf16) {
  if (units <= 0 || out_dim <= 0) return 0;
  size_t smem;
  const bool pj = has_proj != 0;
#define FITS(T)                                                         \
  (fits<T, 4>(units, out_dim, pj, &smem) || fits<T, 6>(units, out_dim, pj, &smem) || \
   fits<T, 8>(units, out_dim, pj, &smem) || fits<T, 12>(units, out_dim, pj, &smem))
  return bf16 ? FITS(__nv_bfloat16) : FITS(float);
#undef FITS
}

// How K12 would launch on `device` at this shape: info = {rows a cluster,
// row tiles, tiles a wave, waves, lag K, shared memory bytes a block}, and
// the scratch floats the launch needs; a CUDA error if it cannot.
extern "C" int lstm_stack_fwd_config(int device, int steps, int layers, int batch,
                                     int units, int out_dim, int has_proj, int bf16,
                                     long long* info, long long* scratch) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  StackArgs a = {};
  a.steps = steps;
  a.layers = layers;
  a.batch = batch;
  a.units = units;
  a.out_dim = out_dim;
  a.proj_sl = has_proj ? (const void*)1 : nullptr;
  Launch how = {};
  err = bf16 ? choose<__nv_bfloat16>(a, &how) : choose<float>(a, &how);
  if (err != cudaSuccess) return err;
  const long long v[6] = {how.rows, how.tiles, how.per_wave, how.waves, how.lag,
                          (long long)how.smem};
  for (int i = 0; i < 6; ++i) info[i] = v[i];
  *scratch = (long long)scratch_floats(a, how);
  return cudaSuccess;
}
