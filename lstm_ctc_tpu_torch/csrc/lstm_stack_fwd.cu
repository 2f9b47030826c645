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
// Design: the wavefront, in chunks.  One 8-block cluster (16, below) per
// (layer, tile of R batch rows) owns that layer's rows for the whole
// sequence, with K1's
// step loop (lstm_cluster.cuh): block q keeps its slices of wh_l and proj_l
// in shared memory for the whole launch.  The sequence is cut into chunks
// of K steps (the lag).  For chunk c a layer l >= 1 first waits until layer
// l-1's blocks of the same rows have counted the chunk's inputs
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
// at L = 4: R = 12, 3 tiles, 12 clusters, one wave).  A stack whose L
// clusters are not all resident at once has no launch: the config export
// says so (rows 0, and the clusters resident), and the route runs such a
// stack layer by layer before any launch.  A fault that stalls a wait
// traps instead of hanging.  The grid puts the lower layers first.
// K = min(8, max(2, ceil(S / 8))): 8 for the training and serving
// sequences (16 and 32 measured slower: PERF.md), 3 for a streaming chunk
// of 16 rows (S = 19 at L = 4).
//
// Wider stacks take 16-block clusters (C = 16, the H100's non-portable
// most), where no 8-block plan fits, as K1 does (lstm_fwd.cu): a block
// owns US = H/16 units, at most 128, so H <= 2048 (Kaldi's LSTMP widths,
// H = 1024 with P = 256: wh's slice [256, 256] is 132 KB with its padding,
// proj's [1024, 16] 32 KB, unpadded as K1's).  The chunk's input stage
// shares the region of the partial sums, which a step uses only after the
// chunk's product is done (16 rows a stage where 32 do not fit).  The
// counters of a row tile are [L, C]: each layer waits for the C blocks of
// the layer below; each hand-off goes to C blocks.  Only 7 sixteen-block
// clusters are resident at once on an H100 SXM, so at L = 4 a wave holds
// one row tile, and a stack of 8 or more such layers has no launch: the
// waves are what a 16-block launch pays for, each the whole sequential
// chain again.  So in bf16 a cluster takes as many rows as shared memory
// holds, R of {4, 8, 16, 32} with the fewest waves, then the smallest (B =
// 32: R = 16 in two waves at 1024/256 and H = P = 384-512 with a
// projection, R = 32 in one at H = P = 512 without; a streaming chunk, B
// = 1: R = 4): a cell-phase thread owns unit tid % US of rows tid / US, +
// 512 / US, .. (cell_rows at most; 64 units a block at most past 8 rows),
// with several rows their carried c in registers (which frees the 512 bytes
// that R = 16 lacks at 1024/256), and the products' A operands are one or
// two whole 16-row tiles on each B
// fragment of the resident slices (mma_product<AROW>: the same k-slices,
// summed in the same order, at any R).  8 blocks stay wherever their plan
// fits, one row a thread: the lstm family's flagship width (H = P = 320)
// is unchanged.  In float32 the slices are read from L2 whatever their
// size, one row a thread.
//
// The streamed plan: a bf16 stack whose slices fit no resident plan (H =
// P = 1024 without a projection: 8 MB of wh a layer; Sak, Senior and
// Beaufays' LSTMP, 2048 cells with a projection of 512: 10.5 MB of wh and
// proj a layer) runs on 16-block clusters whose blocks keep only wh's
// first k-rows in shared memory and stream the rest of wh, and all of
// proj, from L2 at every step through K1's ring of chunks (lstm_cluster.cuh:
// a bulk copy a chunk, completing on its slot's barrier, a slot refilled
// after the block barrier that ends its reads; wh's rows padded by 16
// bytes in global memory as in shared memory, proj's unpadded), as
// lstm_fwd_streamed_kernel does.  The weights do not depend on the step,
// so the next products' first chunks are in flight while a block hands
// off, waits for the layer below and runs a chunk's input product (which
// stays as it is: wx_l's rows from L2).  The products keep the resident
// plan's roles and k-slices (streamed_product: the rows as mma's A, the
// slices added in order onto gx), so a shape that fits both plans gives
// the same bits on both (chip_smoke.py forces this plan at Kaldi's LSTMP
// widths).  Every step of every layer walks the same chunks whether or
// not the layer is live, so every block of a cluster passes the same
// block barriers; the wait on the layer below comes before a chunk's input
// product, outside any pass over the ring.  A step's bytes are the
// streamed part of the slices (~650 KB a block at 2048/512), and every
// cluster streams whole slices whatever its rows, so a wave-step costs
// about the same at any R: the plan takes as many rows a cluster as shared
// memory holds, R of {4, 8, 16, 32} with the fewest waves, then the
// smallest (B = 32: R = 16 at 2048/512, two waves of one row tile; R = 32
// at H = P = 768-1024, one wave; a streaming chunk, B = 1: R = 4).  A
// cell-phase thread owns unit tid % US of rows tid / US, + 512 / US, ..
// (cell_rows at most), its peepholes in registers; past 8 rows the
// products' A operand is one or two whole 16-row tiles, which share each
// chunk's B fragments (streamed_product), so one pass over the ring serves
// 32 rows.  A row's sums do not depend on the rows beside it and the
// dropout is keyed by the global row: every R gives the same bits.
//
// Past 2048 units, the stack is refused.
//
// Operands of every product are rounded to the compute dtype; sums, the
// carries and `out` stay float32; chain, c_all and h_all are written in the
// store dtype (float32 or, with states_bf16, bfloat16) when non-null.

#include "lstm_cluster.cuh"

namespace {

// the gate product's tiles a warp on the streamed plan (4·US <= 512
// columns: 32 tiles over 16 warps) and the projection's (PS <= 256)
constexpr int kGateTiles = 2, kProjTiles = 1;

// A cell-phase thread's rows at most: one; on the bf16 plans of 16 blocks
// cell_rows, at up to 128 units a block on the streamed plan and up to 64
// on the resident one, whose thread keeps each row's next gate inputs (and
// with several rows its carried c) in registers through the step (past 64
// units a block it takes R of 4)
template <typename T, bool kStream>
__host__ __device__ constexpr int row_bound(int rows, int C) {
  return !multi_row<T>(C) ? 1 : cell_rows(rows, kStream ? kLayerUnits : kBlockUnits);
}

template <typename T, int R, int C, bool kStream>
__global__ void __launch_bounds__(kThreads) stack_fwd_kernel(
    const int* __restrict__ seed,       // [1] or null (no dropout)
    const float* __restrict__ gx0,      // [S, B, 4H] layer 0's x·wx0 + b0
    const float* __restrict__ mask,     // [S, L·B]
    const T* __restrict__ wx_rows,      // [L, C, 4, US, P16] (layer 0 unread)
    const T* __restrict__ wh_sl,        // [L, C, P16, 4, US] (streamed: [L, C, P16, LWA])
    const T* __restrict__ proj_sl,      // [L, C, H16, PS] or null (P == H)
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
    int* __restrict__ counters,         // [L, tiles, C], zero at the first wave
    int tile0, int tiles, int lag,
    int cap) {                          // streamed: wh's resident steps at most (-1: as fit)
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int l = blockIdx.y, tile = tile0 + blockIdx.x / C;
  const int b0 = tile * R;
  const int nr = min(R, batch - b0);
  const int H = units, P = out_dim, LB = layers * batch;
  const bool has_proj = proj_sl != nullptr;
  const Plan pl = plan<T>(H, P, has_proj, R, C, kStream, cap);
  const int US = pl.us, PS = pl.ps, G = 4 * US, own = pl.own, prow = pl.prow;
  const int u0 = q * US, nu = max(0, min(US, H - u0));
  const int p0 = q * PS, np = max(0, min(PS, P - p0));
  const int own_n = has_proj ? np : nu, own_0 = has_proj ? p0 : u0;
  const int P16 = round_up(P, 16), H16 = round_up(H, 16), lda_in = P16 + 16 / (int)sizeof(T);
  const int tid = threadIdx.x;
  // the bf16 products' rows of A (pl.arow), and a cell-phase thread's rows
  // at most (one on the 8-block and float32 plans)
  constexpr int kArow = R > 16 ? 32 : R > 8 ? 16 : 8;
  constexpr int kRows = row_bound<T, kStream>(R, C);
  // the carried c in registers (the resident plan of several rows a
  // thread) or in shared memory
  constexpr bool kCRegs = c_in_regs<T>(R, C, kStream);

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* hq = reinterpret_cast<T*>(smem_raw);                    // [arow][QS] h
  T* cellf = reinterpret_cast<T*>(smem_raw + pl.off_cell);   // [arow][HS]
  float* c_own = reinterpret_cast<float*>(smem_raw + pl.off_c);  // [R][US] (!kCRegs)
  float* h_own = reinterpret_cast<float*>(smem_raw + pl.off_h);  // [R][own]
  T* stage = reinterpret_cast<T*>(smem_raw + pl.off_stage);  // [R][US or PS]
  float* part = reinterpret_cast<float*>(smem_raw + pl.off_part);
  T* wh_s = reinterpret_cast<T*>(smem_raw + pl.off_w);       // bf16 slices
  T* pj_s = wh_s + (size_t)P16 * pl.lwa;
  T* ain = reinterpret_cast<T*>(smem_raw + pl.off_part);     // the input stage
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + pl.off_bar);
  const Ring ring{smem_raw + pl.off_ring, full, pl.slots, pl.slot};

  const size_t slot = (size_t)l * C + q;
  const size_t wh_elems = (size_t)P16 * (kStream ? pl.lwa : G);
  const size_t pj_elems = has_proj ? (size_t)H16 * PS : 0;
  const size_t plane = (size_t)steps * batch * P;  // one [S, B, P] chain
  const size_t lrow = (size_t)l * batch + b0;      // the tile's first row in [L·B]
  const T* wx_g = wx_rows + slot * (size_t)P16 * G;
  const T* wh_g = wh_sl + slot * wh_elems;
  const T* pj_g = has_proj ? proj_sl + slot * pj_elems : nullptr;
  const float* prev = l > 0 ? in32 + (size_t)(l - 1) * plane : nullptr;
  float* next = l == layers - 1 ? out : in32 + (size_t)l * plane;
  float* gring = gxl + (size_t)l * lag * batch * 4 * H;
  const bool res = l > 0 && ((residual >> l) & 1);
  const float* pd = peep ? peep + (size_t)l * 3 * H : nullptr;
  const float* aa = aff_a ? aff_a + (size_t)l * P : nullptr;
  const float* ab = aff_b ? aff_b + (size_t)l * P : nullptr;
  const T zero = Dtype<T>::from_float(0.0f);
  const bool drop = seed != nullptr && keep_prob < 1.0f;
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;
  const float inv_keep = 1.0f / keep_prob;
  int* const below = l > 0 ? counters + ((size_t)(l - 1) * tiles + tile) * C : nullptr;
  int* const mine = counters + ((size_t)l * tiles + tile) * C + q;

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
                  : gring + ((size_t)(s - s0) * batch + b0 + r) * 4 * H;
  };

  // the layer's recurrent weights (streamed: wh's resident rows, as they
  // lie in global memory) and its initial states
  if constexpr (kStream) {
    copy_rows(wh_s, pl.lwa, wh_g, pl.lwa, 16 * pl.res);
    if (tid == 0) {
      for (int i = 0; i < pl.slots; ++i) mbar_init(full + i, 1);
      mbar_init_fence();
    }
  } else if constexpr (kMma<T>) {
    copy_rows(wh_s, pl.lwa, wh_g, G, P16);
    if (has_proj) copy_rows(pj_s, pl.lwd, pj_g, PS, H16);
  }
  for (int i = tid; i < pl.arow * pl.qs; i += kThreads) {
    const int r = i / pl.qs, k = i - r * pl.qs;
    hq[i] = Dtype<T>::from_float(r < nr && k < P ? hinit[(lrow + r) * P + k] : 0.0f);
  }
  if (has_proj)
    for (int i = tid; i < pl.arow * pl.hs; i += kThreads) cellf[i] = zero;
  if constexpr (!kCRegs)
    for (int i = tid; i < R * US; i += kThreads) {
      const int r = i / US, j = i - r * US;
      c_own[i] = r < nr && j < nu ? cinit[(lrow + r) * H + u0 + j] : 0.0f;
    }
  for (int i = tid; i < R * own; i += kThreads) {
    const int r = i / own, j = i - r * own;
    h_own[i] = r < nr && j < own_n ? hinit[(lrow + r) * P + own_0 + j] : 0.0f;
  }
  cluster.sync();  // every block's states, weights and barriers are in place

  // the streamed plan's chunks of a step: wh's streamed rows, then proj's
  // (one thread issues each)
  const int per_step = pl.nw + pl.np, total = steps * per_step;
  auto issue = [&](int n) {
    const int i = n % per_step;
    if (i < pl.nw) {
      const int r0 = 16 * (pl.res + i * pl.cw), rows = min(16 * pl.cw, P16 - r0);
      ring.issue(n, wh_g + (size_t)r0 * pl.lwa, sizeof(T) * rows * pl.lwa);
    } else {
      const int r0 = 16 * (i - pl.nw) * pl.cp, rows = min(16 * pl.cp, H16 - r0);
      ring.issue(n, pj_g + (size_t)r0 * PS, sizeof(T) * rows * PS);
    }
  };
  int chunk = 0;  // the next chunk to read
  if constexpr (kStream) {
    if (tid == 0)
      for (int n = 0; n < pl.slots && n < total; ++n) issue(n);
  }

  // phase b: thread tid owns unit jb of rows rb0, rb0 + RS, .. below nr
  // (kRows at most; on the 8-block and float32 plans R <= RS: one row),
  // with kCRegs their carried c in registers
  const int RS = kThreads / US, rb0 = tid / US, jb = tid - rb0 * US;
  const bool in_b = rb0 < RS, own_u = jb < nu;
  const int ub = u0 + jb;
  float c_reg[kRows];
  if constexpr (kCRegs) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int rb = rb0 + i * RS;
      c_reg[i] = in_b && rb < nr && own_u ? cinit[(lrow + rb) * H + ub] : 0.0f;
    }
  }

  int seen = 0;  // thread q < C: the count last read of block q below
  for (int s0 = 0; s0 < steps; s0 += lag) {
    const int s1 = min(steps, s0 + lag);
    // 1. layer l >= 1: the chunk's input product, once layer l-1 has
    // counted the chains it reads (up to step s1 - 2)
    if (l > 0) {
      wait_blocks<C>(below, s1 - 1, seen);
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
            if (j < nu) gring[((size_t)(s - s0) * batch + b0 + r) * 4 * H + k * H + u0 + j] = v;
          },
          pl.srows);
    }
    // resident: each of the thread's rows' gate inputs of the next step,
    // loaded a step ahead
    float gnext[kRows][4] = {};
    if constexpr (!kStream) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int rb = rb0 + i * RS;
        if (in_b && rb < nr && own_u) {
          const float* g = gx_row(s0, s0, rb);
#pragma unroll
          for (int k = 0; k < 4; ++k) gnext[i][k] = g[k * H + ub];
        }
      }
    }

    // 2. the chunk's steps (K1's step loop, with the chain and the layer's
    // rows)
    for (int s = s0; s < s1; ++s) {
      const size_t srow = (size_t)s * LB + lrow;    // rows of [S, L·B, ·]
      const size_t brow = (size_t)s * batch + b0;   // rows of [S, B, ·]

      // a. gate sums for the owned units (streamed: complete, gx added)
      if constexpr (kStream) {
        streamed_product<kGateTiles, kArow>(
            hq, pl.qs, P, G, pl.gates.per, wh_s, pl.lwa, pl.res, ring, pl.lwa, pl.cw, chunk,
            total, issue,
            [&](int r, int c) {
              const int k = c / US, j = c - k * US;
              return r < nr && j < nu ? gx_row(s, s0, r)[k * H + u0 + j] : 0.0f;
            },
            part, G);
      } else if constexpr (kMma<T>) {
        mma_product<kArow>(hq, pl.qs, P, wh_s, pl.lwa, G, pl.gates, part);
      } else {
        fma_product<R>(hq, pl.qs, P, wh_g, G, G, pl.gates, part);
      }
      if (has_proj)
        __syncthreads();
      else
        cluster.sync();  // every block is done reading hq before b rewrites it

      // b. cell update of the owned units, a thread's rows in turn, the
      // unit's peepholes in registers for them
      float pi = 0.0f, pf = 0.0f, po = 0.0f;
      if (pd && in_b && rb0 < nr && own_u) {
        pi = pd[ub];
        pf = pd[H + ub];
        po = pd[2 * H + ub];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int rb = rb0 + i * RS;
        if (!in_b || rb >= nr) break;
        float share = 0.0f;
        if (own_u) {
          float gate[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float v;
            if constexpr (kStream) {
              v = part[(size_t)rb * G + k * US + jb];
            } else {
              v = gnext[i][k];
              for (int sl = 0; sl < pl.gates.slices; ++sl)
                v += part[((size_t)sl * prow + rb) * G + k * US + jb];
            }
            gate[k] = v;
          }
          const int ib = rb * US + jb;
          const float cp = kCRegs ? c_reg[i] : c_own[ib];
          if (pd) {
            gate[0] += pi * cp;
            gate[2] += pf * cp;
          }
          const float cn = sigmoidf(gate[2] + forget_bias) * cp
                           + sigmoidf(gate[0]) * tanhf(gate[1]);
          if (pd) gate[3] += po * cn;
          const float o = sigmoidf(gate[3]) * tanhf(cn);
          const float m = mask[srow + rb];
          const float cv = m * cn + (1.0f - m) * cp;
          if constexpr (kCRegs)
            c_reg[i] = cv;
          else
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
          if (!kStream && s + 1 < s1) {
            const float* g = gx_row(s + 1, s0, rb);
#pragma unroll
            for (int k = 0; k < 4; ++k) gnext[i][k] = g[k * H + ub];
          }
        }
        stage[rb * US + jb] = Dtype<T>::from_float(share);
      }
      __syncthreads();
      if (has_proj)
        share_slice<T, C>(cluster, stage, nr, US, cellf, pl.hs, u0);
      else
        share_slice<T, C>(cluster, stage, nr, US, hq, pl.qs, u0);
      cluster.sync();
      if (!has_proj) continue;

      // d. the owned projection columns (streamed: all of proj, complete)
      if constexpr (kStream)
        streamed_product<kProjTiles, kArow>(cellf, pl.hs, H, PS, pl.proj.per, wh_s, pl.lwa, 0, ring, PS,
                                     pl.cp, chunk, total, issue,
                                     [](int, int) { return 0.0f; }, part, PS);
      else if constexpr (kMma<T>)
        mma_product<kArow>(cellf, pl.hs, H, pj_s, pl.lwd, PS, pl.proj, part);
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
          if constexpr (kStream)
            o = part[(size_t)r * PS + j];
          else
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
      share_slice<T, C>(cluster, stage, nr, PS, hq, pl.qs, p0);
      cluster.sync();
    }
    // 3. the chunk's chains of this block's columns are counted for the
    // layer above
    if (l + 1 < layers) publish(mine, s1);
  }

  // the layer's final states
  if constexpr (kCRegs) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int rb = rb0 + i * RS;
      if (in_b && rb < nr && own_u) cfin[(lrow + rb) * H + ub] = c_reg[i];
    }
  } else {
    for (int i = tid; i < nr * US; i += kThreads) {
      const int r = i / US, j = i - r * US;
      if (j < nu) cfin[(lrow + r) * H + u0 + j] = c_own[i];
    }
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

// How K12 launches: C blocks a cluster, rows a cluster, row tiles, tiles a
// wave, waves, the lag K, dynamic shared memory a block, and the clusters
// resident at once (rows = 0: not with this R, or no R whose L layers are
// resident together); whether on the streamed plan, and a block's weight
// bytes held in shared memory and read from L2 at every step (bf16: the
// streamed plan's streamed part; float32: all its slices).
struct Launch {
  int blocks, rows, tiles, per_wave, waves, lag;
  size_t smem;
  int resident, streamed;
  long long held, streams;
};

__host__ int lag_of(int steps) {
  const int k = cdiv(steps, 8);
  return k < 2 ? 2 : (k > 8 ? 8 : k);
}

// The scratch: the gxl ring [L, K, B, 4H], the chains of layers 0 .. L-2
// [L-1, S, B, P] (float32), the counters [L, tiles, C] (int32), with room
// for the tiles and blocks of any plan a launch of the shape may be forced
// onto (R >= 4, C <= 16).
__host__ size_t scratch_floats(const StackArgs& a, const Launch& how) {
  return (size_t)a.layers * how.lag * a.batch * 4 * a.units
         + (size_t)(a.layers - 1) * a.steps * a.batch * a.out_dim
         + (size_t)a.layers * cdiv(a.batch, 4) * kWideCluster;
}

// Whether a block of R rows of a C-block cluster fits this shape: at most
// kBlockUnits units a block on 8 blocks and kLayerUnits on 16, its
// shared memory (`smem`) within a block's, and its cell phase's rows a
// thread: at most row_bound (one on the 8-block and float32 plans, R·US <=
// kThreads); the streamed plan (bf16, 16 blocks: wh's resident steps at
// most `cap`, -1 as many as fit, kAllHeld all of them or no plan) also
// needs at least two ring slots.  Host arithmetic only.
template <typename T, int R>
__host__ bool fits(int units, int out_dim, bool has_proj, int C, size_t* smem,
                   bool stream = false, int cap = -1) {
  if (stream && (!kMma<T> || C != kWideCluster)) return false;
  const Plan pl = plan<T>(units, out_dim, has_proj, R, C, stream, cap);
  *smem = pl.bytes;
  return pl.us <= (C == kCluster ? kBlockUnits : kLayerUnits) &&
         thread_rows(R, pl.us) <= (stream ? row_bound<T, true>(R, C)
                                          : row_bound<T, false>(R, C)) &&
         pl.bytes <= kMaxSmemPerBlock &&
         (!stream || (pl.slots >= 2 && (cap != kAllHeld || pl.res == pl.wsteps)));
}

template <typename T>
__host__ bool fits_any(int units, int out_dim, bool has_proj, int C) {
  size_t smem;
  return fits<T, 4>(units, out_dim, has_proj, C, &smem) ||
         fits<T, 6>(units, out_dim, has_proj, C, &smem) ||
         fits<T, 8>(units, out_dim, has_proj, C, &smem) ||
         fits<T, 12>(units, out_dim, has_proj, C, &smem);
}

// K12's plans, in the order they are tried: resident on 8 blocks, resident
// on 16, streamed on 16 (bf16 only; R = 4 needs the least of it)
enum Kind { kNone = 0, kResident = 1, kStreamed = 2 };

struct Route {
  Kind kind;
  int blocks;
};

template <typename T>
__host__ Route stack_route(int units, int out_dim, bool has_proj) {
  if (fits_any<T>(units, out_dim, has_proj, kCluster)) return Route{kResident, kCluster};
  if (fits_any<T>(units, out_dim, has_proj, kWideCluster)) return Route{kResident, kWideCluster};
  size_t smem;
  if (fits<T, 4>(units, out_dim, has_proj, kWideCluster, &smem, true))
    return Route{kStreamed, kWideCluster};
  return Route{kNone, 0};
}

template <typename T, int R, int C, bool kStream>
cudaError_t config(const StackArgs& a, int cap, cudaLaunchConfig_t* cfg,
                   cudaLaunchAttribute* attr, Launch* how) {
  how->rows = 0;
  how->resident = 0;
  size_t smem;
  const bool has_proj = a.proj_sl != nullptr;
  if (!fits<T, R>(a.units, a.out_dim, has_proj, C, &smem, kStream, cap)) return cudaSuccess;
  auto kernel = stack_fwd_kernel<T, R, C, kStream>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (C > kCluster) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  const int tiles = cdiv(a.batch, R);
  *cfg = {};
  cfg->gridDim = dim3(C, a.layers, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = a.stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, (const void*)kernel, cfg);
  if (err != cudaSuccess) return err;
  how->resident = fit;
  const int per_wave = min(tiles, fit / a.layers);
  if (per_wave < 1) return cudaSuccess;
  const Plan pl = plan<T>(a.units, a.out_dim, has_proj, R, C, kStream, cap);
  const long long slices = (long long)sizeof(T) *
      ((long long)round_up(a.out_dim, 16) * 4 * pl.us +
       (has_proj ? (long long)round_up(a.units, 16) * pl.ps : 0));
  how->blocks = C;
  how->rows = R;
  how->tiles = tiles;
  how->per_wave = per_wave;
  how->waves = cdiv(tiles, per_wave);
  how->lag = lag_of(a.steps);
  how->smem = smem;
  how->streamed = kStream;
  how->held = kStream ? pl.res_bytes : kMma<T> ? slices : 0;
  how->streams = kStream ? pl.stream_bytes : kMma<T> ? 0 : slices;
  return cudaSuccess;
}

// every wave: all L layers of its row tiles, resident together
template <typename T, int R, int C, bool kStream>
cudaError_t run(const StackArgs& a, int cap, const Launch& how) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch again;
  cudaError_t err = config<T, R, C, kStream>(a, cap, &cfg, attr, &again);
  if (err != cudaSuccess) return err;
  const int H = a.units, P = a.out_dim, L = a.layers;
  float* gxl = (float*)a.scratch;
  float* in32 = gxl + (size_t)L * how.lag * a.batch * 4 * H;
  int* counters = (int*)(in32 + (size_t)(L - 1) * a.steps * a.batch * P);
  err = cudaMemsetAsync(counters, 0, sizeof(int) * L * how.tiles * C, a.stream);
  if (err != cudaSuccess) return err;
  for (int tile0 = 0; tile0 < how.tiles; tile0 += how.per_wave) {
    const int n = min(how.per_wave, how.tiles - tile0);
    cfg.gridDim = dim3(C * n, L, 1);
    err = cudaLaunchKernelEx(
        &cfg, stack_fwd_kernel<T, R, C, kStream>, (const int*)a.seed, (const float*)a.gx0,
        (const float*)a.mask, (const T*)a.wx_rows, (const T*)a.wh_sl,
        (const T*)a.proj_sl, (const float*)a.bias, (const float*)a.peep,
        (const float*)a.cinit, (const float*)a.hinit, (const float*)a.aff_a,
        (const float*)a.aff_b, a.forget_bias, a.keep_prob, a.residual, a.steps,
        a.layers, a.batch, a.units, a.out_dim, (float*)a.out, a.chain, a.c_all,
        a.h_all, a.states_bf16, (float*)a.cfin, (float*)a.hfin, gxl, in32, counters,
        tile0, how.tiles, how.lag, cap);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// The R of {4, 6, 8, 12} (bf16 on 16 blocks, resident or streamed: {4, 8,
// 16, 32}) with the fewest waves, then the smallest; rows = 0 when no R's
// L clusters are resident together (how->resident: the most resident of
// any R).
template <typename T, int C, bool kStream>
cudaError_t choose_rows(const StackArgs& a, Launch* how) {
  *how = Launch{C, 0, 0, 0, 0, 0, 0, 0, kStream, 0, 0};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch c;
  cudaError_t err;
#define TRY(R)                                                          \
  err = config<T, R, C, kStream>(a, -1, &cfg, attr, &c);                \
  if (err != cudaSuccess) return err;                                   \
  if (c.rows && (!how->rows || c.waves < how->waves)) *how = c;         \
  how->resident = max(how->resident, c.resident);
  if constexpr (multi_row<T>(C)) {
    TRY(4) TRY(8) TRY(16) TRY(32)
  } else {
    TRY(4) TRY(6) TRY(8) TRY(12)
  }
#undef TRY
  return cudaSuccess;
}

// The launch plan, or an error: no plan for the shape
// (cudaErrorInvalidConfiguration: past 2048 units, or bf16 slices that fit
// not even the streamed plan).  rows = 0: the plan exists but its L layers
// are not resident together.
template <typename T>
cudaError_t choose(const StackArgs& a, Launch* how) {
  const Route r = stack_route<T>(a.units, a.out_dim, a.proj_sl != nullptr);
  if (r.kind == kStreamed) {
    if constexpr (kMma<T>) return choose_rows<T, kWideCluster, true>(a, how);
  }
  switch (r.kind == kResident ? r.blocks : 0) {
    case kCluster:
      return choose_rows<T, kCluster, false>(a, how);
    case kWideCluster:
      return choose_rows<T, kWideCluster, false>(a, how);
    default:
      *how = Launch{0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
      return cudaErrorInvalidConfiguration;
  }
}

template <typename T, int C, bool kStream>
cudaError_t run_rows(const StackArgs& a, int cap, const Launch& how) {
  if constexpr (multi_row<T>(C)) {
    switch (how.rows) {
      case 4: return run<T, 4, C, kStream>(a, cap, how);
      case 8: return run<T, 8, C, kStream>(a, cap, how);
      case 16: return run<T, 16, C, kStream>(a, cap, how);
      case 32: return run<T, 32, C, kStream>(a, cap, how);
      default: return cudaErrorInvalidConfiguration;
    }
  } else {
    switch (how.rows) {
      case 4: return run<T, 4, C, kStream>(a, cap, how);
      case 6: return run<T, 6, C, kStream>(a, cap, how);
      case 8: return run<T, 8, C, kStream>(a, cap, how);
      case 12: return run<T, 12, C, kStream>(a, cap, how);
      default: return cudaErrorInvalidConfiguration;
    }
  }
}

bool valid(const StackArgs& a) {
  return !(a.units <= 0 || a.out_dim <= 0 || (!a.proj_sl && a.out_dim != a.units) ||
           (a.aff_a == nullptr) != (a.aff_b == nullptr));
}

template <typename T>
int launch(int device, const StackArgs& a) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (a.batch <= 0 || a.steps <= 0 || a.layers <= 0) return cudaSuccess;
  if (!valid(a)) return cudaErrorInvalidValue;
  Launch how;
  err = choose<T>(a, &how);
  if (err != cudaSuccess) return err;
  if (!how.rows) return cudaErrorInvalidConfiguration;  // the layers not resident together
  if (how.streamed) {
    if constexpr (kMma<T>) return run_rows<T, kWideCluster, true>(a, -1, how);
  }
  return how.blocks == kCluster ? run_rows<T, kCluster, false>(a, -1, how)
                                : run_rows<T, kWideCluster, false>(a, -1, how);
}

// A bf16 launch on the plan that `plan` names, at R = `rows`, for holding
// the plans against each other (chip_smoke.py): 1, the resident plan of
// this shape; 2, the streamed plan (16 blocks, which the shape's resident
// plan must have, so the slices are laid out for them) with at most half
// of wh's steps resident, so that the ring streams wh too; 3, the same
// with every step of wh resident (refused where they do not all fit); 4,
// with as many resident as fit.
int forced(int device, const StackArgs& a, int plan, int rows) {
  typedef __nv_bfloat16 T;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (a.batch <= 0 || a.steps <= 0 || a.layers <= 0) return cudaSuccess;
  if (!valid(a)) return cudaErrorInvalidValue;
  const Route r = stack_route<T>(a.units, a.out_dim, a.proj_sl != nullptr);
  if (plan < 1 || plan > 4 || (plan == 1 && r.kind != kResident) ||
      (plan > 1 && r.blocks != kWideCluster))
    return cudaErrorInvalidConfiguration;
  const int cap = plan == 2 ? cdiv(a.out_dim, 16) / 2 : plan == 3 ? kAllHeld : -1;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch how = {};
  switch ((plan > 1) * 1000 + r.blocks * 16 + rows) {
#define CASE(S, C, R)                                                               \
  case S * 1000 + C * 16 + R:                                                       \
    err = config<T, R, C, S == 1>(a, cap, &cfg, attr, &how);                        \
    if (err == cudaSuccess && how.rows) return run<T, R, C, S == 1>(a, cap, how);   \
    break;
    CASE(0, kCluster, 4) CASE(0, kCluster, 6) CASE(0, kCluster, 8) CASE(0, kCluster, 12)
    CASE(0, kWideCluster, 4) CASE(0, kWideCluster, 8) CASE(0, kWideCluster, 16)
    CASE(0, kWideCluster, 32) CASE(1, kWideCluster, 4) CASE(1, kWideCluster, 8)
    CASE(1, kWideCluster, 16) CASE(1, kWideCluster, 32)
#undef CASE
    default: break;
  }
  return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
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

// lstm_stack_fwd_bf16 on a forced plan and R (`plan` 1 resident, 2-4
// streamed with half, all or as much of wh resident as fits; see
// `forced`): the slices laid out for the plan, with lstm_stack_fwd_fits's
// blocks
extern "C" int lstm_stack_fwd_bf16_forced(LSTM_STACK_FWD_ARGS, int plan, int rows) {
  return forced(device, LSTM_STACK_FWD_PACK, plan, rows);
}

// The blocks a cluster of K12's launch plan for this shape (8 or 16;
// negative for the streamed plan, whose wh rows are laid out padded), or 0
// when K12 has none: host arithmetic only, no CUDA call.  The clusters the
// card holds at once, which config also asks, are not counted.
extern "C" int lstm_stack_fwd_fits(int units, int out_dim, int has_proj, int bf16) {
  if (units <= 0 || out_dim <= 0) return 0;
  const bool pj = has_proj != 0;
  const Route r = bf16 ? stack_route<__nv_bfloat16>(units, out_dim, pj)
                       : stack_route<float>(units, out_dim, pj);
  return r.kind == kStreamed ? -r.blocks : r.blocks;
}

// How K12 would launch on `device` at this shape: info = {blocks a
// cluster, rows a cluster, row tiles, tiles a wave, waves, lag K, shared
// memory bytes a block, clusters resident at once, streamed plan or not,
// weight bytes a block holds, weight bytes a block reads from L2 a step},
// and the scratch floats the launch needs; rows = 0 when the card cannot
// hold the stack's L clusters of a row tile together; a CUDA error if the
// shape has no plan.
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
  const long long v[11] = {how.blocks, how.rows, how.tiles, how.per_wave, how.waves,
                           how.lag, (long long)how.smem, how.resident, how.streamed,
                           how.held, how.streams};
  for (int i = 0; i < 11; ++i) info[i] = v[i];
  *scratch = (long long)scratch_floats(a, how);
  return cudaSuccess;
}
