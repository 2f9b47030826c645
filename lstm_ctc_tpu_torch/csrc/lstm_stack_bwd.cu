// Kernel K13: the backward of a whole unidirectional LSTM stack (K12), with
// the weight gradients.
//
// Replaces the TPU kernel lstm_ctc_tpu/ops/lstm_stack_pallas.py
// _make_bwd_kernel (:184-388), launched by pallas_bwd (:458) from the VJP
// fused_bwd (:545-580).  The TPU kernel walks the wavefront in reverse with
// remat: at step s it recomputes every layer's gates from the stored
// (c_prev, h_prev, in_prev) and carries (dc, dh) back.  This kernel computes
// the same function, each layer over s = S-1 .. 0 with the carries (dc, dh)
// starting from (dcfin, dhfin):
//   dchain  = din of layer l+1 at s+1 (+ dout[s] on the last layer), times
//             the forward's hash dropout factor at (s·L·B + l·B + b, p),
//   dout_p  = m·(dchain + dh),  dout_blk = dout_p·projᵀ,
//   do, dc_new (+ the o-peephole term), df, di, dj   (TF gate order),
//   dc_prev = dc_new·sf + (1-m)·dc (+ the f and i peephole terms),
//   din     = residual_l·dchain + dgates·wx_lᵀ   (layer l's input cotangent),
//   dh_prev = (1-m)·dh + dgates·wh_lᵀ.
// c_prev and h_prev are the stored states of step s-1 (cinit and hinit,
// rounded to the store dtype, at s = 0), in_prev the stored chain of layer
// l-1 at s-1 (zero for layer 0, whose input product gx0 is outside).  dgates
// of every layer is emitted in the store dtype (layer 0's rows are dgx0, for
// the input projection's backward outside, as XLA does it outside the TPU
// kernel), with the stashes of the dproj product, out_blk and dout_p, in the
// compute dtype.  After the recurrence lstm_bwd_wgrad.cu's products give
// dwz[l] = Σ [in_prev, h_prev]ᵀ·dgates and dproj[l] = Σ out_blkᵀ·dout_p (on
// the tensor cores in bf16), and dbias[l] = Σ dgates and the peephole sums
// Σ dg_i·c_prev, Σ dg_f·c_prev, Σ dg_o·c_new (over dgates as stored) are
// kept by the recurrence in registers and written per row tile; split
// partials are added in a fixed order, no atomics.  Operands of every
// product are rounded to the compute dtype; sums, the carries and every
// output but dgates and the stashes stay float32, and the float32 path uses
// FMA only, never TF32.
//
// What bounds it on the H100: the reverse recurrence is sequential, so each
// step's latency counts.  A layer's [wx; wh] plus proj is 1.84 MB in bf16 at
// H = P = 320, 230 KB a block over 8: more than a block's shared memory.
//
// Design: K2's (lstm_bwd.cu), a cluster per layer and row tile, with the
// input side taken off the recurrence.  One 8-block cluster (16, below)
// per (layer l, tile of R batch rows); block q owns hidden units [q·US,
// (q+1)·US) and
// keeps its slice of wh_l and its rows of proj_l in shared memory for the
// whole sequence (~139 KB at H = P = 320).
//   0. Before the recurrence one tensor-core product gives the input half
//      of every layer's gate recompute, in_prev(s)·wx_l for l >= 1 and
//      every s (the forward's chain is known), into a float32 scratch gxl
//      (lstm_bwd_wgrad.cu's lstm_stack_gate_inputs; bias_l is added as the
//      step reads it).
//   1. The recurrence is K2's step loop: dout_p over the full P from the
//      block's full dh and the staged dchain; dout_blk of the owned units;
//      their cell
//      backward; the block's partial dh_prev = dgates_q·wh_qᵀ scattered over
//      distributed shared memory to the owner of each P-slice, which adds the
//      C partials in block order and all-gathers the new dh (two cluster
//      barriers a step).  The gate recompute of the step before runs between the
//      halves of the first barrier, and that step's loads are staged by
//      cp.async a step ahead.  In bf16 the products run on the tensor cores
//      with float32 adds of each 16-deep step (mma_product_f32add).
//   2. Every K steps (the lag) a layer l >= 1 adds dgates·wx_lᵀ of those
//      steps to din (which step 1 has set to residual_l·dchain): each block
//      its P-slice, its rows of dgates (a compute-dtype ring, written by all
//      the cluster's blocks) and wx_l read from L2 straight into tensor-core
//      fragments; then each block counts the steps whose din it has
//      finished (a fence, then an atomic store).
// So the layers run as a pipeline, as the reverse wavefront does: layer l-1
// stages dchain of step s (layer l's din at s+1) from L2 once layer l's C
// blocks have counted it, and lags layer l by about K steps; the sequential
// chain is about S + (L-1)·K steps.  A layer waits only on the layer above,
// and all L clusters of a row tile must be resident together: the launcher
// takes R from {4, 6, 8} and as many row tiles a launch (a wave) as the
// occupancy API says are resident for all L layers at once, the fewest
// waves first, then the smallest R (B = 32, L = 4: R = 6, three tiles a
// wave, two waves); a stack whose L clusters are not resident together has
// no launch (the route runs it layer by layer, as K12's); a wait of seconds
// traps rather than hang.  K = max(2, min(8, ceil(S / 16))).  In float32
// the products are FMA and the slices are read from L2.
//
// Where no 8-block plan fits (bf16 slices past shared memory, from H = P =
// 324 with a projection; any stack past 512 units) the cluster has 16
// blocks, as K2's: a block owns at most 64 units, so H <= 1024 (128 past
// that, below), and keeps its wh slice [P, 4·US] and proj rows [US, P]
// (~165 KB at H = 1024, P = 256), and each layer waits for the 16 blocks
// of the layer above.  Only 7 sixteen-block clusters are resident at once
// on an H100 SXM: at L = 4 a wave holds one row tile, and each wave pays
// the whole sequential chain again, so a cluster takes as many rows as
// shared memory holds.  In bf16 it runs the streamed plan's kernel (below)
// with every weight held and no ring: a block keeps only its own slices of
// the R rows' buffers, a cell-phase thread owns several rows, the
// products' A operands are a whole 16-row tile past 8 rows, and its pass
// over wh runs a warp's dh_prev half-tiles first, then its gate tiles in
// one tight loop (the ring's order, step by step, left the held pass
// waiting on each step's loads and products: 1.1-1.2x slower).  So R of
// {4, 8, 16}, then 2, with the fewest
// waves (B = 32: R = 8 in 4 waves at 1024/256
// and H = P = 448-512 with a projection, R = 16 in 2 at H = P = 384 and at
// 512 without one; a streaming chunk R = 4).  In float32 (slices read
// from L2) the buffers are the full-width ones of the 8-block plan: dh is
// reduced over 16 blocks' partials in block order and all-gathered to 16,
// the A operands hold R rows, one row a cell-phase thread, R of {4, 6,
// 8}, then 2.
//
// The streamed plan (bf16 slices past every resident plan, up to 2048
// units, 128 a block: stack_bwd_streamed_kernel) streams wh, and proj's
// rows, from L2 at every step as K2's streamed plan does
// (lstm_bwd_streamed.cu): dout_blk over proj's chunks (bwd_dob_pass), and
// one pass over wh's rows serving dh_prev and the step before's gate sums
// (lstm_cluster.cuh bwd_wh_pass, K2's, with 16-row A operands).
// Every cluster streams
// whole slices whatever its rows, so it takes as many rows as shared
// memory holds: R of {4, 8, 16}, then 2, the fewest waves first, then the
// smallest (B = 32: R = 16, two waves, at 2048/512 and H = P = 768-1024; a
// streaming chunk R = 4).  To hold 16 rows beside the ring a block keeps
// only what it owns: the carry dh and dchain of its own P-slice (without a
// projection its P-slice is its units), the gate inputs read from L2 as a
// pass starts, h_prev copied straight into the A operand where the store
// dtype is bf16.  The pass over wh writes each 16-column tile of the
// block's dh partial straight into the inboxes of its owners; after the
// cluster barrier each owner adds the C partials in block order, updates
// its slice and writes the next step's dout_p of it, rounded, into every
// block (the A operand of dout_blk), and a second cluster barrier ends the
// inboxes' reads and makes dout_p whole.  A cell-phase thread owns unit
// tid % US of rows tid / US, + 512 / US, .. (the unit's constants in
// registers; its column sums add its rows in row order, then the threads'
// sums are added in row order); past 8 rows the products' A operands are
// a whole 16-row tile.  Each row's arithmetic is the same at any R, so
// dgates, din and the carries are bit-equal across R.

#include <type_traits>

#include "lstm_cluster.cuh"
#include "lstm_bwd_entry.cuh"

namespace {

template <typename X>
__device__ __forceinline__ float rnd(float v) {
  return Dtype<X>::to_float(Dtype<X>::from_float(v));
}

// Shared-memory plan, common to host and device: K2's (lstm_bwd.cu
// bwd_plan, with C blocks a cluster), with each row's mask in place of K2's
// keep and length, room for the seven column sums of a row tile, and
// (float32, whose slices stay in L2) the rows of din's product staged where
// bf16 keeps its slices: `staged` floats, kStage rows of the padded P, or
// where those do not fit (H = P = 2048) the rows the product stages at once
// (8·kThreads/PS rows of kDinPiece).  The streamed plan (bf16, `stream`):
// the A operands of arow rows (8, or 16 past 8 rows), the buffers of the
// block's own slices (listed below), gsum [R][G] (the gate sums of the step
// before), one region of dout_blk's partial sums (the column sums at the
// end), the ring's barriers and slots, then wh's first `res` 16-deep steps
// (at most `cap` where cap >= 0) at row stride LWH, as the wrapper lays
// every row out in global memory (proj's rows too, at LPJ); wsteps,
// gsteps: 16-deep steps of P and of G; utiles: proj's 16-row tiles; cw,
// cu: steps of wh and tiles of proj a chunk; nw, np: chunks a pass;
// res_bytes, stream_bytes: a block's weight bytes held, and streamed a
// step.  With `held` (bf16 on 16 blocks, resident) the same buffers, no
// ring, every step of wh at off_wh and all of proj's rows at off_pj, at
// the same strides.
constexpr int kDinPiece = 64;  // float32 din product: the depth staged at once

struct StackPlan {
  int us, u16, g, ps, pw, p16, nd, wrows, arow, prow, lda, ldg, lwh, lpj, lin, staged;
  Split gates, dob, dh;
  size_t off_dq, off_gq, off_dh, off_dnx, off_dnx2, off_hraw, off_craw, off_gxs,
      off_rows, off_dc, off_inbox, off_gsum, off_part, off_bar, off_ring, off_wh, off_pj,
      bytes, slot;
  int wsteps, gsteps, utiles, res, cw, cu, nw, np, slots;
  long long res_bytes, stream_bytes;
};

template <typename T, typename S>
__host__ __device__ StackPlan stack_plan(int H, int P, bool has_proj, int R, int C,
                                         bool stream = false, int cap = -1,
                                         bool held = false) {
  StackPlan p = {};
  stream = stream || held;
  p.us = round_up(cdiv(H, C), 8);
  p.u16 = round_up(p.us, 16);
  p.g = 4 * p.us;
  // streamed without a projection: a block's P-slice is its units, whose
  // dout_p its cell phase reads
  p.ps = stream && !has_proj ? p.us : round_up(cdiv(P, C), 4);
  p.pw = C * p.ps;
  p.p16 = round_up(P, 16);
  p.nd = kMma<T> ? p.u16 : p.us;
  p.wrows = p.p16 > p.pw ? p.p16 : p.pw;
  const int pad = 16 / (int)sizeof(T);
  p.arow = kMma<T> ? (stream && R > 8 ? 16 : 8) : R;
  p.prow = p.arow;
  p.lda = p.p16 + pad;
  p.ldg = p.g + pad;
  p.lwh = p.g + pad;
  p.lpj = p.p16 + pad;
  p.lin = p.p16 + pad;
  if constexpr (kMma<T>) {
    p.gates = mma_split(p.g, p.p16, 2);
    p.dob = mma_split(p.nd, p.p16);
    p.dh = mma_split(p.pw, p.g, 2);
  } else {
    p.gates = fma_split(p.g, p.p16);
    p.dob = fma_split(p.nd, p.p16);
    p.dh = fma_split(p.pw, p.g);
  }
  const size_t part_g = (size_t)p.gates.slices * p.prow * p.g;
  const size_t part_d = has_proj ? (size_t)p.dob.slices * p.prow * p.nd : 0;
  if (stream) {
    // hq; dq (with a projection); gq; the carry's own slice dh [R][PS];
    // dchain's own slice [2][R][PS] and c_prev [2][R][US] by step parity;
    // h_prev staged [R][P] where the store dtype is not the compute dtype;
    // the masks; dc; the inboxes; gsum; dout_blk's slices, and at the end
    // the column sums [7][kThreads / US][US]
    const size_t sums = (size_t)7 * (kThreads / p.us) * p.us;
    const size_t part = part_d > sums ? part_d : sums;
    const size_t aq = align128(sizeof(T) * (size_t)p.arow * p.lda);
    p.off_dq = aq;
    p.off_gq = p.off_dq + (has_proj ? aq : 0);
    p.off_dh = p.off_gq + align128(sizeof(T) * (size_t)p.arow * p.ldg);
    p.off_dnx = p.off_dh + align128(sizeof(float) * (size_t)R * p.ps);
    p.off_hraw = p.off_dnx + align128(sizeof(float) * 2 * (size_t)R * p.ps);
    p.off_craw = p.off_hraw +
        (std::is_same<S, T>::value ? 0 : align128(sizeof(S) * (size_t)R * P));
    p.off_rows = p.off_craw + align128(sizeof(S) * 2 * (size_t)R * p.us);
    p.off_dc = p.off_rows + align128(sizeof(float) * 2 * (size_t)R);
    p.off_inbox = p.off_dc + align128(sizeof(float) * (size_t)R * p.us);
    p.off_gsum = p.off_inbox + align128(sizeof(float) * (size_t)C * R * p.ps);
    p.off_part = p.off_gsum + align128(sizeof(float) * (size_t)R * p.g);
    p.off_wh = p.off_part + align128(sizeof(float) * part);
    p.wsteps = p.p16 / 16;
    p.gsteps = p.g / 16;
    p.utiles = has_proj ? p.u16 / 16 : 0;
    if (held) {
      const size_t wh = sizeof(T) * (size_t)p.p16 * p.lwh;
      const size_t pj = has_proj ? sizeof(T) * (size_t)p.u16 * p.lpj : 0;
      p.off_bar = p.off_ring = p.off_wh;
      p.off_pj = p.off_wh + align128(wh);
      p.bytes = p.off_pj + align128(pj);
      p.res = p.wsteps;
      p.res_bytes = (long long)(p.wsteps * 16 * p.g + (has_proj ? p.utiles * 16 * p.p16 : 0)) *
                    (long long)sizeof(T);
      return p;
    }
    const size_t wrow = sizeof(T) * 16 * (size_t)p.lwh, urow = sizeof(T) * 16 * (size_t)p.lpj;
    p.cw = kChunkBytes / wrow > 1 ? (int)(kChunkBytes / wrow) : 1;
    p.cu = !has_proj ? 0 : kChunkBytes / urow > 1 ? (int)(kChunkBytes / urow) : 1;
    p.slot = align128(p.cw * wrow > p.cu * urow ? p.cw * wrow : p.cu * urow);
    p.off_bar = p.off_wh;
    p.off_ring = p.off_bar + 128;
    const size_t left = kMaxSmemPerBlock > p.off_ring ? kMaxSmemPerBlock - p.off_ring : 0;
    p.slots = left / p.slot < (size_t)kMaxSlots ? (int)(left / p.slot) : kMaxSlots;
    p.off_wh = p.off_ring + p.slots * p.slot;
    const int fit = (int)((left - p.slots * p.slot) / wrow);
    p.res = fit < p.wsteps ? fit : p.wsteps;
    if (cap >= 0 && cap < p.res) p.res = cap;
    p.nw = cdiv(p.wsteps - p.res, p.cw);
    p.np = has_proj ? cdiv(p.utiles, p.cu) : 0;
    p.bytes = p.off_wh + p.res * wrow;
    p.res_bytes = (long long)p.res * 16 * p.g * sizeof(T);
    p.stream_bytes = (long long)(p.wsteps - p.res) * 16 * p.g * sizeof(T) +
                     (long long)p.utiles * 16 * p.p16 * sizeof(T);
    return p;
  }
  const size_t part_h = (size_t)p.dh.slices * p.prow * p.pw;
  const size_t sums = (size_t)7 * R * p.us;
  size_t part = part_g + part_d > part_h ? part_g + part_d : part_h;
  part = part > sums ? part : sums;
  p.off_dq = align128(sizeof(T) * (size_t)p.arow * p.lda);
  p.off_gq = p.off_dq + align128(sizeof(T) * (size_t)p.arow * p.lda);
  p.off_dh = p.off_gq + align128(sizeof(T) * (size_t)p.arow * p.ldg);
  p.off_dnx = p.off_dh + align128(sizeof(float) * (size_t)R * p.pw);
  p.off_dnx2 = p.off_dnx + align128(sizeof(float) * (size_t)R * p.pw);
  p.off_hraw = p.off_dnx2 + align128(sizeof(float) * (size_t)R * p.pw);
  p.off_craw = p.off_hraw + align128(sizeof(S) * (size_t)R * P);
  p.off_gxs = p.off_craw + align128(sizeof(S) * (size_t)R * p.us);
  p.off_rows = p.off_gxs + align128(sizeof(float) * (size_t)R * 4 * p.us);
  p.off_dc = p.off_rows + align128(sizeof(float) * 2 * (size_t)R);
  p.off_inbox = p.off_dc + align128(sizeof(float) * (size_t)R * p.us);
  p.off_part = p.off_inbox + align128(sizeof(float) * (size_t)C * R * p.ps);
  p.off_wh = p.off_part + align128(sizeof(float) * part);
  p.off_pj = p.off_wh + (kMma<T> ? align128(sizeof(T) * (size_t)p.wrows * p.lwh) : 0);
  const size_t end = p.off_pj + (kMma<T> && has_proj ? align128(sizeof(T) * (size_t)p.u16 * p.lpj) : 0);
  p.staged = kStage * p.lin;
  size_t staged = p.off_wh + align128(sizeof(T) * (size_t)p.staged);
  if (!kMma<T> && staged > kMaxSmemPerBlock) {
    const int rows = 8 * (kThreads / p.ps);
    if (rows * kDinPiece < p.staged) p.staged = rows * kDinPiece;
    staged = p.off_wh + align128(sizeof(T) * (size_t)p.staged);
  }
  p.bytes = end > staged ? end : staged;
  return p;
}

// din of this block's P-slice (columns p0 .. p0 + np) += dgates·wx_lᵀ over
// steps t0 .. t0+cnt-1 of the row tile's nr rows from b0: dgates from the
// compute-dtype ring (ring_row(s, r)), wx_l [P, 4H] from L2; float32 stages
// the rows in `in_s` (`staged` floats)
template <typename T, typename RingRow>
__device__ __forceinline__ void din_steps(int t0, int cnt, int nr, int np, int p0, int H4,
                                          const T* __restrict__ wx_l, RingRow ring_row,
                                          float* __restrict__ din_l, int batch, int b0, int P,
                                          T* in_s, int staged) {
  const int tid = threadIdx.x;
  const int rows = cnt * nr;
  if constexpr (kMma<T>) {
    // a warp a 16-row, 8-column tile; dgates rows and wx_l rows loaded
    // from L2 straight into fragments, 16 bytes a lane (frag_step)
    const int lane = tid & 31, g4 = lane >> 2, t4 = lane & 3;
    const int ntn = cdiv(np, 8);
    for (int task = tid / 32; task < cdiv(rows, 16) * ntn; task += kWarps) {
      const int mt = task / ntn, nt = task - mt * ntn;
      const T* pa[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = mt * 16 + g4 + 8 * h;
        pa[h] = i < rows ? ring_row(t0 + i / nr, i % nr) + 8 * t4 : nullptr;
      }
      const int n = nt * 8 + g4;
      const T* pb = n < np ? wx_l + (size_t)(p0 + n) * H4 + 8 * t4 : nullptr;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      // kBatch 32-deep steps at a time, their loads issued together
      // before the products (the mma asm keeps program order)
      constexpr int kBatch = 4;
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      for (int k0 = 0; k0 < H4; k0 += 32 * kBatch) {
        uint4 qa[kBatch][2], qb[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int k = k0 + 32 * u;
          const bool in = k + 8 * t4 + 8 <= H4;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            qa[u][h] = in && pa[h] ? __ldcg(reinterpret_cast<const uint4*>(pa[h] + k)) : z;
          qb[u] = in && pb ? __ldg(reinterpret_cast<const uint4*>(pb + k)) : z;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (k0 + 32 * u < H4) frag_step(d, qa[u][0], qa[u][1], qb[u]);
      }
      // lane holds rows g4 and g4 + 8, columns 2·t4 and + 1
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = mt * 16 + g4 + 8 * (e >> 1), c = nt * 8 + 2 * t4 + (e & 1);
        if (i < rows && c < np) {
          const int s = t0 + i / nr, r = i % nr;
          din_l[((size_t)s * batch + b0 + r) * P + p0 + c] += d[e];
        }
      }
    }
  } else {
    // float32: the rows staged in shared memory (where bf16 keeps its
    // weight slices) 64 deep at a time; a thread owns a column and 8 rows,
    // wx_l's row read from L2 once for the 8
    constexpr int kPiece = kDinPiece;
    float* as = reinterpret_cast<float*>(in_s);
    const int most = min(8 * (kThreads / max(np, 1)), staged / kPiece / 8 * 8);
    for (int i0 = 0; i0 < rows; i0 += most) {
      const int nrow = min(most, rows - i0), groups = cdiv(nrow, 8);
      const bool active = tid < np * groups;
      const int c = active ? tid % np : 0, rg = active ? tid / np : 0;
      const float* w = reinterpret_cast<const float*>(wx_l) + (size_t)(p0 + c) * H4;
      float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int k0 = 0; k0 < H4; k0 += kPiece) {
        const int kq = min(kPiece, H4 - k0) / 4;
        __syncthreads();  // the piece before is consumed
        for (int e = tid; e < nrow * kq; e += kThreads) {
          const int i = e / kq, k = 4 * (e - i * kq), s = t0 + (i0 + i) / nr;
          const float* a = reinterpret_cast<const float*>(ring_row(s, (i0 + i) % nr));
          *reinterpret_cast<float4*>(as + i * kPiece + k) =
              __ldcg(reinterpret_cast<const float4*>(a + k0 + k));
        }
        __syncthreads();
        if (active) {
#pragma unroll 4
          for (int k = 0; k < 4 * kq; k += 4) {
            const float4 y = __ldg(reinterpret_cast<const float4*>(w + k0 + k));
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const float4 x = *reinterpret_cast<const float4*>(as + (rg * 8 + r) * kPiece + k);
              acc[r] = fmaf(x.x, y.x, acc[r]);
              acc[r] = fmaf(x.y, y.y, acc[r]);
              acc[r] = fmaf(x.z, y.z, acc[r]);
              acc[r] = fmaf(x.w, y.w, acc[r]);
            }
          }
        }
      }
      if (active)
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i0 + rg * 8 + r;
          if (rg * 8 + r < nrow) {
            const int s = t0 + i / nr;
            din_l[((size_t)s * batch + b0 + i % nr) * P + p0 + c] += acc[r];
          }
        }
    }
  }
}

// The resident plans.  T: the compute dtype (bf16: the products on the
// tensor cores, the slices in shared memory; float32: FMA, the slices read
// from L2); S: the store dtype
template <typename T, typename S, int R, int C>
__global__ void __launch_bounds__(kThreads, 1) stack_bwd_kernel(
    const int* __restrict__ seed,     // [1] or null (no dropout)
    const float* __restrict__ gx0,    // [S, B, 4H]
    const float* __restrict__ mask,   // [S, L·B]
    const S* __restrict__ chain,      // [S, L·B, P] store dtype
    const S* __restrict__ c_all,      // [S, L·B, H] store dtype
    const S* __restrict__ h_all,      // [S, L·B, P] store dtype
    const float* __restrict__ cinit,  // [L·B, H]
    const float* __restrict__ hinit,  // [L·B, P]
    const T* __restrict__ wz,         // [L, 2P, 4H]: wx_l is its first P rows
    const T* __restrict__ wh_sl,      // [L, C, P16, 4, US]
    const T* __restrict__ pj_sl,      // [L, C, U16, P16] or null (P == H)
    const float* __restrict__ bias,   // [L, 4H]
    const float* __restrict__ peep,   // [L, 3, H] or null
    float forget_bias, float keep_prob, int residual,
    const float* __restrict__ dout,   // [S, B, P]
    const float* __restrict__ dcfin,  // [L·B, H]
    const float* __restrict__ dhfin,  // [L·B, P]
    int steps, int layers, int batch, int H, int P,
    S* __restrict__ dgates,           // [S, L·B, 4H]
    T* __restrict__ outb_st,          // [S, L·B, H] or null
    T* __restrict__ doutp_st,         // [S, L·B, P] or null
    float* __restrict__ dcinit,       // [L·B, H]
    float* __restrict__ dhinit,       // [L·B, P]
    float* __restrict__ din,          // [L, S, B, P] (layer 0's unwritten)
    float* __restrict__ dc_in,        // [S, L·B, H] or null
    float* __restrict__ dh_in,        // [S, L·B, P] or null
    const float* __restrict__ gxl,    // [L-1, S, B, 4H] in_prev·wx_l, l >= 1
    T* __restrict__ dgc,              // scratch ring [L, 2K, B, 4H]
    float* __restrict__ col_part,     // [tiles, L, 7H]
    int* __restrict__ counters,       // [L, tiles, C], zero at the first wave
    int tile0, int tiles, int lag,
    int cap) {                        // ignored: the resident plans hold all of wh
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int l = layers - 1 - (int)blockIdx.y;  // the layers above come first
  const int tile = tile0 + blockIdx.x / C, b0 = tile * R;
  const int nr = min(R, batch - b0);
  const bool has_proj = pj_sl != nullptr;
  const StackPlan pl = stack_plan<T, S>(H, P, has_proj, R, C, false, cap);
  const int US = pl.us, G = pl.g, PS = pl.ps, PW = pl.pw, P16 = pl.p16;
  const int prow = pl.prow, nd = pl.nd, H4 = 4 * H;
  const int u0 = q * US, nu = max(0, min(US, H - u0));
  const int p0 = q * PS, np = max(0, min(PS, P - p0));
  const int tid = threadIdx.x;
  const size_t LB = (size_t)layers * batch, lrow = (size_t)l * batch + b0;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* hq = reinterpret_cast<T*>(smem_raw);                  // [arow][lda] h_prev
  T* dq = reinterpret_cast<T*>(smem_raw + pl.off_dq);      // [arow][lda] dout_p
  T* gq = reinterpret_cast<T*>(smem_raw + pl.off_gq);      // [arow][ldg] dgates
  float* dh = reinterpret_cast<float*>(smem_raw + pl.off_dh);    // [R][PW]
  float* dnx = reinterpret_cast<float*>(smem_raw + pl.off_dnx);  // [R][PW] dchain
  // the step before's loads, staged by cp.async: dchain (swapped with dnx),
  // the raw h and c rows, the owned units' gate inputs
  float* dnx_next = reinterpret_cast<float*>(smem_raw + pl.off_dnx2);  // [R][PW]
  S* h_raw = reinterpret_cast<S*>(smem_raw + pl.off_hraw);             // [R][P]
  S* c_raw = reinterpret_cast<S*>(smem_raw + pl.off_craw);             // [R][US]
  float* gx_s = reinterpret_cast<float*>(smem_raw + pl.off_gxs);       // [R][4][US]
  float* mask_s = reinterpret_cast<float*>(smem_raw + pl.off_rows);    // [2][R]
  float* dc = reinterpret_cast<float*>(smem_raw + pl.off_dc);    // [R][US]
  float* inbox = reinterpret_cast<float*>(smem_raw + pl.off_inbox);  // [C][R][PS]
  float* part = reinterpret_cast<float*>(smem_raw + pl.off_part);
  float* part_d = part + (size_t)pl.gates.slices * prow * G;  // dout_blk's partials
  T* wh_s = reinterpret_cast<T*>(smem_raw + pl.off_wh);
  T* pj_s = reinterpret_cast<T*>(smem_raw + pl.off_pj);
  T* in_s = wh_s;  // float32: din's staged rows (no slices in shared memory)

  const size_t slot = (size_t)l * C + q;
  const T* wh_g = wh_sl + slot * (size_t)P16 * G;
  const T* pj_g = has_proj ? pj_sl + slot * (size_t)pl.u16 * P16 : nullptr;
  const T* wx_l = wz + (size_t)l * 2 * P * H4;
  const bool last = l == layers - 1;
  const size_t plane = (size_t)steps * batch * P;  // one layer's din
  float* din_l = din + (size_t)l * plane;
  const float* din_above = last ? nullptr : din + (size_t)(l + 1) * plane;
  const float* gx_src = l > 0 ? gxl + (size_t)(l - 1) * steps * batch * H4 : gx0;
  T* ring = dgc + (size_t)l * 2 * lag * batch * H4;
  const bool res = l > 0 && ((residual >> l) & 1);
  const bool drop = seed != nullptr && keep_prob < 1.0f;
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;
  const float inv_keep = 1.0f / keep_prob;
  int* const above = last ? nullptr : counters + ((size_t)(l + 1) * tiles + tile) * C;
  int* const mine = counters + ((size_t)l * tiles + tile) * C + q;
  const T zero = Dtype<T>::from_float(0.0f);
  auto ring_row = [&](int s, int r) {
    return ring + ((size_t)((steps - 1 - s) % (2 * lag)) * batch + b0 + r) * H4;
  };

  if constexpr (kMma<T>) {
    copy_rows(wh_s, pl.lwh, wh_g, G, P16);
    for (int i = tid; i < (pl.wrows - P16) * pl.lwh; i += kThreads)
      wh_s[(size_t)P16 * pl.lwh + i] = zero;
    if (has_proj) copy_rows(pj_s, pl.lpj, pj_g, P16, pl.u16);
  }
  for (int i = tid; i < pl.arow * pl.lda; i += kThreads) hq[i] = dq[i] = zero;
  for (int i = tid; i < pl.arow * pl.ldg; i += kThreads) gq[i] = zero;
  for (int i = tid; i < R * PW; i += kThreads) {
    const int r = i / PW, p = i - r * PW;
    dh[i] = r < nr && p < P ? dhfin[(lrow + r) * P + p] : 0.0f;
    dnx[i] = dnx_next[i] = 0.0f;
  }
  for (int i = tid; i < R * US; i += kThreads) {
    const int r = i / US, j = i - r * US;
    dc[i] = r < nr && j < nu ? dcfin[(lrow + r) * H + u0 + j] : 0.0f;
  }

  // the cell phase: thread (rb, jb) owns one unit of one row
  const int rb = tid / US, jb = tid - rb * US;
  const bool in_b = tid < R * US && rb < nr;
  const bool own_b = in_b && jb < nu;
  const int ub = u0 + jb;
  const float* pd = peep ? peep + (size_t)l * 3 * H : nullptr;
  float pi = 0.0f, pf = 0.0f, po = 0.0f, bias_own[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (own_b)
#pragma unroll
    for (int k = 0; k < 4; ++k) bias_own[k] = bias[(size_t)l * H4 + k * H + ub];
  if (pd && own_b) {
    pi = pd[ub];
    pf = pd[H + ub];
    po = pd[2 * H + ub];
  }
  // the column sums over dgates as stored: dbias (i, j, f, o), then the
  // peephole sums (i, f, o)
  float sums[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float gnext[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cnext = 0.0f;

  // What step tt reads that no carry feeds: dchain (layer l+1's din at tt+1,
  // once its blocks have counted it, or dout), the previous h, and for the
  // owned units the gate inputs and the previous c.  fetch_step starts their
  // copies a step ahead (cp.async, 4 elements a copy); stash_step puts them
  // where the step reads them.
  float mask_next = 0.0f;  // thread r < nr: row r's mask at the step fetched
  int seen = 0;            // thread q < C: the count last read of block q above
  auto fetch_step = [&](int tt) {
    if (!last && tt + 1 < steps) wait_blocks<C>(above, steps - 1 - tt, seen);
    const size_t r0 = (size_t)tt * LB + lrow, rp = r0 - LB;
    const size_t d0 = ((size_t)(last ? tt : tt + 1) * batch + b0) * P;
    const float* dsrc = last ? dout + d0 : (tt + 1 < steps ? din_above + d0 : nullptr);
    if (tid < nr) mask_next = mask[r0 + tid];
    const int pq = P / 4;
    for (int i = tid; i < nr * pq; i += kThreads) {
      const int r = i / pq, p = 4 * (i - r * pq);
      if (dsrc)
        cp_async4(dnx_next + r * PW + p, dsrc + (size_t)r * P + p);
      else
        *reinterpret_cast<float4*>(dnx_next + r * PW + p) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (tt > 0) cp_async4(h_raw + r * P + p, h_all + (rp + r) * P + p);
    }
    const int uq = nu / 4;
    for (int i = tid; i < nr * 5 * uq; i += kThreads) {
      const int r = i / (5 * uq), e = i - r * 5 * uq, k = e / uq, j = 4 * (e - k * uq);
      if (k < 4)
        cp_async4(gx_s + (r * 4 + k) * US + j,
                  gx_src + ((size_t)tt * batch + b0 + r) * H4 + k * H + u0 + j);
      else if (tt > 0)
        cp_async4(c_raw + r * US + j, c_all + (rp + r) * H + u0 + j);
    }
    cp_async_commit();
  };
  auto land_step = [&](int tt) {
    cp_async_wait_all();
    if (tid < nr) mask_s[(tt & 1) * R + tid] = mask_next;
    __syncthreads();
  };
  auto stash_step = [&](int tt) {
    float* d = dnx;
    dnx = dnx_next;
    dnx_next = d;
    for (int i = tid; i < nr * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      hq[r * pl.lda + p] = Dtype<T>::from_float(
          tt > 0 ? ld(h_raw, (size_t)r * P + p) : rnd<S>(hinit[(lrow + r) * P + p]));
    }
    if (own_b) {
#pragma unroll
      for (int k = 0; k < 4; ++k) gnext[k] = gx_s[(rb * 4 + k) * US + jb] + bias_own[k];
      cnext = tt > 0 ? ld(c_raw, (size_t)rb * US + jb) : rnd<S>(cinit[(lrow + rb) * H + ub]);
    }
  };
  auto gate_product = [&]() {
    if constexpr (kMma<T>)
      mma_product_f32add<false>(hq, pl.lda, P16, wh_s, pl.lwh, G, pl.gates, part);
    else
      fma_product<R>(hq, pl.lda, P16, wh_g, G, G, pl.gates, part);
  };
  // the chain cotangent entering step s at (row r, column p)
  auto dchain = [&](int s, int r, int p) {
    float v = dnx[r * PW + p];
    if (drop)
      v *= drop_factor((uint32_t)((size_t)s * LB + lrow + r), (uint32_t)p, sd, keep_prob,
                       inv_keep);
    return v;
  };
  auto din_product = [&](int t0, int cnt) {
    din_steps(t0, cnt, nr, np, p0, H4, wx_l, ring_row, din_l, batch, b0, P, in_s, pl.staged);
  };

  cluster.sync();  // every block is resident and initialised
  if (steps > 0) {
    fetch_step(steps - 1);
    land_step(steps - 1);
    stash_step(steps - 1);
    __syncthreads();
    gate_product();
  }
  __syncthreads();

  for (int t = steps - 1; t >= 0; --t) {
    const size_t row0 = (size_t)t * LB + lrow;   // rows of [S, L·B, ·]
    const size_t brow = (size_t)t * batch + b0;  // rows of [S, B, ·]
    const int done = steps - t;                   // steps finished after this one
    const bool chunk_end = l > 0 && (done % lag == 0 || t == 0);
    if (t > 0) fetch_step(t - 1);

    // 1. dout_p over the full P; the stashes and din's residual part of
    // the owned P-slice
    for (int i = tid; i < nr * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      const float m = mask_s[(t & 1) * R + r];
      const float dcv = dchain(t, r, p);
      const float dhv = dh[r * PW + p];
      dq[r * pl.lda + p] = Dtype<T>::from_float(m * (dcv + dhv));
      if (p >= p0 && p < p0 + PS) {
        if (doutp_st) doutp_st[(row0 + r) * P + p] = dq[r * pl.lda + p];
        if (dh_in) dh_in[(row0 + r) * P + p] = dhv;
        if (l > 0) din_l[(brow + r) * P + p] = res ? dcv : 0.0f;
      }
    }
    __syncthreads();

    // 2. dout_blk of the owned units
    if (has_proj) {
      if constexpr (kMma<T>)
        mma_product_f32add<true>(dq, pl.lda, P16, pj_s, pl.lpj, nd, pl.dob, part_d);
      else
        fma_product_nk<R>(dq, pl.lda, P16, pj_g, P16, nd, pl.u16, pl.dob, part_d);
      __syncthreads();
    }

    // 3. the cell backward of the owned units
    if (in_b) {
      float dgv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (own_b) {
        float gate[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float v = gnext[k];
          for (int s = 0; s < pl.gates.slices; ++s)
            v += part[((size_t)s * prow + rb) * G + k * US + jb];
          gate[k] = v;
        }
        const float m = mask_s[(t & 1) * R + rb];
        const float c0 = cnext;
        gate[0] += pi * c0;
        gate[2] += pf * c0;
        const float si = sigmoidf(gate[0]), tj = tanhf(gate[1]);
        const float sf = sigmoidf(gate[2] + forget_bias);
        const float cn = sf * c0 + si * tj;
        gate[3] += po * cn;
        const float so = sigmoidf(gate[3]), tc = tanhf(cn);
        float db;
        if (has_proj) {
          db = 0.0f;
          for (int s = 0; s < pl.dob.slices; ++s)
            db += part_d[((size_t)s * prow + rb) * nd + jb];
        } else {
          db = m * (dchain(t, rb, ub) + dh[rb * PW + ub]);
        }
        const int ib = rb * US + jb;
        const float dcv = dc[ib];
        if (dc_in) dc_in[(row0 + rb) * H + ub] = dcv;
        const float d_o = db * tc * so * (1.0f - so);
        const float dcn = db * so * (1.0f - tc * tc) + m * dcv + d_o * po;
        const float d_f = dcn * c0 * sf * (1.0f - sf);
        const float d_i = dcn * tj * si * (1.0f - si);
        const float d_j = dcn * si * (1.0f - tj * tj);
        dc[ib] = dcn * sf + (1.0f - m) * dcv + d_f * pf + d_i * pi;
        dgv[0] = d_i;
        dgv[1] = d_j;
        dgv[2] = d_f;
        dgv[3] = d_o;
        S* dg_row = dgates + (row0 + rb) * H4;
        T* dgc_row = ring_row(t, rb);
        float stored[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const S v = Dtype<S>::from_float(dgv[k]);
          dg_row[k * H + ub] = v;
          if (l > 0) dgc_row[k * H + ub] = Dtype<T>::from_float(dgv[k]);
          stored[k] = Dtype<S>::to_float(v);
          sums[k] += stored[k];
        }
        sums[4] = fmaf(stored[0], c0, sums[4]);
        sums[5] = fmaf(stored[2], c0, sums[5]);
        sums[6] = fmaf(stored[3], cn, sums[6]);
        if (outb_st) outb_st[(row0 + rb) * H + ub] = Dtype<T>::from_float(so * tc);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) gq[rb * pl.ldg + k * US + jb] = Dtype<T>::from_float(dgv[k]);
    }
    __syncthreads();

    // 4. this block's partial dh_prev: dgates_q · wh_qᵀ, [R, PW]
    float* part_h = part;
    if constexpr (kMma<T>)
      mma_product_f32add<true>(gq, pl.ldg, G, wh_s, pl.lwh, PW, pl.dh, part_h);
    else
      fma_product_nk<R>(gq, pl.ldg, G, wh_g, G, PW, P16, pl.dh, part_h);
    __syncthreads();

    // 5a. reduce-scatter: each P-slice's partial into its owner's inbox
    const int quads = PW / 4;
    for (int i = tid; i < nr * quads; i += kThreads) {
      const int r = i / quads, p = 4 * (i - r * quads);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int s = 0; s < pl.dh.slices; ++s) {
        const float4 w =
            *reinterpret_cast<const float4*>(part_h + ((size_t)s * prow + r) * PW + p);
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      }
      const int owner = p / PS;
      float* dst = cluster.map_shared_rank(inbox, owner) + ((size_t)q * R + r) * PS + p - owner * PS;
      *reinterpret_cast<float4*>(dst) = v;
    }
    // at the end of a chunk the ring's dgates are read by every block of
    // the cluster
    if (chunk_end) __threadfence();
    __syncthreads();  // part_h is read before the next gate sums overwrite it
    cluster_arrive();
    if (t > 0) {
      land_step(t - 1);
      stash_step(t - 1);
      __syncthreads();
      gate_product();
    }
    cluster_wait();

    // 5b. the C partials of the owned slice, in block order; the carry
    // update; the new slice into every block
    const int squads = PS / 4;
    for (int i = tid; i < nr * squads; i += kThreads) {
      const int r = i / squads, c = 4 * (i - r * squads), p = p0 + c;
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int b = 0; b < C; ++b) {
        const float4 w = *reinterpret_cast<const float4*>(inbox + ((size_t)b * R + r) * PS + c);
        s[0] += w.x;
        s[1] += w.y;
        s[2] += w.z;
        s[3] += w.w;
      }
      const float m = mask_s[(t & 1) * R + r];
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = p + e < P ? (1.0f - m) * dh[r * PW + p + e] + s[e] : 0.0f;
      const float4 nv = make_float4(v[0], v[1], v[2], v[3]);
      for (int b = 0; b < C; ++b)
        *reinterpret_cast<float4*>(cluster.map_shared_rank(dh, b) + r * PW + p) = nv;
    }
    cluster.sync();

    // 6. a chunk's din, counted for the layer below
    if (chunk_end) {
      const int cnt = done - (done - 1) / lag * lag;
      din_product(t, cnt);
      publish(mine, done);
    }
  }

  // the carries left after step 0 are the initial states' cotangents
  for (int i = tid; i < nr * US; i += kThreads) {
    const int r = i / US, j = i - r * US;
    if (j < nu) dcinit[(lrow + r) * H + u0 + j] = dc[i];
  }
  for (int i = tid; i < nr * np; i += kThreads) {
    const int r = i / np, j = i - r * np;
    dhinit[(lrow + r) * P + p0 + j] = dh[r * PW + p0 + j];
  }
  // this row tile's column sums: the rows added in order
  float* st = part;  // [7][R][US]
  if (in_b)
    for (int k = 0; k < 7; ++k) st[(k * R + rb) * US + jb] = sums[k];
  __syncthreads();
  float* out = col_part + ((size_t)tile * layers + l) * 7 * H;
  for (int i = tid; i < 7 * nu; i += kThreads) {
    const int k = i / nu, j = i - k * nu;
    float v = 0.0f;
    for (int r = 0; r < nr; ++r) v += st[(k * R + r) * US + j];
    out[k * H + u0 + j] = v;
  }
}

// The bf16 plans of 16 blocks (R of {2, 4, 8, 16}; S: the store dtype):
// the resident plans' step, with the buffers of the R rows cut to what a
// block owns, and wh streamed as K2's streamed plan streams it, or with
// kHeld every weight resident (the resident plan of 16 blocks), so that a
// cluster of 8-16 rows fits beside the ring or the slices (see the design
// notes at the top).
template <typename S, int R, bool kHeld>
__global__ void __launch_bounds__(kThreads, 1) stack_bwd_streamed_kernel(
    const int* __restrict__ seed, const float* __restrict__ gx0, const float* __restrict__ mask,
    const S* __restrict__ chain, const S* __restrict__ c_all, const S* __restrict__ h_all,
    const float* __restrict__ cinit, const float* __restrict__ hinit,
    const __nv_bfloat16* __restrict__ wz,
    const __nv_bfloat16* __restrict__ wh_sl,  // [L, C, P16, LWH] (kHeld: [L, C, P16, 4·US])
    const __nv_bfloat16* __restrict__ pj_sl,  // [L, C, U16, LPJ] (kHeld: P16) or null (P == H)
    const float* __restrict__ bias, const float* __restrict__ peep, float forget_bias,
    float keep_prob, int residual, const float* __restrict__ dout,
    const float* __restrict__ dcfin, const float* __restrict__ dhfin, int steps, int layers,
    int batch, int H, int P, S* __restrict__ dgates, __nv_bfloat16* __restrict__ outb_st,
    __nv_bfloat16* __restrict__ doutp_st, float* __restrict__ dcinit,
    float* __restrict__ dhinit, float* __restrict__ din, float* __restrict__ dc_in,
    float* __restrict__ dh_in, const float* __restrict__ gxl, __nv_bfloat16* __restrict__ dgc,
    float* __restrict__ col_part, int* __restrict__ counters, int tile0, int tiles, int lag,
    int cap) {
  typedef __nv_bfloat16 T;
  constexpr int C = kWideCluster;
  constexpr int kArow = R > 8 ? 16 : 8;  // the products' rows of A
  constexpr int kRows = cell_rows(R);    // a cell-phase thread's rows at most
  constexpr bool kStaged = !std::is_same<S, T>::value;  // h_prev staged, then rounded
  static_assert(R <= 16, "one 16-row tile of mma's A");
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int l = layers - 1 - (int)blockIdx.y;  // the layers above come first
  const int tile = tile0 + blockIdx.x / C, b0 = tile * R;
  const int nr = min(R, batch - b0);
  const bool has_proj = pj_sl != nullptr;
  const StackPlan pl = stack_plan<T, S>(H, P, has_proj, R, C, true, cap, kHeld);
  const int US = pl.us, G = pl.g, PS = pl.ps, P16 = pl.p16, nd = pl.nd, H4 = 4 * H;
  const int u0 = q * US, nu = max(0, min(US, H - u0));
  const int p0 = q * PS, np = max(0, min(PS, P - p0));
  const int tid = threadIdx.x;
  const size_t LB = (size_t)layers * batch, lrow = (size_t)l * batch + b0;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* hq = reinterpret_cast<T*>(smem_raw);                  // [kArow][lda] h_prev
  T* dq = reinterpret_cast<T*>(smem_raw + pl.off_dq);      // [kArow][lda] dout_p (proj)
  T* gq = reinterpret_cast<T*>(smem_raw + pl.off_gq);      // [kArow][ldg] dgates
  float* dh = reinterpret_cast<float*>(smem_raw + pl.off_dh);    // [R][PS] the carry's slice
  float* dnx = reinterpret_cast<float*>(smem_raw + pl.off_dnx);  // [2][R][PS] dchain's slice
  S* h_raw = reinterpret_cast<S*>(smem_raw + pl.off_hraw);       // [R][P] (kStaged)
  S* c_raw = reinterpret_cast<S*>(smem_raw + pl.off_craw);       // [2][R][US] c_prev
  float* mask_s = reinterpret_cast<float*>(smem_raw + pl.off_rows);  // [2][R]
  float* dc = reinterpret_cast<float*>(smem_raw + pl.off_dc);        // [R][US]
  float* inbox = reinterpret_cast<float*>(smem_raw + pl.off_inbox);  // [C][R][PS]
  float* gsum = reinterpret_cast<float*>(smem_raw + pl.off_gsum);    // [R][G]
  float* part = reinterpret_cast<float*>(smem_raw + pl.off_part);    // dout_blk's slices
  T* wh_s = reinterpret_cast<T*>(smem_raw + pl.off_wh);
  T* pj_s = reinterpret_cast<T*>(smem_raw + pl.off_pj);  // kHeld
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + pl.off_bar);
  const Ring wring{smem_raw + pl.off_ring, full, pl.slots, pl.slot};

  // the slices as the wrapper lays them out: rows padded to the shared
  // memory's strides (streamed), or dense (held)
  const int lwh_g = kHeld ? G : pl.lwh, lpj_g = kHeld ? P16 : pl.lpj;
  const size_t slot = (size_t)l * C + q;
  const T* wh_g = wh_sl + slot * (size_t)P16 * lwh_g;
  const T* pj_g = has_proj ? pj_sl + slot * (size_t)pl.u16 * lpj_g : nullptr;
  const T* wx_l = wz + (size_t)l * 2 * P * H4;
  const bool last = l == layers - 1;
  const size_t plane = (size_t)steps * batch * P;  // one layer's din
  float* din_l = din + (size_t)l * plane;
  const float* din_above = last ? nullptr : din + (size_t)(l + 1) * plane;
  const float* gx_src = l > 0 ? gxl + (size_t)(l - 1) * steps * batch * H4 : gx0;
  const float* bias_l = bias + (size_t)l * H4;
  T* ring = dgc + (size_t)l * 2 * lag * batch * H4;
  const bool res = l > 0 && ((residual >> l) & 1);
  const bool drop = seed != nullptr && keep_prob < 1.0f;
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;
  const float inv_keep = 1.0f / keep_prob;
  int* const above = last ? nullptr : counters + ((size_t)(l + 1) * tiles + tile) * C;
  int* const mine = counters + ((size_t)l * tiles + tile) * C + q;
  const T zero = Dtype<T>::from_float(0.0f);
  auto ring_row = [&](int s, int r) {
    return ring + ((size_t)((steps - 1 - s) % (2 * lag)) * batch + b0 + r) * H4;
  };

  // wh's resident rows (held: all of wh and proj); the carries' slices
  copy_rows(wh_s, pl.lwh, wh_g, lwh_g, 16 * pl.res);
  if (kHeld && has_proj) copy_rows(pj_s, pl.lpj, pj_g, lpj_g, pl.u16);
  if (tid == 0) {
    for (int i = 0; i < pl.slots; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
  }
  for (int i = tid; i < kArow * pl.lda; i += kThreads) {
    hq[i] = zero;
    if (has_proj) dq[i] = zero;
  }
  for (int i = tid; i < kArow * pl.ldg; i += kThreads) gq[i] = zero;
  for (int i = tid; i < R * PS; i += kThreads) {
    const int r = i / PS, c = i - r * PS;
    dh[i] = r < nr && c < np ? dhfin[(lrow + r) * P + p0 + c] : 0.0f;
  }
  for (int i = tid; i < R * US; i += kThreads) {
    const int r = i / US, j = i - r * US;
    dc[i] = r < nr && j < nu ? dcfin[(lrow + r) * H + u0 + j] : 0.0f;
  }

  // the cell phase: thread tid owns unit jb of rows rb0, rb0 + RS, .. below
  // nr
  const int RS = kThreads / US, rb0 = tid / US, jb = tid - rb0 * US;
  const bool in_b = rb0 < RS, own_u = jb < nu;
  const int ub = u0 + jb;
  const float* pd = peep ? peep + (size_t)l * 3 * H : nullptr;
  // the column sums over dgates as stored (dbias i, j, f, o; the peephole
  // sums i, f, o) of the thread's rows, added in row order
  float sums[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  // the chain cotangent entering step tt at (row r, owned column c)
  auto dchain = [&](int tt, int r, int c) {
    float v = dnx[((tt & 1) * R + r) * PS + c];
    if (drop)
      v *= drop_factor((uint32_t)((size_t)tt * LB + lrow + r), (uint32_t)(p0 + c), sd,
                       keep_prob, inv_keep);
    return v;
  };
  // What step tt reads that no carry feeds: dchain of the owned P-slice
  // (layer l+1's din at tt+1, once its blocks have counted it, or dout),
  // the previous h (straight into hq where the store dtype is bf16) and the
  // owned units' previous c, by cp.async a step ahead (4 elements a copy;
  // at tt = 0 the initial states, rounded to the store dtype).
  float mask_next = 0.0f;  // thread r < nr: row r's mask at the step fetched
  int seen = 0;            // thread q < C: the count last read of block q above
  auto fetch_step = [&](int tt) {
    if (!last && tt + 1 < steps) wait_blocks<C>(above, steps - 1 - tt, seen);
    const size_t r0 = (size_t)tt * LB + lrow, rp = r0 - LB;
    const size_t d0 = ((size_t)(last ? tt : tt + 1) * batch + b0) * P + p0;
    const float* dsrc = last ? dout + d0 : (tt + 1 < steps ? din_above + d0 : nullptr);
    if (tid < nr) mask_next = mask[r0 + tid];
    float* dn = dnx + (size_t)(tt & 1) * R * PS;
    const int cq = np / 4;
    for (int i = tid; i < nr * cq; i += kThreads) {
      const int r = i / cq, c = 4 * (i - r * cq);
      if (dsrc)
        cp_async4(dn + r * PS + c, dsrc + (size_t)r * P + c);
      else
        *reinterpret_cast<float4*>(dn + r * PS + c) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    const int pq = P / 4;
    for (int i = tid; i < nr * pq; i += kThreads) {
      const int r = i / pq, p = 4 * (i - r * pq);
      S* dst;
      if constexpr (kStaged)
        dst = h_raw + r * P + p;
      else
        dst = hq + r * pl.lda + p;
      if (tt > 0) {
        cp_async4(dst, h_all + (rp + r) * P + p);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = Dtype<S>::from_float(hinit[(lrow + r) * P + p + e]);
      }
    }
    S* cn = c_raw + (size_t)(tt & 1) * R * US;
    const int uq = nu / 4;
    for (int i = tid; i < nr * uq; i += kThreads) {
      const int r = i / uq, j = 4 * (i - r * uq);
      if (tt > 0) {
        cp_async4(cn + r * US + j, c_all + (rp + r) * H + u0 + j);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cn[r * US + j + e] = Dtype<S>::from_float(cinit[(lrow + r) * H + u0 + j + e]);
      }
    }
    cp_async_commit();
  };
  auto land_step = [&](int tt) {
    cp_async_wait_all();
    if (tid < nr) mask_s[(tt & 1) * R + tid] = mask_next;
    __syncthreads();
    if constexpr (kStaged) {
      for (int i = tid; i < nr * P; i += kThreads) {
        const int r = i / P, p = i - r * P;
        hq[r * pl.lda + p] = Dtype<T>::from_float(ld(h_raw, (size_t)r * P + p));
      }
      __syncthreads();
    }
  };
  // the chunk sequence: wh's streamed rows for the first gate sums, then a
  // step at a time proj's rows and wh's streamed rows (one thread issues
  // each), as K2's
  const int per_step = pl.np + pl.nw, total = pl.nw + steps * per_step;
  auto issue = [&](int n) {
    const int i = n < pl.nw ? pl.np + n : (n - pl.nw) % per_step;
    if (i < pl.np) {
      const int r0 = 16 * i * pl.cu, rows = min(16 * pl.cu, pl.u16 - r0);
      wring.issue(n, pj_g + (size_t)r0 * pl.lpj, sizeof(T) * rows * pl.lpj);
    } else {
      const int r0 = 16 * (pl.res + (i - pl.np) * pl.cw), rows = min(16 * pl.cw, P16 - r0);
      wring.issue(n, wh_g + (size_t)r0 * pl.lwh, sizeof(T) * rows * pl.lwh);
    }
  };
  int chunk = 0;  // the next chunk to read
  // the pass over wh's rows: this step's partial dh_prev = dgates_q · wh_qᵀ
  // straight into the owners' inboxes (with dh_on; inbox[q] of the owner of
  // each P-slice), and the gate sums of step tt >= 0 (gx + bias + h_prev ·
  // wh_l, gx read from L2 as the pass starts) into gsum
  auto wh_pass = [&](bool dh_on, int tt) {
    bwd_wh_pass<kArow, kHeld>(
        dh_on, tt >= 0, hq, pl.lda, gq, pl.ldg, G, pl.wsteps, pl.gsteps, pl.gates, pl.dh, wh_s,
        pl.lwh, pl.res, wring, pl.cw, chunk, total, issue,
        [&](int r, int c) {
          const int k = c / US, j = c - k * US;
          return r < nr && j < nu
                     ? __ldg(gx_src + ((size_t)tt * batch + b0 + r) * H4 + k * H + u0 + j) +
                           __ldg(bias_l + k * H + u0 + j)
                     : 0.0f;
        },
        nr, gsum,
        [&](int r, int p, float v0, float v1) {
          const int owner = p / PS;
          float* dst = cluster.map_shared_rank(inbox, owner) + ((size_t)q * R + r) * PS + p -
                       owner * PS;
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        });
  };
  // dout_p of step tt at row r, owned columns c .. c+3, from the carry's
  // slice v, rounded, into every block's dq (the A operand of dout_blk).
  // dchain's dropout product is rounded before the add, as the resident
  // plans round it (their dchain value has other uses there): an FMA here
  // would round dout_p otherwise now and then
  auto share_dq = [&](int tt, int r, int c, const float (&v)[4]) {
    const float m = mask_s[(tt & 1) * R + r];
    __align__(8) T x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float d = dnx[((tt & 1) * R + r) * PS + c + e];
      if (drop)
        d = __fmul_rn(d, drop_factor((uint32_t)((size_t)tt * LB + lrow + r), (uint32_t)(p0 + c + e),
                                     sd, keep_prob, inv_keep));
      x[e] = Dtype<T>::from_float(m * __fadd_rn(d, v[e]));
    }
    const uint2 word = *reinterpret_cast<const uint2*>(x);
    for (int b = 0; b < C; ++b)
      *reinterpret_cast<uint2*>(cluster.map_shared_rank(dq, b) + r * pl.lda + p0 + c) = word;
  };
  auto din_product = [&](int t0, int cnt) {
    din_steps<T>(t0, cnt, nr, np, p0, H4, wx_l, ring_row, din_l, batch, b0, P, nullptr, 0);
  };

  cluster.sync();  // every block is resident and initialised
  if (tid == 0)
    for (int n = 0; n < pl.slots && n < total; ++n) issue(n);
  const int nq = np / 4;  // the owned P-slice's quads of columns
  fetch_step(steps - 1);
  land_step(steps - 1);
  if (has_proj)
    for (int i = tid; i < nr * nq; i += kThreads) {
      const int r = i / nq, c = 4 * (i - r * nq);
      const float v[4] = {dh[r * PS + c], dh[r * PS + c + 1], dh[r * PS + c + 2],
                          dh[r * PS + c + 3]};
      share_dq(steps - 1, r, c, v);
    }
  cluster.sync();  // the first step's dout_p in every block
  wh_pass(false, steps - 1);

  for (int t = steps - 1; t >= 0; --t) {
    const size_t row0 = (size_t)t * LB + lrow;   // rows of [S, L·B, ·]
    const size_t brow = (size_t)t * batch + b0;  // rows of [S, B, ·]
    const int done = steps - t;                   // steps finished after this one
    const bool chunk_end = l > 0 && (done % lag == 0 || t == 0);
    if (t > 0) fetch_step(t - 1);

    // 1. the stashes and din's residual part of the owned P-slice
    for (int i = tid; i < nr * np; i += kThreads) {
      const int r = i / np, c = i - r * np, p = p0 + c;
      const float dcv = dchain(t, r, c), dhv = dh[r * PS + c];
      if (doutp_st) doutp_st[(row0 + r) * P + p] = dq[r * pl.lda + p];
      if (dh_in) dh_in[(row0 + r) * P + p] = dhv;
      if (l > 0) din_l[(brow + r) * P + p] = res ? dcv : 0.0f;
    }

    // 2. dout_blk of the owned units, over proj's chunks of rows (held:
    // all of them at once)
    if (has_proj) {
      if constexpr (kHeld) {
        mma_f32add_tiles<true, kArow>(dq, pl.lda, P16, pj_s, pl.lpj, pl.utiles, pl.dob, part,
                                      nd, 0);
        __syncthreads();
      } else {
        bwd_dob_pass<kArow>(dq, pl.lda, P16, wring, pl.lpj, pl.np, pl.cu, pl.utiles, pl.dob,
                            part, nd, chunk, total, issue);
      }
    }

    // 3. the cell backward of the owned units, a thread's rows in turn, the
    // unit's peepholes in registers for them (loaded a step at a time: none
    // stays live through the pass over wh)
    float pi = 0.0f, pf = 0.0f, po = 0.0f;
    if (pd && in_b && own_u) {
      pi = __ldg(pd + ub);
      pf = __ldg(pd + H + ub);
      po = __ldg(pd + 2 * H + ub);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int rb = rb0 + i * RS;
      if (!in_b || rb >= nr) break;
      float dgv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (own_u) {
        float gate[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) gate[k] = gsum[(size_t)rb * G + k * US + jb];
        const float m = mask_s[(t & 1) * R + rb];
        const float c0 = ld(c_raw, ((size_t)(t & 1) * R + rb) * US + jb);
        // the resident plans' statements in their order, as written there:
        // the compiler contracts them alike, so the plans give the same bits
        gate[0] += pi * c0;
        gate[2] += pf * c0;
        const float si = sigmoidf(gate[0]), tj = tanhf(gate[1]);
        const float sf = sigmoidf(gate[2] + forget_bias);
        const float cn = sf * c0 + si * tj;
        gate[3] += po * cn;
        const float so = sigmoidf(gate[3]), tc = tanhf(cn);
        float db;
        if (has_proj) {
          db = 0.0f;
          for (int s = 0; s < pl.dob.slices; ++s) db += part[((size_t)s * kArow + rb) * nd + jb];
        } else {
          db = m * (dchain(t, rb, jb) + dh[rb * PS + jb]);  // PS = US: the unit's column
        }
        const int ib = rb * US + jb;
        const float dcv = dc[ib];
        if (dc_in) dc_in[(row0 + rb) * H + ub] = dcv;
        const float d_o = db * tc * so * (1.0f - so);
        const float dcn = db * so * (1.0f - tc * tc) + m * dcv + d_o * po;
        const float d_f = dcn * c0 * sf * (1.0f - sf);
        const float d_i = dcn * tj * si * (1.0f - si);
        const float d_j = dcn * si * (1.0f - tj * tj);
        dc[ib] = dcn * sf + (1.0f - m) * dcv + d_f * pf + d_i * pi;
        dgv[0] = d_i;
        dgv[1] = d_j;
        dgv[2] = d_f;
        dgv[3] = d_o;
        S* dg_row = dgates + (row0 + rb) * H4;
        T* dgc_row = ring_row(t, rb);
        float stored[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const S v = Dtype<S>::from_float(dgv[k]);
          dg_row[k * H + ub] = v;
          if (l > 0) dgc_row[k * H + ub] = Dtype<T>::from_float(dgv[k]);
          stored[k] = Dtype<S>::to_float(v);
          sums[k] += stored[k];
        }
        sums[4] = fmaf(stored[0], c0, sums[4]);
        sums[5] = fmaf(stored[2], c0, sums[5]);
        sums[6] = fmaf(stored[3], cn, sums[6]);
        if (outb_st) outb_st[(row0 + rb) * H + ub] = Dtype<T>::from_float(so * tc);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) gq[rb * pl.ldg + k * US + jb] = Dtype<T>::from_float(dgv[k]);
    }
    __syncthreads();

    // 4. the step before's staged loads, then one pass over wh: dh_prev's
    // partials into the owners' inboxes, the step before's gate sums
    if (t > 0) land_step(t - 1);
    wh_pass(true, t - 1);
    // at the end of a chunk the ring's dgates are read by every block of
    // the cluster
    if (chunk_end) __threadfence();
    cluster.sync();  // every inbox complete, every read of dq done

    // 5. the owned slice: the C partials in block order, the carry, and the
    // step before's dout_p into every block
    for (int i = tid; i < nr * nq; i += kThreads) {
      const int r = i / nq, c = 4 * (i - r * nq);
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int b = 0; b < C; ++b) {
        const float4 w = *reinterpret_cast<const float4*>(inbox + ((size_t)b * R + r) * PS + c);
        s[0] += w.x;
        s[1] += w.y;
        s[2] += w.z;
        s[3] += w.w;
      }
      const float m = mask_s[(t & 1) * R + r];
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = (1.0f - m) * dh[r * PS + c + e] + s[e];
        dh[r * PS + c + e] = v[e];
      }
      if (has_proj && t > 0) share_dq(t - 1, r, c, v);
    }
    cluster.sync();

    // 6. a chunk's din, counted for the layer below
    if (chunk_end) {
      const int cnt = done - (done - 1) / lag * lag;
      din_product(t, cnt);
      publish(mine, done);
    }
  }

  // the carries left after step 0 are the initial states' cotangents
  for (int i = tid; i < nr * US; i += kThreads) {
    const int r = i / US, j = i - r * US;
    if (j < nu) dcinit[(lrow + r) * H + u0 + j] = dc[i];
  }
  for (int i = tid; i < nr * np; i += kThreads) {
    const int r = i / np, c = i - r * np;
    dhinit[(lrow + r) * P + p0 + c] = dh[r * PS + c];
  }
  // this row tile's column sums: each thread's rows, then the threads' in
  // row order
  float* st = part;  // [7][RS][US]
  if (in_b)
    for (int k = 0; k < 7; ++k) st[(k * RS + rb0) * US + jb] = sums[k];
  __syncthreads();
  float* out = col_part + ((size_t)tile * layers + l) * 7 * H;
  const int rows = min(RS, nr);
  for (int i = tid; i < 7 * nu; i += kThreads) {
    const int k = i / nu, j = i - k * nu;
    float v = 0.0f;
    for (int r = 0; r < rows; ++r) v += st[(k * RS + r) * US + j];
    out[k * H + u0 + j] = v;
  }
}

struct Args {
  const void *seed, *gx0, *mask, *chain, *c_all, *h_all, *cinit, *hinit;
  const void *wz, *wh_sl, *pj_rows, *bias, *peep;
  float forget_bias, keep_prob;
  int residual;
  const void *dout, *dcfin, *dhfin;
  int steps, layers, batch, units, out_dim;
  void *dgates, *outb_st, *doutp_st, *dcinit, *dhinit, *din, *dc_in, *dh_in;
  void *dwz, *dproj, *dcols, *scratch;
  cudaStream_t stream;
};

// How K13 launches: C blocks a cluster, rows a cluster, row tiles, tiles a
// wave, waves, the lag K, dynamic shared memory a block, and the clusters
// resident at once (rows = 0: not with this R, or no R whose L layers are
// resident together); whether on the streamed plan, and a block's weight
// bytes held in shared memory and read from L2 at every step (bf16: the
// streamed plan's streamed part; float32: wh twice and proj once).
struct Launch {
  int blocks, rows, tiles, per_wave, waves, lag;
  size_t smem;
  int resident, streamed;
  long long held, streams;
};

__host__ int lag_of(int steps) {
  const int k = cdiv(steps, 16);
  return k < 2 ? 2 : (k > 8 ? 8 : k);
}

// The scratch floats: gxl [L-1, S, B, 4H], the dgates ring [L, 2K, B, 4H]
// (compute dtype), the column sums [tiles, L, 7H], the weight-gradient
// products', and the counters [L, tiles, C] (int32); the sums and counters
// with room for the tiles and blocks of any plan a launch of the shape may
// be forced onto (R >= 2, C <= 16).
struct Scratch {
  size_t gxl, ring, cols, wgrad, counters;
};

template <typename T>
__host__ Scratch scratch_of(const Args& a, const Launch& how) {
  Scratch s;
  const size_t H4 = 4 * (size_t)a.units;
  s.gxl = (size_t)(a.layers - 1) * a.steps * a.batch * H4;
  s.ring = ((size_t)a.layers * 2 * how.lag * a.batch * H4 * sizeof(T) + 15) / 16 * 4;
  const size_t tiles = (size_t)cdiv(a.batch, 2);
  s.cols = tiles * a.layers * 7 * a.units;
  s.wgrad = (size_t)lstm_stack_wgrad_scratch_floats(a.steps, a.layers, a.batch, a.units,
                                                    a.out_dim);
  s.counters = (size_t)a.layers * tiles * kWideCluster;
  return s;
}

// The plan of R rows of a C-block cluster (streamed or resident)
template <typename T, typename S>
__host__ StackPlan plan_of(int units, int out_dim, bool has_proj, int R, int C, bool stream,
                           int cap) {
  return stack_plan<T, S>(units, out_dim, has_proj, R, C, stream, cap,
                          !stream && multi_row<T>(C));
}

// Whether a block of R rows of a C-block cluster fits this shape: at most
// kBlockUnits units a block on 8 blocks and kLayerUnits on 16, its shared
// memory within a block's, and its cell phase's rows a thread: at most
// cell_rows(R) on the bf16 plans of 16 blocks (R <= 16), one on the others
// (R·US <= kThreads); the streamed plan (wh's resident steps at most `cap`,
// -1 as many as fit, kAllHeld all of them or no plan) also needs at least
// two ring slots.  Host arithmetic only.
template <typename T, typename S, int R>
__host__ bool fits(int units, int out_dim, bool has_proj, int C, bool stream = false,
                   int cap = -1) {
  if (stream && (!kMma<T> || C != kWideCluster)) return false;
  const bool multi = multi_row<T>(C);  // several rows a cell-phase thread
  if (multi && R > 16) return false;
  const StackPlan pl = plan_of<T, S>(units, out_dim, has_proj, R, C, stream, cap);
  return pl.us <= (C == kCluster ? kBlockUnits : kLayerUnits) &&
         thread_rows(R, pl.us) <= (multi ? cell_rows(R) : 1) &&
         pl.bytes <= kMaxSmemPerBlock &&
         (!stream || (pl.slots >= 2 && (cap != kAllHeld || pl.res == pl.wsteps)));
}

// K13's plans, in the order they are tried: resident on 8 blocks (some R
// of {4, 6, 8}), resident on 16 (some R of {2, 4, 6, 8}: the smallest,
// which launches pick from {4, 6, 8, 2}, bf16 from {4, 8, 16, 2}),
// streamed on 16 (bf16; R of {2, 4}, likewise)
enum Kind { kNone = 0, kResident = 1, kStreamed = 2 };

struct Route {
  Kind kind;
  int blocks;
};

template <typename T, typename S>
__host__ Route stack_route(int units, int out_dim, bool has_proj) {
  if (fits<T, S, 4>(units, out_dim, has_proj, kCluster) ||
      fits<T, S, 6>(units, out_dim, has_proj, kCluster) ||
      fits<T, S, 8>(units, out_dim, has_proj, kCluster))
    return Route{kResident, kCluster};
  if (fits<T, S, 2>(units, out_dim, has_proj, kWideCluster) ||
      fits<T, S, 4>(units, out_dim, has_proj, kWideCluster) ||
      fits<T, S, 6>(units, out_dim, has_proj, kWideCluster) ||
      fits<T, S, 8>(units, out_dim, has_proj, kWideCluster))
    return Route{kResident, kWideCluster};
  if (fits<T, S, 2>(units, out_dim, has_proj, kWideCluster, true) ||
      fits<T, S, 4>(units, out_dim, has_proj, kWideCluster, true))
    return Route{kStreamed, kWideCluster};
  return Route{kNone, 0};
}

// the kernel of a plan: the streamed plan's (bf16), with every weight held
// for the resident plan of 16 blocks in bf16, else the resident plans'
template <typename T, typename S, int R, int C, bool kStream>
__host__ auto bwd_kernel() {
  if constexpr (kStream)
    return stack_bwd_streamed_kernel<S, R, false>;
  else if constexpr (multi_row<T>(C))
    return stack_bwd_streamed_kernel<S, R, true>;
  else
    return stack_bwd_kernel<T, S, R, C>;
}

template <typename T, typename S, int R, int C, bool kStream>
cudaError_t config(const Args& a, int cap, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                   Launch* how) {
  how->rows = 0;
  how->resident = 0;
  const bool has_proj = a.pj_rows != nullptr;
  if (!fits<T, S, R>(a.units, a.out_dim, has_proj, C, kStream, cap)) return cudaSuccess;
  const StackPlan pl = plan_of<T, S>(a.units, a.out_dim, has_proj, R, C, kStream, cap);
  auto kernel = bwd_kernel<T, S, R, C, kStream>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.bytes);
  if (err != cudaSuccess) return err;
  if (C > kCluster) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  const int tiles = cdiv(a.batch, R);
  *cfg = {};
  cfg->gridDim = dim3(C, a.layers, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = pl.bytes;
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
  const long long wh = (long long)sizeof(T) * pl.p16 * pl.g;
  const long long pj = has_proj ? (long long)sizeof(T) * pl.u16 * pl.p16 : 0;
  how->blocks = C;
  how->rows = R;
  how->tiles = tiles;
  how->per_wave = per_wave;
  how->waves = cdiv(tiles, per_wave);
  how->lag = lag_of(a.steps);
  how->smem = pl.bytes;
  how->streamed = kStream;
  how->held = kStream ? pl.res_bytes : kMma<T> ? wh + pj : 0;
  how->streams = kStream ? pl.stream_bytes : kMma<T> ? 0 : 2 * wh + pj;
  return cudaSuccess;
}

// The R of {4, 6, 8} with the fewest waves, then the smallest; with 16
// blocks R = 2 last; bf16 on 16 blocks (resident or streamed) R of {4, 8,
// 16}, then 2; rows = 0 when no R's L clusters are resident together
// (how->resident: the most resident of any R).
template <typename T, typename S, int C, bool kStream>
cudaError_t choose_rows(const Args& a, Launch* how) {
  *how = Launch{C, 0, 0, 0, 0, 0, 0, 0, kStream, 0, 0};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch c;
  cudaError_t err;
#define TRY(R)                                                          \
  err = config<T, S, R, C, kStream>(a, -1, &cfg, attr, &c);             \
  if (err != cudaSuccess) return err;                                   \
  if (c.rows && (!how->rows || c.waves < how->waves)) *how = c;         \
  how->resident = max(how->resident, c.resident);
  if constexpr (multi_row<T>(C)) {
    TRY(4) TRY(8) TRY(16) TRY(2)
  } else {
    TRY(4) TRY(6) TRY(8)
    if constexpr (C > kCluster) {
      TRY(2)
    }
  }
#undef TRY
  return cudaSuccess;
}

// The launch plan, or an error: no plan for the shape
// (cudaErrorInvalidConfiguration: past 2048 units, or bf16 slices that fit
// not even the streamed plan).  rows = 0: the plan exists but its L layers
// are not resident together.
template <typename T, typename S>
cudaError_t choose(const Args& a, Launch* how) {
  const Route r = stack_route<T, S>(a.units, a.out_dim, a.pj_rows != nullptr);
  if (r.kind == kStreamed) {
    if constexpr (kMma<T>) return choose_rows<T, S, kWideCluster, true>(a, how);
  }
  switch (r.kind == kResident ? r.blocks : 0) {
    case kCluster:
      return choose_rows<T, S, kCluster, false>(a, how);
    case kWideCluster:
      return choose_rows<T, S, kWideCluster, false>(a, how);
    default:
      *how = Launch{0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
      return cudaErrorInvalidConfiguration;
  }
}

template <typename T, typename S, int R, int C, bool kStream>
cudaError_t run(const Args& a, int cap, const Launch& how) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch again;
  cudaError_t err = config<T, S, R, C, kStream>(a, cap, &cfg, attr, &again);
  if (err != cudaSuccess) return err;
  if (!again.rows) return cudaErrorInvalidConfiguration;
  const int L = a.layers;
  const Scratch sc = scratch_of<T>(a, how);
  float* gxl = (float*)a.scratch;
  T* ring = (T*)(gxl + sc.gxl);
  float* cols = gxl + sc.gxl + sc.ring;
  float* wgrad = cols + sc.cols;
  int* counters = (int*)(wgrad + sc.wgrad);
  err = cudaMemsetAsync(counters, 0, sizeof(int) * L * how.tiles * C, a.stream);
  if (err != cudaSuccess) return err;
  constexpr bool kBf16 = kMma<T>;
  constexpr bool kStoreBf16 = std::is_same<S, __nv_bfloat16>::value;
  err = (cudaError_t)lstm_stack_gate_inputs(kBf16, kStoreBf16, a.chain, a.wz, a.steps, L,
                                            a.batch, a.units, a.out_dim, gxl, a.stream);
  if (err != cudaSuccess) return err;
  for (int tile0 = 0; tile0 < how.tiles; tile0 += how.per_wave) {
    const int n = min(how.per_wave, how.tiles - tile0);
    cfg.gridDim = dim3(C * n, L, 1);
    err = cudaLaunchKernelEx(
        &cfg, bwd_kernel<T, S, R, C, kStream>(), (const int*)a.seed, (const float*)a.gx0,
        (const float*)a.mask, (const S*)a.chain, (const S*)a.c_all, (const S*)a.h_all,
        (const float*)a.cinit, (const float*)a.hinit, (const T*)a.wz, (const T*)a.wh_sl,
        (const T*)a.pj_rows, (const float*)a.bias,
        (const float*)a.peep, a.forget_bias, a.keep_prob, a.residual,
        (const float*)a.dout, (const float*)a.dcfin, (const float*)a.dhfin, a.steps, L,
        a.batch, a.units, a.out_dim, (S*)a.dgates, (T*)a.outb_st, (T*)a.doutp_st,
        (float*)a.dcinit, (float*)a.dhinit, (float*)a.din, (float*)a.dc_in,
        (float*)a.dh_in, gxl, ring, cols, counters, tile0, how.tiles, how.lag, cap);
    if (err != cudaSuccess) return err;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = (cudaError_t)lstm_stack_wgrad(
      kBf16, kStoreBf16, a.chain, a.h_all,
      (const float*)a.hinit, a.dgates, a.pj_rows ? a.outb_st : nullptr, a.doutp_st,
      a.steps, L, a.batch, a.units, a.out_dim, a.dwz, a.dproj, wgrad, a.stream);
  if (err != cudaSuccess) return err;
  split_sum_kernel<<<cdiv(L * 7 * a.units, 256), 256, 0, a.stream>>>(
      cols, how.tiles, (size_t)L * 7 * a.units, (float*)a.dcols);
  return cudaGetLastError();
}

bool valid(const Args& a) {
  const int H = a.units, P = a.out_dim;
  return !(H <= 0 || P <= 0 || H % 4 || P % 4 || (!a.pj_rows && P != H));
}

// a bf16 launch of 16 blocks, streamed or resident
template <typename T, typename S>
cudaError_t run_rows(const Args& a, const Launch& how) {
  if (how.streamed) {
    switch (how.rows) {
      case 2: return run<T, S, 2, kWideCluster, true>(a, -1, how);
      case 4: return run<T, S, 4, kWideCluster, true>(a, -1, how);
      case 8: return run<T, S, 8, kWideCluster, true>(a, -1, how);
      default: return run<T, S, 16, kWideCluster, true>(a, -1, how);
    }
  }
  switch (how.rows) {
    case 2: return run<T, S, 2, kWideCluster, false>(a, -1, how);
    case 4: return run<T, S, 4, kWideCluster, false>(a, -1, how);
    case 8: return run<T, S, 8, kWideCluster, false>(a, -1, how);
    default: return run<T, S, 16, kWideCluster, false>(a, -1, how);
  }
}

template <typename T, typename S>
int launch(int device, const Args& a) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (a.batch <= 0 || a.steps <= 0 || a.layers <= 0) return cudaSuccess;
  if (!valid(a)) return cudaErrorInvalidValue;
  Launch how;
  err = choose<T, S>(a, &how);
  if (err != cudaSuccess) return err;
  if (!how.rows) return cudaErrorInvalidConfiguration;  // the layers not resident together
  if (how.blocks == kCluster) {
    switch (how.rows) {
      case 4: return run<T, S, 4, kCluster, false>(a, -1, how);
      case 6: return run<T, S, 6, kCluster, false>(a, -1, how);
      default: return run<T, S, 8, kCluster, false>(a, -1, how);
    }
  }
  if constexpr (multi_row<T>(kWideCluster)) {
    return run_rows<T, S>(a, how);
  } else {
    switch (how.rows) {
      case 2: return run<T, S, 2, kWideCluster, false>(a, -1, how);
      case 4: return run<T, S, 4, kWideCluster, false>(a, -1, how);
      case 6: return run<T, S, 6, kWideCluster, false>(a, -1, how);
      default: return run<T, S, 8, kWideCluster, false>(a, -1, how);
    }
  }
}

// A bf16 launch on the plan that `plan` names, at R = `rows`, for holding
// the plans against each other (chip_smoke.py): 1, the resident plan of
// this shape; 2, the streamed plan (16 blocks, which the shape's resident
// plan must have, so the dh partials are summed over the same blocks) with
// at most half of wh's steps resident, so that the ring streams wh too; 3,
// the same with every step of wh resident (refused where they do not all
// fit); 4, with as many resident as fit.
template <typename S>
int forced(int device, const Args& a, int plan, int rows) {
  typedef __nv_bfloat16 T;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (a.batch <= 0 || a.steps <= 0 || a.layers <= 0) return cudaSuccess;
  if (!valid(a)) return cudaErrorInvalidValue;
  const Route r = stack_route<T, S>(a.units, a.out_dim, a.pj_rows != nullptr);
  if (plan < 1 || plan > 4 || (plan == 1 && r.kind != kResident) ||
      (plan > 1 && r.blocks != kWideCluster))
    return cudaErrorInvalidConfiguration;
  const int cap = plan == 2 ? cdiv(a.out_dim, 16) / 2 : plan == 3 ? kAllHeld : -1;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch how = {};
  switch ((plan > 1) * 1000 + r.blocks * 16 + rows) {
#define CASE(ST, C, R)                                                                 \
  case ST * 1000 + C * 16 + R:                                                         \
    err = config<T, S, R, C, ST == 1>(a, cap, &cfg, attr, &how);                       \
    if (err == cudaSuccess && how.rows) return run<T, S, R, C, ST == 1>(a, cap, how);  \
    break;
    CASE(0, kCluster, 4) CASE(0, kCluster, 6) CASE(0, kCluster, 8)
    CASE(0, kWideCluster, 2) CASE(0, kWideCluster, 4) CASE(0, kWideCluster, 8)
    CASE(0, kWideCluster, 16) CASE(1, kWideCluster, 2) CASE(1, kWideCluster, 4)
    CASE(1, kWideCluster, 8) CASE(1, kWideCluster, 16)
#undef CASE
    default: break;
  }
  return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
}

}  // namespace

#define LSTM_STACK_BWD_ARGS                                                    \
  int device, const void *seed, const void *gx0, const void *mask,            \
      const void *chain, const void *c_all, const void *h_all,                \
      const void *cinit, const void *hinit, const void *wz,                   \
      const void *wh_sl, const void *pj_rows, const void *bias,               \
      const void *peep, float forget_bias, float keep_prob, int residual,     \
      const void *dout, const void *dcfin, const void *dhfin,   \
      int steps, int layers, int batch, int units, int out_dim,               \
      int store_bf16, void *dgates, void *outb_st, void *doutp_st,            \
      void *dcinit, void *dhinit, void *din, void *dc_in, void *dh_in,        \
      void *dwz, void *dproj, void *dcols, void *scratch, void *stream
#define LSTM_STACK_BWD_PACK                                                    \
  Args{seed, gx0, mask, chain, c_all, h_all, cinit, hinit, wz, wh_sl,        \
       pj_rows, bias, peep, forget_bias, keep_prob, residual, dout,    \
       dcfin, dhfin, steps, layers, batch, units, out_dim, dgates, outb_st,   \
       doutp_st, dcinit, dhinit, din, dc_in, dh_in, dwz, dproj, dcols,        \
       scratch, (cudaStream_t)stream}

extern "C" int lstm_stack_bwd_f32(LSTM_STACK_BWD_ARGS) {
  return store_bf16 ? launch<float, __nv_bfloat16>(device, LSTM_STACK_BWD_PACK)
                    : launch<float, float>(device, LSTM_STACK_BWD_PACK);
}

extern "C" int lstm_stack_bwd_bf16(LSTM_STACK_BWD_ARGS) {
  return store_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(device, LSTM_STACK_BWD_PACK)
                    : launch<__nv_bfloat16, float>(device, LSTM_STACK_BWD_PACK);
}

// lstm_stack_bwd_bf16 on a forced plan and R (`plan` 1 resident, 2-4
// streamed with half, all or as much of wh resident as fits; see
// `forced`): the slices laid out for the plan, with lstm_stack_bwd_fits's
// blocks
extern "C" int lstm_stack_bwd_bf16_forced(LSTM_STACK_BWD_ARGS, int plan, int rows) {
  return store_bf16 ? forced<__nv_bfloat16>(device, LSTM_STACK_BWD_PACK, plan, rows)
                    : forced<float>(device, LSTM_STACK_BWD_PACK, plan, rows);
}

// The blocks a cluster of K13's launch plan for this shape (8 or 16;
// negative for the streamed plan, whose weight rows are laid out padded),
// or 0 when K13 has none: host arithmetic only, no CUDA call.  The
// clusters the card holds at once, which config also asks, are not
// counted.
extern "C" int lstm_stack_bwd_fits(int units, int out_dim, int has_proj, int bf16,
                                   int store_bf16) {
  if (units <= 0 || out_dim <= 0 || units % 4 || out_dim % 4) return 0;
  using bf = __nv_bfloat16;
  const bool pj = has_proj != 0;
  Route r;
  if (bf16)
    r = store_bf16 ? stack_route<bf, bf>(units, out_dim, pj)
                   : stack_route<bf, float>(units, out_dim, pj);
  else
    r = store_bf16 ? stack_route<float, bf>(units, out_dim, pj)
                   : stack_route<float, float>(units, out_dim, pj);
  return r.kind == kStreamed ? -r.blocks : r.blocks;
}

// How K13 would launch on `device` at this shape: info = {blocks a
// cluster, rows a cluster, row tiles, tiles a wave, waves, lag K, shared
// memory bytes a block, clusters resident at once, streamed plan or not,
// weight bytes a block holds, weight bytes a block reads from L2 a step},
// and the scratch floats the launch needs; rows = 0 when the card cannot
// hold the stack's L clusters of a row tile together; a CUDA error if the
// shape has no plan.
extern "C" int lstm_stack_bwd_config(int device, int steps, int layers, int batch,
                                     int units, int out_dim, int has_proj, int bf16,
                                     int store_bf16, long long* info, long long* scratch) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args a = {};
  a.steps = steps;
  a.layers = layers;
  a.batch = batch;
  a.units = units;
  a.out_dim = out_dim;
  a.pj_rows = has_proj ? (const void*)1 : nullptr;
  Launch how = {};
  Scratch sc = {};
  using bf = __nv_bfloat16;
  if (bf16) {
    err = store_bf16 ? choose<bf, bf>(a, &how) : choose<bf, float>(a, &how);
    sc = scratch_of<bf>(a, how);
  } else {
    err = store_bf16 ? choose<float, bf>(a, &how) : choose<float, float>(a, &how);
    sc = scratch_of<float>(a, how);
  }
  if (err != cudaSuccess) return err;
  const long long v[11] = {how.blocks, how.rows, how.tiles, how.per_wave, how.waves,
                           how.lag, (long long)how.smem, how.resident, how.streamed,
                           how.held, how.streams};
  for (int i = 0; i < 11; ++i) info[i] = v[i];
  *scratch = (long long)(sc.gxl + sc.ring + sc.cols + sc.wgrad + sc.counters);
  return cudaSuccess;
}
