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
// input side taken off the recurrence.  One 8-block cluster per (layer l,
// tile of R batch rows); block q owns hidden units [q·US, (q+1)·US) and
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
//      eight in block order and all-gathers the new dh (two cluster barriers
//      a step).  The gate recompute of the step before runs between the
//      halves of the first barrier, and that step's loads are staged by
//      cp.async a step ahead.  In bf16 the products run on the tensor cores
//      with float32 adds of each 16-deep step (mma_product_f32add).
//   2. Every K steps (the lag) a layer l >= 1 adds dgates·wx_lᵀ of those
//      steps to din (which step 1 has set to residual_l·dchain): each block
//      its P-slice, its rows of dgates (a compute-dtype ring, written by all
//      eight blocks) and wx_l read from L2 straight into tensor-core
//      fragments; then each block counts the steps whose din it has
//      finished (a fence, then an atomic store).
// So the layers run as a pipeline, as the reverse wavefront does: layer l-1
// stages dchain of step s (layer l's din at s+1) from L2 once layer l's eight
// blocks have counted it, and lags layer l by about K steps; the sequential
// chain is about S + (L-1)·K steps.  A layer waits only on the layer above,
// and all L clusters of a row tile must be resident together: the launcher
// takes R from {4, 6, 8} and as many row tiles a launch (a wave) as the
// occupancy API says are resident for all L layers at once, the fewest
// waves first, then the smallest R (B = 32, L = 4: R = 6, three tiles a
// wave, two waves); a wait of seconds traps rather than hang.  K = max(2,
// min(8, ceil(S / 16))).  In float32 the products are FMA and the slices are
// read from L2.

#include <type_traits>

#include "lstm_cluster.cuh"
#include "lstm_bwd_entry.cuh"

namespace {

template <typename X>
__device__ __forceinline__ float rnd(float v) {
  return Dtype<X>::to_float(Dtype<X>::from_float(v));
}

// Shared-memory plan, common to host and device: K2's (lstm_bwd.cu
// bwd_plan), with each row's mask in place of K2's keep and length, room
// for the seven column sums of a row tile, and (float32, whose slices stay
// in L2) the rows of din's product staged where bf16 keeps its slices.
struct StackPlan {
  int us, u16, g, ps, pw, p16, nd, wrows, arow, prow, lda, ldg, lwh, lpj, lin;
  Split gates, dob, dh;
  size_t off_dq, off_gq, off_dh, off_dnx, off_dnx2, off_hraw, off_craw, off_gxs,
      off_rows, off_dc, off_inbox, off_part, off_wh, off_pj, bytes;
};

template <typename T, typename S>
__host__ __device__ StackPlan stack_plan(int H, int P, bool has_proj, int R) {
  StackPlan p;
  p.us = round_up(cdiv(H, kCluster), 8);
  p.u16 = round_up(p.us, 16);
  p.g = 4 * p.us;
  p.ps = round_up(cdiv(P, kCluster), 4);
  p.pw = kCluster * p.ps;
  p.p16 = round_up(P, 16);
  p.nd = kMma<T> ? p.u16 : p.us;
  p.wrows = p.p16 > p.pw ? p.p16 : p.pw;
  const int pad = 16 / (int)sizeof(T);
  p.arow = kMma<T> ? 16 : R;
  p.prow = kMma<T> ? 8 : R;
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
  p.off_part = p.off_inbox + align128(sizeof(float) * (size_t)kCluster * R * p.ps);
  p.off_wh = p.off_part + align128(sizeof(float) * part);
  p.off_pj = p.off_wh + (kMma<T> ? align128(sizeof(T) * (size_t)p.wrows * p.lwh) : 0);
  const size_t end = p.off_pj + (kMma<T> && has_proj ? align128(sizeof(T) * (size_t)p.u16 * p.lpj) : 0);
  const size_t staged = p.off_wh + align128(sizeof(T) * (size_t)kStage * p.lin);
  p.bytes = end > staged ? end : staged;
  return p;
}

// T: the compute dtype (bf16: the products on the tensor cores, the slices
// in shared memory; float32: FMA, the slices read from L2); S: the store
// dtype
template <typename T, typename S, int R>
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
    const T* __restrict__ wh_sl,      // [L, 8, P16, 4, US]
    const T* __restrict__ pj_sl,      // [L, 8, U16, P16] or null (P == H)
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
    int* __restrict__ counters,       // [L, tiles, 8], zero at the first wave
    int tile0, int tiles, int lag) {
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int l = layers - 1 - (int)blockIdx.y;  // the layers above come first
  const int tile = tile0 + blockIdx.x / kCluster, b0 = tile * R;
  const int nr = min(R, batch - b0);
  const bool has_proj = pj_sl != nullptr;
  const StackPlan pl = stack_plan<T, S>(H, P, has_proj, R);
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
  float* inbox = reinterpret_cast<float*>(smem_raw + pl.off_inbox);  // [8][R][PS]
  float* part = reinterpret_cast<float*>(smem_raw + pl.off_part);
  float* part_d = part + (size_t)pl.gates.slices * prow * G;
  T* wh_s = reinterpret_cast<T*>(smem_raw + pl.off_wh);
  T* pj_s = reinterpret_cast<T*>(smem_raw + pl.off_pj);
  T* in_s = wh_s;  // float32: din's staged rows (no slices in shared memory)

  const size_t slot = (size_t)l * kCluster + q;
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
  int* const above = last ? nullptr : counters + ((size_t)(l + 1) * tiles + tile) * kCluster;
  int* const mine = counters + ((size_t)l * tiles + tile) * kCluster + q;
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
  int seen = 0;            // thread q < 8: the count last read of block q above
  auto fetch_step = [&](int tt) {
    if (!last && tt + 1 < steps) wait_blocks(above, steps - 1 - tt, seen);
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
  // din of this block's P-slice += dgates·wx_lᵀ over steps t0 .. t0+cnt-1
  auto din_product = [&](int t0, int cnt) {
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
      constexpr int kPiece = 64;
      float* as = reinterpret_cast<float*>(in_s);
      const int most = min(kCluster * (kThreads / max(np, 1)), kStage * pl.lin / kPiece / 8 * 8);
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
        const float4 w = *reinterpret_cast<const float4*>(part_h + ((size_t)s * prow + r) * PW + p);
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

    // 5b. the eight partials of the owned slice, in block order; the carry
    // update; the new slice into every block
    const int squads = PS / 4;
    for (int i = tid; i < nr * squads; i += kThreads) {
      const int r = i / squads, c = 4 * (i - r * squads), p = p0 + c;
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int b = 0; b < kCluster; ++b) {
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
      for (int b = 0; b < kCluster; ++b)
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

// How K13 launches: rows a cluster, row tiles, tiles a wave, waves, the
// lag K, dynamic shared memory a block (rows = 0: not with this R).
struct Launch {
  int rows, tiles, per_wave, waves, lag;
  size_t smem;
};

__host__ int lag_of(int steps) {
  const int k = cdiv(steps, 16);
  return k < 2 ? 2 : (k > 8 ? 8 : k);
}

// The scratch floats: gxl [L-1, S, B, 4H], the dgates ring [L, 2K, B, 4H]
// (compute dtype), the column sums [tiles, L, 7H], the weight-gradient
// products', and the counters [L, tiles, 8] (int32).
struct Scratch {
  size_t gxl, ring, cols, wgrad, counters;
};

template <typename T>
__host__ Scratch scratch_of(const Args& a, const Launch& how) {
  Scratch s;
  const size_t H4 = 4 * (size_t)a.units;
  s.gxl = (size_t)(a.layers - 1) * a.steps * a.batch * H4;
  s.ring = ((size_t)a.layers * 2 * how.lag * a.batch * H4 * sizeof(T) + 15) / 16 * 4;
  s.cols = (size_t)how.tiles * a.layers * 7 * a.units;
  s.wgrad = (size_t)lstm_stack_wgrad_scratch_floats(a.steps, a.layers, a.batch, a.units,
                                                    a.out_dim);
  s.counters = (size_t)a.layers * how.tiles * kCluster;
  return s;
}

// Whether a block of R rows a cluster fits this shape: its slices' threads
// and its shared memory within a block's.  Host arithmetic only.
template <typename T, typename S, int R>
__host__ bool fits(int units, int out_dim, bool has_proj) {
  const StackPlan pl = stack_plan<T, S>(units, out_dim, has_proj, R);
  return R * pl.us <= kThreads && pl.bytes <= kMaxSmemPerBlock;
}

template <typename T, typename S>
__host__ bool fits_any(int units, int out_dim, bool has_proj) {
  return fits<T, S, 4>(units, out_dim, has_proj) || fits<T, S, 6>(units, out_dim, has_proj) ||
         fits<T, S, 8>(units, out_dim, has_proj);
}

template <typename T, typename S, int R>
cudaError_t config(const Args& a, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                   Launch* how) {
  how->rows = 0;
  const bool has_proj = a.pj_rows != nullptr;
  if (!fits<T, S, R>(a.units, a.out_dim, has_proj)) return cudaSuccess;
  const StackPlan pl = stack_plan<T, S>(a.units, a.out_dim, has_proj, R);
  auto kernel = stack_bwd_kernel<T, S, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.bytes);
  if (err != cudaSuccess) return err;
  const int tiles = cdiv(a.batch, R);
  *cfg = {};
  cfg->gridDim = dim3(kCluster, a.layers, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = pl.bytes;
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
  how->smem = pl.bytes;
  return cudaSuccess;
}

// The R of {4, 6, 8} with the fewest waves, then the smallest; no R: the
// launch is refused (bf16 slices wider than shared memory, as K2's).
template <typename T, typename S>
cudaError_t choose(const Args& a, Launch* how) {
  how->rows = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch c;
  cudaError_t err;
#define TRY(R)                                                          \
  err = config<T, S, R>(a, &cfg, attr, &c);                             \
  if (err != cudaSuccess) return err;                                   \
  if (c.rows && (!how->rows || c.waves < how->waves)) *how = c;
  TRY(4) TRY(6) TRY(8)
#undef TRY
  return how->rows ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename T, typename S, int R>
cudaError_t run(const Args& a, const Launch& how) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch again;
  cudaError_t err = config<T, S, R>(a, &cfg, attr, &again);
  if (err != cudaSuccess) return err;
  const int L = a.layers;
  const Scratch sc = scratch_of<T>(a, how);
  float* gxl = (float*)a.scratch;
  T* ring = (T*)(gxl + sc.gxl);
  float* cols = gxl + sc.gxl + sc.ring;
  float* wgrad = cols + sc.cols;
  int* counters = (int*)(wgrad + sc.wgrad);
  err = cudaMemsetAsync(counters, 0, sizeof(int) * sc.counters, a.stream);
  if (err != cudaSuccess) return err;
  constexpr bool kBf16 = kMma<T>;
  constexpr bool kStoreBf16 = std::is_same<S, __nv_bfloat16>::value;
  err = (cudaError_t)lstm_stack_gate_inputs(kBf16, kStoreBf16, a.chain, a.wz, a.steps, L,
                                            a.batch, a.units, a.out_dim, gxl, a.stream);
  if (err != cudaSuccess) return err;
  for (int tile0 = 0; tile0 < how.tiles; tile0 += how.per_wave) {
    const int n = min(how.per_wave, how.tiles - tile0);
    cfg.gridDim = dim3(kCluster * n, L, 1);
    err = cudaLaunchKernelEx(
        &cfg, stack_bwd_kernel<T, S, R>, (const int*)a.seed, (const float*)a.gx0,
        (const float*)a.mask, (const S*)a.chain, (const S*)a.c_all, (const S*)a.h_all,
        (const float*)a.cinit, (const float*)a.hinit, (const T*)a.wz, (const T*)a.wh_sl, (const T*)a.pj_rows, (const float*)a.bias,
        (const float*)a.peep, a.forget_bias, a.keep_prob, a.residual,
        (const float*)a.dout, (const float*)a.dcfin, (const float*)a.dhfin, a.steps, L,
        a.batch, a.units, a.out_dim, (S*)a.dgates, (T*)a.outb_st, (T*)a.doutp_st,
        (float*)a.dcinit, (float*)a.dhinit, (float*)a.din, (float*)a.dc_in,
        (float*)a.dh_in, gxl, ring, cols, counters, tile0, how.tiles, how.lag);
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

template <typename T, typename S>
int launch(int device, const Args& a) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int H = a.units, P = a.out_dim;
  if (a.batch <= 0 || a.steps <= 0 || a.layers <= 0) return cudaSuccess;
  if (H <= 0 || P <= 0 || H % 4 || P % 4 || (!a.pj_rows && P != H))
    return cudaErrorInvalidValue;
  Launch how;
  err = choose<T, S>(a, &how);
  if (err != cudaSuccess) return err;
  switch (how.rows) {
    case 4: return run<T, S, 4>(a, how);
    case 6: return run<T, S, 6>(a, how);
    default: return run<T, S, 8>(a, how);
  }
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

// Whether K13 has a launch plan for this shape (1) or not (0): some R of
// choose's whose block fits, host arithmetic only, no CUDA call.  The
// clusters the card holds at once, which config also asks, are not counted.
extern "C" int lstm_stack_bwd_fits(int units, int out_dim, int has_proj, int bf16,
                                   int store_bf16) {
  if (units <= 0 || out_dim <= 0 || units % 4 || out_dim % 4) return 0;
  using bf = __nv_bfloat16;
  const bool pj = has_proj != 0;
  if (bf16)
    return store_bf16 ? fits_any<bf, bf>(units, out_dim, pj) : fits_any<bf, float>(units, out_dim, pj);
  return store_bf16 ? fits_any<float, bf>(units, out_dim, pj) : fits_any<float, float>(units, out_dim, pj);
}

// How K13 would launch on `device` at this shape: info = {rows a cluster,
// row tiles, tiles a wave, waves, lag K, shared memory bytes a block}, and
// the scratch floats the launch needs; a CUDA error if it cannot.
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
  const long long v[6] = {how.rows, how.tiles, how.per_wave, how.waves, how.lag,
                          (long long)how.smem};
  for (int i = 0; i < 6; ++i) info[i] = v[i];
  *scratch = (long long)(sc.gxl + sc.ring + sc.cols + sc.wgrad + sc.counters);
  return cudaSuccess;
}
