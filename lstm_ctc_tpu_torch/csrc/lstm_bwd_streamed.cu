// Kernel K2 on the streamed plan: one BLSTM layer's backward (bf16) where
// its weight slices fit no resident plan of lstm_bwd.cu (H = P = 1024
// without a projection: a block's wh slice is 528 KB; H = 2048 with P =
// 512), up to 2048 units (128 a block).
//
// Replaces, as lstm_bwd.cu does, the TPU kernel
// lstm_ctc_tpu/ops/lstm_pallas.py _make_bwd_kernel (:134-418), which keeps
// the whole wh in VMEM at any width.  The step, the cluster partition (C
// blocks a direction and row tile, block q owning units [q·US, (q+1)·US)
// and the P-slice [q·PS, (q+1)·PS)), the cell backward, the dh
// reduce-scatter over distributed shared memory and the weight-gradient
// pass after the recurrence (lstm_bwd_wgrad.cu) are lstm_bwd.cu's; see
// there.  What differs is where the weights come from: a block keeps the
// first k-rows of its wh slice in shared memory and streams the rest of
// wh, and all of its proj rows, from L2 at every step through
// lstm_cluster.cuh's ring of chunks (a bulk copy a chunk, completing on its
// slot's barrier; a slot refilled after the block barrier that ends its
// reads).
//
// What bounds it on the H100: a step needs the block's whole wh slice
// twice (h_prev·wh_q for the gate recompute, dgates·wh_qᵀ for dh_prev) and
// its proj rows once (dout_blk); streamed, the bytes a step come from L2,
// which the clusters resident together share (~516 KB a block at H = P =
// 1024).  So wh streams once a step, not twice: one pass over its chunks,
// by rows p, serves both products (lstm_cluster.cuh bwd_wh_pass).  A chunk
// of rows p holds every weight that dh_prev's columns p need (their whole
// depth, the 4·US gate columns), and a slice of the depth of the gate
// sums; so each pass gives the dh partial of this step complete chunk by
// chunk, and accumulates the gate sums of the step before over the chunks
// (its h_prev is loaded ahead, and does not depend on the carries).  The
// order of a step is therefore
//   1. the stashes of the owned P-slice; 2. dout_blk, over the streamed
//      proj rows, from dout_p, which the owners wrote at the end of the
//      step after;
//   3. the cell backward of the owned units, from the gate sums the last
//      pass left (gx included);
//   4. the step before's loads landed; the pass over wh: dh_prev's
//      partial of this step, written straight into the owners' inboxes,
//      and the gate sums of the step before;
//   5. after a cluster barrier each owner adds the C partials of its
//      P-slice in block order, updates its carry and writes the step
//      before's dout_p of it, rounded, into every block; a second cluster
//      barrier ends the inboxes' reads and makes dout_p whole.
// Every cluster streams its direction's whole slices a step whatever its
// rows, so a cluster takes as many rows as shared memory holds: a block
// keeps only what it owns (the carry dh and dout of its own P-slice, which
// without a projection is its units; gx read from L2 into the gate sums'
// init as a pass starts; h_prev copied straight into the A operand where
// the store dtype is bf16), as K13's streamed kernel does
// (lstm_stack_bwd.cu).  A cell-phase thread owns unit tid % US of rows tid /
// US, + 512 / US, .. (the unit's constants in registers, its peephole sums
// added over its rows in row order, then the threads' sums in row order),
// and past 8 rows the products' A operands are a whole 16-row tile.  The
// launcher tries R of {16, 8, 6, 4, 2} (16 on 16 blocks only: the 8-block
// plan, which chip_smoke.py forces at the flagship width, keeps one row a
// thread) and takes the fewest waves, then the fewest clusters (each
// streams whole slices), then the smallest R: at B = 32, R = 16 in one
// wave at H = P = 768-1024 and at 2048/512, R = 8 in two at H = P = 2048
// (whose inbox of 16 rows alone is 128 KB).
//
// The products are lstm_bwd.cu's on the tensor cores (mma.sync with each
// 16-deep step added in float32, mma_product_f32add's roles and k-slices),
// so a shape that fits both plans gives the same bits on both with the
// same blocks and R: dout_blk runs mma_f32add_tiles over each chunk of proj
// rows (its sums complete a chunk: the depth is P); two warps own each dh
// tile over its whole depth and each warp its gate tiles over the whole
// pass, adding their k-slices in slice order (the gate sums onto gx), as
// the resident plan's readers add its slice partials.  Each row's
// arithmetic is the same at any R, so dgates, the carries and the stashes
// are bit-equal across R; the peephole sums add a thread's rows first.
//
// Safety: the ring is the block's own, a slot refilled only after the
// block barrier that ends every read of its chunk, a chunk read only once
// its barrier's phase has completed; the gate sums are written at the end
// of step t's pass and read in step t-1's cell phase, with block barriers
// between; h_prev of step t-1 is copied into the A operand at the start of
// step t, after the pass of step t+1 (its last reader) ended in a block
// barrier; dout and c_prev are kept by step parity; a block writes into an
// owner's inbox only in the pass, between the cluster barrier that ended
// the owner's reads of the step after and the one before its reads of this
// step; dout_p is written between the two cluster barriers of a step, after
// every block's reads of it (phases 1-2) and before the next step's.

#include <type_traits>

#include "lstm_cluster.cuh"
#include "lstm_bwd_entry.cuh"

namespace {

typedef __nv_bfloat16 T;

// The streamed plan's shared memory with C blocks and R rows, common to host
// and device: lstm_bwd.cu's BwdPlan (US, U16, G, PW, P16, ND), the P-slice
// PS (its units without a projection), the A operands' rows arow (8, or 16
// past 8 rows), padded by 16 bytes; the buffers of the block's own slices:
// hq, dq (with a projection), gq [arow][·]; the carry's slice dh [R][PS];
// dout's slice [2][R][PS] and c_prev [2][R][US] by step parity; h_prev
// staged [R][P] where the store dtype is not bf16; keep and lengths [3][R];
// dc [R][US]; the inboxes [C][R][PS]; gsum [R][G] (the gate sums of the step
// before); one region of dout_blk's slices [slices][arow][ND] (the
// peephole sums [3][512 / US][US] at the end); the ring's barriers and
// slots, then wh's first `res` 16-deep steps (at most `cap` where cap >=
// 0).  LWS, LPJ: the row strides of wh's and proj's rows in shared memory,
// and in the padded layout the wrapper gives this plan (4·US and P16, each
// row padded by 16 bytes with zeros); wsteps, gsteps: 16-deep steps of P
// and of G; utiles: proj's 16-row tiles; cw, cu: the steps of wh and the
// tiles of proj a chunk; nw, np: chunks a pass; slots, slot: the ring.
struct BwdStreamPlan {
  int us, u16, g, ps, pw, p16, nd, arow, lda, ldg, lws, lpj;
  Split gates, dob, dh;
  int wsteps, gsteps, utiles, res, cw, cu, nw, np, slots;
  size_t slot, off_dq, off_gq, off_dh, off_dnx, off_hraw, off_craw, off_rows, off_dc,
      off_inbox, off_gsum, off_part, off_bar, off_ring, off_res, bytes;
  long long res_bytes, stream_bytes;
};

template <typename S>
__host__ __device__ BwdStreamPlan bwd_stream_plan(int H, int P, bool has_proj, int R, int C,
                                                  int cap) {
  BwdStreamPlan p;
  p.us = round_up(cdiv(H, C), 8);
  p.u16 = round_up(p.us, 16);
  p.g = 4 * p.us;
  // the resident plans' P-slices, whose k-split dh_prev's sums follow
  const int ps_res = round_up(cdiv(P, C), 4);
  p.ps = has_proj ? ps_res : p.us;
  p.pw = C * p.ps;
  p.p16 = round_up(P, 16);
  p.nd = p.u16;
  p.arow = R > 8 ? 16 : 8;
  const int pad = 8;
  p.lda = p.p16 + pad;
  p.ldg = p.g + pad;
  p.lws = p.g + pad;
  p.lpj = p.p16 + pad;
  // lstm_bwd.cu's splits (bwd_plan)
  p.gates = mma_split(p.g, p.p16, 2);
  p.dob = mma_split(p.nd, p.p16);
  p.dh = mma_split(C * ps_res, p.g, 2);
  p.wsteps = p.p16 / 16;
  p.gsteps = p.g / 16;
  p.utiles = has_proj ? p.u16 / 16 : 0;
  const size_t wrow = sizeof(T) * 16 * (size_t)p.lws, urow = sizeof(T) * 16 * (size_t)p.lpj;
  p.cw = kChunkBytes / wrow > 1 ? (int)(kChunkBytes / wrow) : 1;
  p.cu = !has_proj ? 0 : kChunkBytes / urow > 1 ? (int)(kChunkBytes / urow) : 1;
  p.slot = align128(p.cw * wrow > p.cu * urow ? p.cw * wrow : p.cu * urow);
  const size_t sums = (size_t)3 * (kThreads / p.us) * p.us;
  const size_t dob = has_proj ? (size_t)p.dob.slices * p.arow * p.nd : 0;
  const size_t part = dob > sums ? dob : sums;
  const size_t aq = align128(sizeof(T) * (size_t)p.arow * p.lda);
  p.off_dq = aq;
  p.off_gq = p.off_dq + (has_proj ? aq : 0);
  p.off_dh = p.off_gq + align128(sizeof(T) * (size_t)p.arow * p.ldg);
  p.off_dnx = p.off_dh + align128(sizeof(float) * (size_t)R * p.ps);
  p.off_hraw = p.off_dnx + align128(sizeof(float) * 2 * (size_t)R * p.ps);
  p.off_craw = p.off_hraw + (std::is_same<S, T>::value ? 0 : align128(sizeof(S) * (size_t)R * P));
  p.off_rows = p.off_craw + align128(sizeof(S) * 2 * (size_t)R * p.us);
  p.off_dc = p.off_rows + align128(sizeof(float) * 3 * (size_t)R);
  p.off_inbox = p.off_dc + align128(sizeof(float) * (size_t)R * p.us);
  p.off_gsum = p.off_inbox + align128(sizeof(float) * (size_t)C * R * p.ps);
  p.off_part = p.off_gsum + align128(sizeof(float) * (size_t)R * p.g);
  p.off_bar = p.off_part + align128(sizeof(float) * part);
  p.off_ring = p.off_bar + 128;
  const size_t left = kMaxSmemPerBlock > p.off_ring ? kMaxSmemPerBlock - p.off_ring : 0;
  p.slots = left / p.slot < (size_t)kMaxSlots ? (int)(left / p.slot) : kMaxSlots;
  p.off_res = p.off_ring + p.slots * p.slot;
  const int fit = (int)((left - p.slots * p.slot) / wrow);
  p.res = fit < p.wsteps ? fit : p.wsteps;
  if (cap >= 0 && cap < p.res) p.res = cap;
  p.nw = cdiv(p.wsteps - p.res, p.cw);
  p.np = has_proj ? cdiv(p.utiles, p.cu) : 0;
  p.bytes = p.off_res + p.res * wrow;
  p.res_bytes = (long long)p.res * 16 * p.g * sizeof(T);
  p.stream_bytes = (long long)(p.wsteps - p.res) * 16 * p.g * sizeof(T) +
                   (long long)p.utiles * 16 * p.p16 * sizeof(T);
  return p;
}

// at most kLayerUnits units a block, 16 rows, cell_rows(R) rows a
// cell-phase thread, two ring slots (and with cap = kAllHeld, every step of
// wh resident)
bool plan_fits(const BwdStreamPlan& p, int R, int cap) {
  return p.us <= kLayerUnits && R <= 16 && thread_rows(R, p.us) <= cell_rows(R) &&
         p.slots >= 2 && p.bytes <= kMaxSmemPerBlock && (cap != kAllHeld || p.res == p.wsteps);
}

// clock64 stamps of a step's phases (scripts/layer_stamps.py): where
// lstm_bwd_stamps has pointed this at a buffer of 1 + kStampPhases, thread 0
// of the first block of the first cluster adds each phase's cycles up in
// shared memory (beside the ring's barriers) and writes the steps and the
// sums there at its end: 1-2 (the stashes, dout_blk), 3 (the cell phase),
// 4 (the loads landed, the pass over wh), the first cluster barrier, 5
// (the owners' sums and dout_p), the second cluster barrier.  Null in
// every other launch.
__constant__ long long* c_bwd_stamps;

template <typename S, int R, int C>
__global__ void __launch_bounds__(kThreads, 1) lstm_bwd_streamed_kernel(
    const float* __restrict__ gx,     // [T, 2B, 4H]
    const int* __restrict__ lengths,  // [B]
    const float* __restrict__ keep,   // [T, B] or null
    const S* __restrict__ c_all,      // [T, 2B, H] store dtype
    const S* __restrict__ h_all,      // [T, 2B, P] store dtype
    const T* __restrict__ wh_sl,      // [2, C, P16, LWS]
    const T* __restrict__ pj_sl,      // [2, C, U16, LPJ] or null (P == H)
    const float* __restrict__ peep,   // [2, 3, H] or null
    float forget_bias,
    const float* __restrict__ dout,   // [T, 2B, P]
    const float* __restrict__ dcfin,  // [2B, H]
    const float* __restrict__ dhfin,  // [2B, P]
    int steps, int batch, int H, int P,
    S* __restrict__ dgates,           // [T, 2B, 4H]
    T* __restrict__ outb_st,          // [T, 2B, H] or null
    T* __restrict__ doutp_st,         // [T, 2B, P] or null
    float* __restrict__ dc_in,        // [T, 2B, H] or null
    float* __restrict__ dh_in,        // [T, 2B, P] or null
    float* __restrict__ peep_part,    // [tiles, 2, 3, H] or null
    int cap) {
  constexpr int kArow = R > 8 ? 16 : 8;  // the products' rows of A
  constexpr int kRows = cell_rows(R);    // a cell-phase thread's rows at most
  constexpr bool kStaged = !std::is_same<S, T>::value;  // h_prev staged, then rounded
  static_assert(R <= 16, "one 16-row tile of mma's A");
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int dir = blockIdx.y, tile = blockIdx.x / C, b0 = tile * R;
  const int nr = min(R, batch - b0);
  const bool has_proj = pj_sl != nullptr;
  const BwdStreamPlan pl = bwd_stream_plan<S>(H, P, has_proj, R, C, cap);
  const int US = pl.us, G = pl.g, PS = pl.ps, P16 = pl.p16, nd = pl.nd;
  const int u0 = q * US, nu = max(0, min(US, H - u0));
  const int p0 = q * PS, np = max(0, min(PS, P - p0));
  const int tid = threadIdx.x;
  const size_t frow = (size_t)dir * batch + b0;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* hq = reinterpret_cast<T*>(smem_raw);                  // [kArow][lda] h_prev
  T* dq = reinterpret_cast<T*>(smem_raw + pl.off_dq);      // [kArow][lda] dout_p (proj)
  T* gq = reinterpret_cast<T*>(smem_raw + pl.off_gq);      // [kArow][ldg] dgates
  float* dh = reinterpret_cast<float*>(smem_raw + pl.off_dh);    // [R][PS] the carry's slice
  float* dnx = reinterpret_cast<float*>(smem_raw + pl.off_dnx);  // [2][R][PS] dout's slice
  S* h_raw = reinterpret_cast<S*>(smem_raw + pl.off_hraw);       // [R][P] (kStaged)
  S* c_raw = reinterpret_cast<S*>(smem_raw + pl.off_craw);       // [2][R][US] c_prev
  float* keep_s = reinterpret_cast<float*>(smem_raw + pl.off_rows);  // [2][R]
  int* len_s = reinterpret_cast<int*>(keep_s + 2 * R);               // [R]
  float* dc = reinterpret_cast<float*>(smem_raw + pl.off_dc);        // [R][US]
  float* inbox = reinterpret_cast<float*>(smem_raw + pl.off_inbox);  // [C][R][PS]
  float* gsum = reinterpret_cast<float*>(smem_raw + pl.off_gsum);    // [R][G]
  float* part = reinterpret_cast<float*>(smem_raw + pl.off_part);    // dout_blk's slices
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + pl.off_bar);
  T* wres = reinterpret_cast<T*>(smem_raw + pl.off_res);
  const Ring ring{smem_raw + pl.off_ring, full, pl.slots, pl.slot};

  // the rows arrive padded as they lie in shared memory, so that a chunk
  // is one bulk copy
  const size_t slot = (size_t)dir * C + q;
  const T* wh_g = wh_sl + slot * (size_t)P16 * pl.lws;
  const T* pj_g = has_proj ? pj_sl + slot * (size_t)pl.u16 * pl.lpj : nullptr;
  const T zero = Dtype<T>::from_float(0.0f);
  copy_rows(wres, pl.lws, wh_g, pl.lws, 16 * pl.res);
  for (int i = tid; i < kArow * pl.lda; i += kThreads) {
    hq[i] = zero;
    if (has_proj) dq[i] = zero;
  }
  for (int i = tid; i < kArow * pl.ldg; i += kThreads) gq[i] = zero;
  for (int i = tid; i < R * PS; i += kThreads) {
    const int r = i / PS, c = i - r * PS;
    dh[i] = r < nr && c < np ? dhfin[(frow + r) * P + p0 + c] : 0.0f;
  }
  for (int i = tid; i < R * US; i += kThreads) {
    const int r = i / US, j = i - r * US;
    dc[i] = r < nr && j < nu ? dcfin[(frow + r) * H + u0 + j] : 0.0f;
  }
  if (tid < R) len_s[tid] = tid < nr ? lengths[b0 + tid] : 0;
  if (tid == 0) {
    for (int i = 0; i < pl.slots; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
  }

  // the cell phase: thread tid owns unit jb of rows rb0, rb0 + RS, .. below
  // nr (kRows at most)
  const int RS = kThreads / US, rb0 = tid / US, jb = tid - rb0 * US;
  const bool in_b = rb0 < RS, own_u = jb < nu;
  const int ub = u0 + jb;
  const float* pd = peep ? peep + (size_t)dir * 3 * H : nullptr;
  // the peephole sums over dgates as stored of the thread's rows, in row
  // order
  float sum_i = 0.0f, sum_f = 0.0f, sum_o = 0.0f;

  // What step tt reads that no carry feeds, a step ahead by cp.async (4
  // elements a copy): dout of the owned P-slice, the previous h (straight
  // into hq where the store dtype is bf16) and the owned units' previous c
  // (zero at tt = 0), and keep(tt), which land_step stores; then h_prev is
  // kept (times keep(tt)) and rounded into hq
  float keep_next = 1.0f;  // thread r < nr: row r's keep at the step fetched
  auto fetch_step = [&](int tt) {
    const size_t r0 = (size_t)tt * 2 * batch + frow, rp = r0 - 2 * (size_t)batch;
    if (keep && tid < nr) keep_next = keep[(size_t)tt * batch + b0 + tid];
    float* dn = dnx + (size_t)(tt & 1) * R * PS;
    const int cq = np / 4;
    for (int i = tid; i < nr * cq; i += kThreads) {
      const int r = i / cq, c = 4 * (i - r * cq);
      cp_async4(dn + r * PS + c, dout + (r0 + r) * P + p0 + c);
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
        for (int e = 0; e < 4; ++e) dst[e] = Dtype<S>::from_float(0.0f);
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
        for (int e = 0; e < 4; ++e) cn[r * US + j + e] = Dtype<S>::from_float(0.0f);
      }
    }
    cp_async_commit();
  };
  auto land_step = [&](int tt) {
    cp_async_wait_all();
    if (tid < nr) keep_s[(tt & 1) * R + tid] = keep_next;
    __syncthreads();
    if (kStaged || keep) {
      const float* kps = keep_s + (tt & 1) * R;
      for (int i = tid; i < nr * P; i += kThreads) {
        const int r = i / P, p = i - r * P;
        T* a = hq + r * pl.lda + p;
        if constexpr (kStaged)
          *a = Dtype<T>::from_float(kps[r] * ld(h_raw, (size_t)r * P + p));
        else if (kps[r] != 1.0f)
          *a = Dtype<T>::from_float(kps[r] * ld(a, 0));
      }
      __syncthreads();
    }
  };

  // The chunk sequence: wh's streamed rows for the first gate sums, then a
  // step at a time proj's rows and wh's streamed rows (one thread issues
  // each).
  const int per_step = pl.np + pl.nw, total = pl.nw + steps * per_step;
  auto issue = [&](int n) {
    const int i = n < pl.nw ? pl.np + n : (n - pl.nw) % per_step;
    if (i < pl.np) {
      const int r0 = 16 * i * pl.cu, rows = min(16 * pl.cu, pl.u16 - r0);
      ring.issue(n, pj_g + (size_t)r0 * pl.lpj, sizeof(T) * rows * pl.lpj);
    } else {
      const int r0 = 16 * (pl.res + (i - pl.np) * pl.cw), rows = min(16 * pl.cw, P16 - r0);
      ring.issue(n, wh_g + (size_t)r0 * pl.lws, sizeof(T) * rows * pl.lws);
    }
  };
  int chunk = 0;  // the next chunk to read

  // 4. the pass over wh's rows: this step's partial dh_prev = dgates_q ·
  // wh_qᵀ straight into the owners' inboxes (with dh_on; inbox[q] of the
  // owner of each P-slice), and the gate sums of step tt >= 0 (gx + h_prev
  // · wh_q, gx read from L2 as the pass starts) into gsum
  auto wh_pass = [&](bool dh_on, int tt) {
    bwd_wh_pass<kArow, false>(
        dh_on, tt >= 0, hq, pl.lda, gq, pl.ldg, G, pl.wsteps, pl.gsteps, pl.gates, pl.dh, wres,
        pl.lws, pl.res, ring, pl.cw, chunk, total, issue,
        [&](int r, int c) {
          const int k = c / US, j = c - k * US;
          return r < nr && j < nu
                     ? __ldg(gx + ((size_t)tt * 2 * batch + frow + r) * 4 * H + k * H + u0 + j)
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
  // slice v, rounded, into every block's dq (the A operand of dout_blk)
  auto share_dq = [&](int tt, int r, int c, const float (&v)[4]) {
    const float m = tt < len_s[r] ? 1.0f : 0.0f;
    __align__(8) T x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = Dtype<T>::from_float(m * (dnx[((tt & 1) * R + r) * PS + c + e] + v[e]));
    const uint2 word = *reinterpret_cast<const uint2*>(x);
    for (int b = 0; b < C; ++b)
      *reinterpret_cast<uint2*>(cluster.map_shared_rank(dq, b) + r * pl.lda + p0 + c) = word;
  };

  // the stamps (c_bwd_stamps), beside the ring's barriers (at most
  // kMaxSlots of the region's 128 bytes)
  long long* const stamps = c_bwd_stamps;
  const bool stamp = stamps != nullptr && tid == 0 && blockIdx.x == 0 && dir == 0;
  long long* const phase_sum = reinterpret_cast<long long*>(smem_raw + pl.off_bar + 64);
  long long clk = 0;
  auto mark = [&](int k) {
    if (stamp) {
      const long long now = clock64();
      phase_sum[k] += now - clk;
      clk = now;
    }
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
  if (stamp) {
    for (int k = 0; k < kStampPhases; ++k) phase_sum[k] = 0;
    clk = clock64();
  }

  for (int t = steps - 1; t >= 0; --t) {
    const size_t row0 = (size_t)t * 2 * batch + frow;
    if (t > 0) fetch_step(t - 1);

    // 1. the stashes of the owned P-slice
    for (int i = tid; i < nr * np; i += kThreads) {
      const int r = i / np, c = i - r * np, p = p0 + c;
      if (has_proj && doutp_st) doutp_st[(row0 + r) * P + p] = dq[r * pl.lda + p];
      if (dh_in) dh_in[(row0 + r) * P + p] = dh[r * PS + c];
    }

    // 2. dout_blk of the owned units, over proj's chunks of rows
    if (has_proj)
      bwd_dob_pass<kArow>(dq, pl.lda, P16, ring, pl.lpj, pl.np, pl.cu, pl.utiles, pl.dob, part, nd,
                          chunk, total, issue);
    mark(0);

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
        const float m = t < len_s[rb] ? 1.0f : 0.0f;
        const float kp = keep_s[(t & 1) * R + rb];
        const float c0 = kp * ld(c_raw, ((size_t)(t & 1) * R + rb) * US + jb);
        // the resident plan's statements in their order, as written there:
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
          // PS = US: the unit's column
          db = m * (dnx[((t & 1) * R + rb) * PS + jb] + dh[rb * PS + jb]);
        }
        const int ib = rb * US + jb;
        const float dcv = dc[ib];
        if (dc_in) dc_in[(row0 + rb) * H + ub] = dcv;
        const float d_o = db * tc * so * (1.0f - so);
        const float dcn = db * so * (1.0f - tc * tc) + m * dcv + d_o * po;
        const float d_f = dcn * c0 * sf * (1.0f - sf);
        const float d_i = dcn * tj * si * (1.0f - si);
        const float d_j = dcn * si * (1.0f - tj * tj);
        dc[ib] = kp * (dcn * sf + (1.0f - m) * dcv + d_f * pf + d_i * pi);
        dgv[0] = d_i;
        dgv[1] = d_j;
        dgv[2] = d_f;
        dgv[3] = d_o;
        S* dg_row = dgates + (row0 + rb) * 4 * H;
        float stored[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const S v = Dtype<S>::from_float(dgv[k]);
          dg_row[k * H + ub] = v;
          stored[k] = Dtype<S>::to_float(v);
        }
        sum_i = fmaf(stored[0], c0, sum_i);
        sum_f = fmaf(stored[2], c0, sum_f);
        sum_o = fmaf(stored[3], cn, sum_o);
        if (outb_st) outb_st[(row0 + rb) * H + ub] = Dtype<T>::from_float(so * tc);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) gq[rb * pl.ldg + k * US + jb] = Dtype<T>::from_float(dgv[k]);
    }
    __syncthreads();
    mark(1);

    // 4. the step before's loads, then one pass over wh: dh_prev's partials
    // into the owners' inboxes, the step before's gate sums
    if (t > 0) land_step(t - 1);
    wh_pass(true, t - 1);
    mark(2);
    cluster.sync();  // every inbox complete, every read of dq done
    mark(3);

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
      const float m = t < len_s[r] ? 1.0f : 0.0f;
      const float kp = keep_s[(t & 1) * R + r];
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = kp * ((1.0f - m) * dh[r * PS + c + e] + s[e]);
        dh[r * PS + c + e] = v[e];
      }
      if (has_proj && t > 0) share_dq(t - 1, r, c, v);
    }
    mark(4);
    cluster.sync();
    mark(5);
  }
  if (stamp) {
    stamps[0] = steps;
    for (int k = 0; k < kStampPhases; ++k) stamps[1 + k] = phase_sum[k];
  }

  // this row tile's peephole sums: each thread's rows, then the threads' in
  // row order
  if (peep_part) {
    float* st = part;  // [3][RS][US]
    if (in_b) {
      st[(0 * RS + rb0) * US + jb] = sum_i;
      st[(1 * RS + rb0) * US + jb] = sum_f;
      st[(2 * RS + rb0) * US + jb] = sum_o;
    }
    __syncthreads();
    float* out = peep_part + (size_t)(tile * 2 + dir) * 3 * H;
    const int rows = min(RS, nr);
    for (int i = tid; i < 3 * nu; i += kThreads) {
      const int k = i / nu, j = i - k * nu;
      float v = 0.0f;
      for (int r = 0; r < rows; ++r) v += st[(k * RS + r) * US + j];
      out[k * H + u0 + j] = v;
    }
  }
}

// The launch with R rows a cluster if its plan fits and at least one
// cluster is resident: planned into `how` (rows = 0: not with this R), and
// launched unless `dry`
template <typename S, int R, int C>
cudaError_t launch_rows(const LstmBwdArgs& a, int cap, bool dry, float* peep_part,
                        LstmBwdLaunch* how) {
  how->rows = 0;
  const BwdStreamPlan pl =
      bwd_stream_plan<S>(a.units, a.out_dim, a.proj_rows != nullptr, R, C, cap);
  if (!plan_fits(pl, R, cap)) return cudaSuccess;
  auto kernel = lstm_bwd_streamed_kernel<S, R, C>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int fit;
  cudaError_t err = cluster_config(kernel, a.batch, R, C, pl.bytes, a.stream, &cfg, attr, &fit);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaSuccess;
  *how = LstmBwdLaunch{C, R, 2 * cdiv(a.batch, R), fit, pl.bytes, pl.res_bytes, pl.stream_bytes};
  if (dry) return cudaSuccess;
  err = cudaLaunchKernelEx(
      &cfg, kernel, (const float*)a.gx, (const int*)a.lengths, (const float*)a.keep,
      (const S*)a.c_all, (const S*)a.h_all, (const T*)a.wh_sl, (const T*)a.proj_rows,
      (const float*)a.peep, a.forget_bias, (const float*)a.dout, (const float*)a.dcfin,
      (const float*)a.dhfin, a.steps, a.batch, a.units, a.out_dim, (S*)a.dgates,
      (T*)a.outb_st, (T*)a.doutp_st, (float*)a.dc_in, (float*)a.dh_in, peep_part, cap);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename S, int C>
cudaError_t launch_at(const LstmBwdArgs& a, int rows, int cap, bool dry, float* peep_part,
                      LstmBwdLaunch* how) {
  switch (rows) {
    case 2: return launch_rows<S, 2, C>(a, cap, dry, peep_part, how);
    case 4: return launch_rows<S, 4, C>(a, cap, dry, peep_part, how);
    case 6: return launch_rows<S, 6, C>(a, cap, dry, peep_part, how);
    case 8: return launch_rows<S, 8, C>(a, cap, dry, peep_part, how);
    case 16:
      if constexpr (C == kWideCluster) return launch_rows<S, 16, C>(a, cap, dry, peep_part, how);
      break;
    default:
      break;
  }
  how->rows = 0;
  return cudaSuccess;
}

// R given, or (rows = 0) the R of {2, 4, 6, 8, 16} (16 with 16 blocks) with
// the fewest waves, then the fewest clusters (every cluster streams the
// whole slices a step), then the smallest
template <typename S, int C>
cudaError_t launch_plan(const LstmBwdArgs& a, int rows, int cap, bool dry, float* peep_part,
                        LstmBwdLaunch* how) {
  cudaError_t err;
  if (rows == 0) {
    LstmBwdLaunch best{0, 0, 0, 0, 0, 0, 0}, c;
    for (int r : {2, 4, 6, 8, 16}) {
      err = launch_at<S, C>(a, r, cap, true, peep_part, &c);
      if (err != cudaSuccess) return err;
      if (!c.rows) continue;
      const int waves = cdiv(c.clusters, c.resident);
      if (!best.rows || waves < cdiv(best.clusters, best.resident) ||
          (waves == cdiv(best.clusters, best.resident) && c.clusters < best.clusters))
        best = c;
    }
    rows = best.rows;
  }
  err = launch_at<S, C>(a, rows, cap, dry, peep_part, how);
  if (err == cudaSuccess && !how->rows) return cudaErrorInvalidConfiguration;
  return err;
}

}  // namespace

bool lstm_bwd_streamed_fits(int units, int out_dim, bool has_proj, bool store_bf16, int C,
                            int rows, int cap) {
  return store_bf16
      ? plan_fits(bwd_stream_plan<__nv_bfloat16>(units, out_dim, has_proj, rows, C, cap), rows, cap)
      : plan_fits(bwd_stream_plan<float>(units, out_dim, has_proj, rows, C, cap), rows, cap);
}

// Point the streamed kernel's stamps at `stamps` (null: none)
extern "C" int lstm_bwd_stamps(void* stamps) {
  return cudaMemcpyToSymbol(c_bwd_stamps, &stamps, sizeof(stamps));
}

cudaError_t lstm_bwd_streamed(const LstmBwdArgs& a, bool store_bf16, int C, int rows, int cap,
                              bool dry, float* peep_part, LstmBwdLaunch* how) {
  *how = LstmBwdLaunch{0, 0, 0, 0, 0, 0, 0};
  if (C == kCluster)
    return store_bf16 ? launch_plan<__nv_bfloat16, kCluster>(a, rows, cap, dry, peep_part, how)
                      : launch_plan<float, kCluster>(a, rows, cap, dry, peep_part, how);
  if (C == kWideCluster)
    return store_bf16 ? launch_plan<__nv_bfloat16, kWideCluster>(a, rows, cap, dry, peep_part, how)
                      : launch_plan<float, kWideCluster>(a, rows, cap, dry, peep_part, how);
  return cudaErrorInvalidConfiguration;
}
