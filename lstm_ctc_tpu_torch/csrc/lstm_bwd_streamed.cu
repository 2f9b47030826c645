// Kernel K2 on the streamed plan: one BLSTM layer's backward (bf16) where
// its weight slices fit no resident plan of lstm_bwd.cu (H = P = 1024
// without a projection: a block's wh slice is 528 KB; H = 2048 with P =
// 512), up to 2048 units (128 a block).
//
// Replaces, as lstm_bwd.cu does, the TPU kernel
// lstm_ctc_tpu/ops/lstm_pallas.py _make_bwd_kernel (:134-418), which keeps
// the whole wh in VMEM at any width.  The step, the cluster partition (C
// blocks a direction and row tile, block q owning units [q·US, (q+1)·US)),
// the cell backward, the dh reduce-scatter over distributed shared memory
// and the weight-gradient pass after the recurrence (lstm_bwd_wgrad.cu) are
// lstm_bwd.cu's; see there.  What differs is where the weights come from:
// a block keeps the first k-rows of its wh slice in shared memory and
// streams the rest of wh, and all of its proj rows, from L2 at every step
// through lstm_cluster.cuh's ring of chunks (a bulk copy a chunk,
// completing on its slot's barrier; a slot refilled after the block
// barrier that ends its reads).
//
// What bounds it on the H100: a step needs the block's whole wh slice
// twice (h_prev·wh_q for the gate recompute, dgates·wh_qᵀ for dh_prev) and
// its proj rows once (dout_blk); streamed, the bytes a step come from L2,
// which the clusters resident together share (~528 KB a block at H = P =
// 1024).  So wh streams once a step, not twice: one pass over its chunks,
// by rows p, serves both products.  A chunk of rows p holds every weight
// that dh_prev's columns p need (their whole depth, the 4·US gate
// columns), and a slice of the depth of the gate sums; so each pass gives
// the dh partial of this step complete chunk by chunk, and accumulates the
// gate sums of the step before over the chunks (its h_prev is staged, and
// does not depend on the carries).  The order of a step is therefore
//   1. dout_p; 2. dout_blk, over the streamed proj rows;
//   3. the cell backward of the owned units, from the gate sums the last
//      pass left (gx included); 3b. the staged loads of the step before;
//   4. the pass over wh: dh_prev's partial of this step, the gate sums of
//      the step before;
//   5. the reduce-scatter and the all-gather of dh, as lstm_bwd.cu's.
// The gate recompute thus runs before the cluster barrier instead of
// between its halves; the next step's first chunks land during 5, 1 and 3.
// The products are lstm_bwd.cu's on the tensor cores (mma.sync with each
// 16-deep step added in float32, mma_product_f32add's roles and k-slices),
// so a shape that fits both plans gives the same bits on both with the
// same blocks and R: dout_blk runs mma_f32add_tiles over each chunk of
// proj rows (its sums complete a chunk: the depth is P); a warp owns each
// dh tile over its whole depth and each gate tile over the whole pass,
// adding its k-slices in slice order (the gate sums onto gx), as the
// resident plan's readers add its slice partials.  Every cluster streams
// its direction's whole slices a step whatever its rows, so the launcher
// takes the largest R that threads and shared memory allow.
//
// Safety, beside lstm_bwd.cu's buffers: the ring is the block's own, a
// slot refilled only after the block barrier that ends every read of its
// chunk, a chunk read only once its barrier's phase has completed; the
// gate sums are written at the end of step t's pass and read in step
// t-1's cell phase, with block barriers between; the dout_blk and dh
// partials share a region (used in 2-3 and in 4-5a), the dh partials read
// before the cluster barrier that ends 5.

#include "lstm_cluster.cuh"
#include "lstm_bwd_entry.cuh"

namespace {

typedef __nv_bfloat16 T;

// The streamed plan's shared memory with C blocks and R rows, common to host
// and device: lstm_bwd.cu's BwdPlan (US, U16, G, PS, PW, P16, ND; the A
// operands of 8 rows, padded by 16 bytes) plus gsum [R][G] (the gate sums
// of the next step) and one region of partial sums (dout_blk's slices
// [slices][8][ND], or dh's [R][PW], or the peephole sums [3][R][US]); LWS,
// LPJ: the row strides of wh's and proj's rows in shared memory, and in
// the padded layout the wrapper gives this plan (4·US and P16, each row
// padded by 16 bytes with zeros); wsteps,
// gsteps: 16-deep steps of P and of G; utiles: proj's 16-row tiles; res:
// wh's resident steps (at most `cap` where cap >= 0); cw, cu: the steps of
// wh and the tiles of proj a chunk; nw, np: chunks a pass; slots, slot: the
// ring.
struct BwdStreamPlan {
  int us, u16, g, ps, pw, p16, nd, lda, ldg, lws, lpj;
  Split gates, dob, dh;
  int wsteps, gsteps, utiles, res, cw, cu, nw, np, slots;
  size_t slot, off_dq, off_gq, off_dh, off_dnx, off_dnx2, off_hraw, off_craw, off_gxs,
      off_rows, off_dc, off_inbox, off_gsum, off_part, off_bar, off_ring, off_res, bytes;
  long long res_bytes, stream_bytes;
};

template <typename S>
__host__ __device__ BwdStreamPlan bwd_stream_plan(int H, int P, bool has_proj, int R, int C,
                                                  int cap) {
  BwdStreamPlan p;
  p.us = round_up(cdiv(H, C), 8);
  p.u16 = round_up(p.us, 16);
  p.g = 4 * p.us;
  p.ps = round_up(cdiv(P, C), 4);
  p.pw = C * p.ps;
  p.p16 = round_up(P, 16);
  p.nd = p.u16;
  const int pad = 8;
  p.lda = p.p16 + pad;
  p.ldg = p.g + pad;
  p.lws = p.g + pad;
  p.lpj = p.p16 + pad;
  // lstm_bwd.cu's splits (bwd_plan)
  p.gates = mma_split(p.g, p.p16, 2);
  p.dob = mma_split(p.nd, p.p16);
  p.dh = mma_split(p.pw, p.g, 2);
  p.wsteps = p.p16 / 16;
  p.gsteps = p.g / 16;
  p.utiles = has_proj ? p.u16 / 16 : 0;
  const size_t wrow = sizeof(T) * 16 * (size_t)p.lws, urow = sizeof(T) * 16 * (size_t)p.lpj;
  p.cw = kChunkBytes / wrow > 1 ? (int)(kChunkBytes / wrow) : 1;
  p.cu = !has_proj ? 0 : kChunkBytes / urow > 1 ? (int)(kChunkBytes / urow) : 1;
  p.slot = align128(p.cw * wrow > p.cu * urow ? p.cw * wrow : p.cu * urow);
  size_t part = has_proj ? (size_t)p.dob.slices * 8 * p.nd : 0;
  if (part < (size_t)R * p.pw) part = (size_t)R * p.pw;
  if (part < (size_t)3 * R * p.us) part = (size_t)3 * R * p.us;
  p.off_dq = align128(sizeof(T) * 8 * (size_t)p.lda);
  p.off_gq = p.off_dq + align128(sizeof(T) * 8 * (size_t)p.lda);
  p.off_dh = p.off_gq + align128(sizeof(T) * 8 * (size_t)p.ldg);
  p.off_dnx = p.off_dh + align128(sizeof(float) * (size_t)R * p.pw);
  p.off_dnx2 = p.off_dnx + align128(sizeof(float) * (size_t)R * p.pw);
  p.off_hraw = p.off_dnx2 + align128(sizeof(float) * (size_t)R * p.pw);
  p.off_craw = p.off_hraw + align128(sizeof(S) * (size_t)R * P);
  p.off_gxs = p.off_craw + align128(sizeof(S) * (size_t)R * p.us);
  p.off_rows = p.off_gxs + align128(sizeof(float) * (size_t)R * 4 * p.us);
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

// at most kLayerUnits units a block, R·US threads, two ring slots (and
// with cap = kAllHeld, every step of wh resident)
bool plan_fits(const BwdStreamPlan& p, int R, int cap) {
  return p.us <= kLayerUnits && R * p.us <= kThreads && p.slots >= 2 &&
         p.bytes <= kMaxSmemPerBlock && (cap != kAllHeld || p.res == p.wsteps);
}

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
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int dir = blockIdx.y, tile = blockIdx.x / C, b0 = tile * R;
  const int nr = min(R, batch - b0);
  const bool has_proj = pj_sl != nullptr;
  const BwdStreamPlan pl = bwd_stream_plan<S>(H, P, has_proj, R, C, cap);
  const int US = pl.us, G = pl.g, PS = pl.ps, PW = pl.pw, P16 = pl.p16, nd = pl.nd;
  const int u0 = q * US, nu = max(0, min(US, H - u0));
  const int p0 = q * PS;
  const int tid = threadIdx.x;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* hq = reinterpret_cast<T*>(smem_raw);                  // [8][lda] h_prev
  T* dq = reinterpret_cast<T*>(smem_raw + pl.off_dq);      // [8][lda] dout_p
  T* gq = reinterpret_cast<T*>(smem_raw + pl.off_gq);      // [8][ldg] dgates
  float* dh = reinterpret_cast<float*>(smem_raw + pl.off_dh);    // [R][PW]
  float* dnx = reinterpret_cast<float*>(smem_raw + pl.off_dnx);  // [R][PW] dout
  float* dnx_next = reinterpret_cast<float*>(smem_raw + pl.off_dnx2);
  S* h_raw = reinterpret_cast<S*>(smem_raw + pl.off_hraw);       // [R][P]
  S* c_raw = reinterpret_cast<S*>(smem_raw + pl.off_craw);       // [R][US]
  float* gx_s = reinterpret_cast<float*>(smem_raw + pl.off_gxs); // [R][4][US]
  float* keep_s = reinterpret_cast<float*>(smem_raw + pl.off_rows);  // [2][R]
  int* len_s = reinterpret_cast<int*>(keep_s + 2 * R);               // [R]
  float* dc = reinterpret_cast<float*>(smem_raw + pl.off_dc);        // [R][US]
  float* inbox = reinterpret_cast<float*>(smem_raw + pl.off_inbox);  // [C][R][PS]
  float* gsum = reinterpret_cast<float*>(smem_raw + pl.off_gsum);    // [8][G]
  float* part = reinterpret_cast<float*>(smem_raw + pl.off_part);
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
  for (int i = tid; i < 8 * pl.lda; i += kThreads) hq[i] = dq[i] = zero;
  for (int i = tid; i < 8 * pl.ldg; i += kThreads) gq[i] = zero;
  const size_t frow = (size_t)dir * batch + b0;
  for (int i = tid; i < R * PW; i += kThreads) {
    const int r = i / PW, p = i - r * PW;
    dh[i] = r < nr && p < P ? dhfin[(frow + r) * P + p] : 0.0f;
    dnx[i] = dnx_next[i] = 0.0f;
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

  // the cell phase: thread (rb, jb) owns one unit of one row
  const int rb = tid / US, jb = tid - rb * US;
  const bool in_b = tid < R * US && rb < nr;
  const bool own_b = in_b && jb < nu;
  const int ub = u0 + jb;
  const int len_b = own_b ? lengths[b0 + rb] : 0;
  const float* pd = peep ? peep + (size_t)dir * 3 * H : nullptr;
  float pi = 0.0f, pf = 0.0f, po = 0.0f;
  if (pd && own_b) {
    pi = pd[ub];
    pf = pd[H + ub];
    po = pd[2 * H + ub];
  }
  float sum_i = 0.0f, sum_f = 0.0f, sum_o = 0.0f;  // the peephole sums
  float cnext = 0.0f;

  // lstm_bwd.cu's staged loads of step tt: fetch a step ahead, land, stash
  // (gx stays in gx_s, where the pass that sums the gates reads it)
  float keep_next = 1.0f;
  auto fetch_step = [&](int tt) {
    const size_t r0 = (size_t)tt * 2 * batch + frow;
    const size_t rp = r0 - 2 * (size_t)batch;
    if (keep && tid < nr) keep_next = keep[(size_t)tt * batch + b0 + tid];
    const int pq = P / 4;
    for (int i = tid; i < nr * pq; i += kThreads) {
      const int r = i / pq, p = 4 * (i - r * pq);
      cp_async4(dnx_next + r * PW + p, dout + (r0 + r) * P + p);
      if (tt > 0) cp_async4(h_raw + r * P + p, h_all + (rp + r) * P + p);
    }
    const int uq = nu / 4;
    for (int i = tid; i < nr * 5 * uq; i += kThreads) {
      const int r = i / (5 * uq), e = i - r * 5 * uq, k = e / uq, j = 4 * (e - k * uq);
      if (k < 4)
        cp_async4(gx_s + (r * 4 + k) * US + j, gx + (r0 + r) * 4 * H + k * H + u0 + j);
      else if (tt > 0)
        cp_async4(c_raw + r * US + j, c_all + (rp + r) * H + u0 + j);
    }
    cp_async_commit();
  };
  auto land_step = [&](int tt) {
    cp_async_wait_all();
    if (tid < nr) keep_s[(tt & 1) * R + tid] = keep_next;
    __syncthreads();
  };
  auto stash_step = [&](int tt) {
    float* d = dnx;
    dnx = dnx_next;
    dnx_next = d;
    const float* kps = keep_s + (tt & 1) * R;
    for (int i = tid; i < nr * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      hq[r * pl.lda + p] =
          Dtype<T>::from_float(tt > 0 ? kps[r] * ld(h_raw, (size_t)r * P + p) : 0.0f);
    }
    if (own_b) cnext = tt > 0 ? kps[rb] * ld(c_raw, (size_t)rb * US + jb) : 0.0f;
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

  // 2. dout_blk over proj's chunks of rows (the units), part[s][8][ND]
  auto dob_pass = [&]() {
    bwd_dob_pass(dq, pl.lda, P16, ring, pl.lpj, pl.np, pl.cu, pl.utiles, pl.dob, part, nd, chunk,
                 total, issue);
  };

  // 4. the pass over wh's rows p: dh_prev's partial into part [R][PW],
  // the gate sums of the step before (gx + h_prev · wh_q) into gsum [R][G]
  auto wh_pass = [&](bool dh_on, bool gate_on) {
    bwd_wh_pass(dh_on, gate_on, hq, pl.lda, gq, pl.ldg, G, pl.wsteps, pl.gsteps, pl.gates, pl.dh,
                wres, pl.lws, pl.res, ring, pl.cw, chunk, total, issue,
                [&](int r, int c) {
                  return r < nr ? gx_s[(r * 4 + c / US) * US + c % US] : 0.0f;
                },
                R, gsum, part, PW);
  };

  cluster.sync();  // every block is resident and initialised
  if (tid == 0)
    for (int n = 0; n < pl.slots && n < total; ++n) issue(n);
  if (steps > 0) {
    fetch_step(steps - 1);
    land_step(steps - 1);
    stash_step(steps - 1);
    __syncthreads();
    wh_pass(false, true);
  }

  for (int t = steps - 1; t >= 0; --t) {
    const size_t row0 = (size_t)t * 2 * batch + frow;
    if (t > 0) fetch_step(t - 1);

    // 1. dout_p over the full P; the stashes of the owned P-slice
    for (int i = tid; i < nr * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      const float m = t < len_s[r] ? 1.0f : 0.0f;
      const float dhv = dh[r * PW + p];
      const float v = m * (dnx[r * PW + p] + dhv);
      dq[r * pl.lda + p] = Dtype<T>::from_float(v);
      if (p >= p0 && p < p0 + PS) {
        if (doutp_st) doutp_st[(row0 + r) * P + p] = dq[r * pl.lda + p];
        if (dh_in) dh_in[(row0 + r) * P + p] = dhv;
      }
    }
    __syncthreads();

    // 2. dout_blk of the owned units
    if (has_proj) dob_pass();

    // 3. the cell backward of the owned units
    if (in_b) {
      float dgv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (own_b) {
        float gate[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) gate[k] = gsum[rb * G + k * US + jb];
        const float m = t < len_b ? 1.0f : 0.0f;
        const float kp = keep_s[(t & 1) * R + rb];
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
            db += part[((size_t)s * 8 + rb) * nd + jb];
        } else {
          db = m * (dnx[rb * PW + ub] + dh[rb * PW + ub]);
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

    // 3b. the step before's staged loads; 4. the pass over wh
    if (t > 0) {
      land_step(t - 1);
      stash_step(t - 1);
      __syncthreads();
    }
    wh_pass(true, t > 0);

    // 5a. reduce-scatter: each P-slice's partial into its owner's inbox
    const int quads = PW / 4;
    for (int i = tid; i < nr * quads; i += kThreads) {
      const int r = i / quads, p = 4 * (i - r * quads);
      const float4 v = p < P16 ? *reinterpret_cast<const float4*>(part + (size_t)r * PW + p)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const int owner = p / PS;
      float* dst = cluster.map_shared_rank(inbox, owner) + ((size_t)q * R + r) * PS + p - owner * PS;
      *reinterpret_cast<float4*>(dst) = v;
    }
    cluster.sync();

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
      const float m = t < len_s[r] ? 1.0f : 0.0f;
      const float kp = keep_s[(t & 1) * R + r];
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = p + e < P ? kp * ((1.0f - m) * dh[r * PW + p + e] + s[e]) : 0.0f;
      const float4 nv = make_float4(v[0], v[1], v[2], v[3]);
      for (int b = 0; b < C; ++b)
        *reinterpret_cast<float4*>(cluster.map_shared_rank(dh, b) + r * PW + p) = nv;
    }
    cluster.sync();
  }

  // this row tile's peephole sums: the rows added in order
  if (peep_part) {
    float* sums = part;  // [3][R][US]
    if (in_b) {
      sums[(0 * R + rb) * US + jb] = sum_i;
      sums[(1 * R + rb) * US + jb] = sum_f;
      sums[(2 * R + rb) * US + jb] = sum_o;
    }
    __syncthreads();
    float* out = peep_part + (size_t)(tile * 2 + dir) * 3 * H;
    for (int i = tid; i < 3 * nu; i += kThreads) {
      const int k = i / nu, j = i - k * nu;
      float v = 0.0f;
      for (int r = 0; r < nr; ++r) v += sums[(k * R + r) * US + j];
      out[k * H + u0 + j] = v;
    }
  }
}

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

// R given, or (rows = 0) the largest of {8, 6, 4, 2} that fits (the fewest
// clusters and waves: in a trial on the card R = 6 with a ring of 2 slots
// ran faster than R = 4 with more slots, whose clusters ran a wave more)
template <typename S, int C>
cudaError_t launch_plan(const LstmBwdArgs& a, int rows, int cap, bool dry, float* peep_part,
                        LstmBwdLaunch* how) {
  cudaError_t err = cudaSuccess;
  how->rows = 0;
  if (rows == 0 || rows == 8) err = launch_rows<S, 8, C>(a, cap, dry, peep_part, how);
  if (err != cudaSuccess || how->rows) return err;
  if (rows == 0 || rows == 6) err = launch_rows<S, 6, C>(a, cap, dry, peep_part, how);
  if (err != cudaSuccess || how->rows) return err;
  if (rows == 0 || rows == 4) err = launch_rows<S, 4, C>(a, cap, dry, peep_part, how);
  if (err != cudaSuccess || how->rows) return err;
  if (rows == 0 || rows == 2) err = launch_rows<S, 2, C>(a, cap, dry, peep_part, how);
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
