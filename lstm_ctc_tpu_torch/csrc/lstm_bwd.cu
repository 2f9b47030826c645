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
// kernel, as XLA does them outside the TPU kernel (K3, lstm_bwd_fold.cu,
// runs this launch and then computes them itself).  The weight gradients
// (:331-371) dwh = Σ h_prevᵀ·dgates and dproj = Σ out_blkᵀ·dout_p run
// after the recurrence over the streams it writes (lstm_bwd_wgrad.cu, on
// the tensor cores in bf16); the peephole sums Σ dg_i·c_prev, Σ dg_f·c_prev
// and Σ dg_o·c_new are kept by the recurrence itself.  Operands of every
// product are rounded to the compute dtype; sums, the carries and every
// output except dgates stay float32.  The float32 path uses FMA only,
// never TF32.
//
// What bounds it on the H100: the recurrence is sequential, so each step's
// latency counts.  A step needs the direction's wh twice (as wh and whᵀ)
// and proj once, 1.0 MB in bf16 at H = P = 320; read from L2 at every step
// they cost ~45 us a step.  Design: K1's (lstm_fwd.cu, lstm_cluster.cuh).
// An 8-block cluster (16, below) per (direction, tile of R batch rows) owns the time
// loop; block q owns hidden units [q·US, (q+1)·US), all four gates of them,
// and keeps in its shared memory, for the whole sequence, its wh slice
// [P, 4·US] (which serves both h·wh and dgates·whᵀ) and its rows of proj
// [US, P] (dout_blk of its units needs all of dout_p but no reduction):
// ~140 KB at H = P = 320.  Per step:
//   1. dout_p over the full P from the block's full copy of dh;
//   2. dout_blk of the owned units;
//   3. the cell backward of the owned units (dc never leaves the block):
//      dgates, the out_blk and dout_p stashes of the wgrad pass, the
//      peephole sums in registers;
//   4. the block's partial dh_prev, dgates_q·wh_qᵀ [R, P];
//   5. reduce-scatter over distributed shared memory: block j receives the
//      partials of its P-slice from every block, cluster barrier, adds them in block
//      order (deterministic), applies dh = kp·((1-m)·dh + Σ), and writes
//      the new slice into every block (all-gather), cluster barrier.
// The gate recompute of the step before (h_prev·wh_q, which does not
// depend on the carries) runs between the two halves of the first barrier,
// off the critical path; that step's loads (h_prev, dout, gx, c_prev) are
// started at the start of this one, by cp.async into staging buffers.  In
// bf16 the products run on the tensor cores (ldmatrix, mma.sync m16n8k16,
// the 8 rows of an A operand loaded once for mma's 16), their running sums kept in float32 adds
// rounded to nearest (mma_product_f32add: near a cancellation in dc_new the
// tensor cores' own accumulation moved dgates by more than a bf16 rounding
// step against the plain version's, and the steps' mma no longer wait on
// one another).  In float32 the products are FMA split over all threads
// and the slices are read from L2 (they do not fit in shared memory at the
// flagship width).  R is the smallest of {4, 6, 8} whose 2·ceil(B/R)
// clusters are all resident, as the occupancy API says (B = 32: R = 6, 12
// clusters); else the largest R with one cluster resident (they then run
// in waves); if none fits, the launch is refused.
//
// Where no 8-block plan fits (bf16 slices past shared memory, from H = P =
// 324; any layer past 512 units), the cluster has 16 blocks, as K1's
// (lstm_fwd.cu): a block owns at most 64 units, so H <= 1024, and keeps
// its wh slice [P, 4·US] and proj rows [US, P] (~160 KB at H = 1024, P =
// 256); dh is reduced over 16 blocks' partials, in block order, and
// all-gathered to 16.  The buffers of R rows grow with P (dh, dout and its
// staging, the inbox: 16 bytes a row and column), so at H = P = 512 only
// R = 2 fits beside the slices: the 16-block plans add R = 2, tried last.
// Fewer 16-block clusters are resident at once, so the clusters run in
// waves more often.  A block owns at most 128 units (H <= 2048); in float32
// the slices are read from L2 whatever their size.  bf16 slices that fit
// no resident plan (H = P = 1024 without a projection) take the streamed
// plan of lstm_bwd_streamed.cu, which streams them from L2 at every step;
// any H past 2048 is refused.
//
// The wrapper lays the weights out per slice: wh as K1 does ([2, C, P16,
// 4, US]) and proj as rows ([2, C, U16, P16], U16 = US rounded up to 16),
// zero-padded.  The kernel allocates nothing and launches on the caller's
// stream.

#include "lstm_cluster.cuh"
#include "lstm_bwd_entry.cuh"

namespace {

// Shared-memory plan of the backward with C blocks a cluster, common to host
// and device.  US: units a block; U16: its proj rows (rounded up to 16); G =
// 4·US; PS: the dh columns a block owns in the reduction (a multiple of 4),
// PW = C·PS; arow: rows of the A operands (8 in bf16, R in float32); prow:
// rows of each partial-sum block (8 in bf16); lda, ldg: row strides of the A operands (h_prev and
// dout_p over P16 columns, dgates over G); nd: columns of the dout_blk
// product; wrows: rows of the wh slice in shared memory (dh_prev's product
// reads PW of them, the rows past P16 zero).
struct BwdPlan {
  int us, u16, g, ps, pw, p16, nd, wrows, arow, prow, lda, ldg, lwh, lpj;
  Split gates, dob, dh;
  size_t off_dq, off_gq, off_dh, off_dnx, off_dnx2, off_hraw, off_craw, off_gxs,
      off_rows, off_dc, off_inbox, off_part, off_wh, off_pj, bytes;
};

// T: the compute dtype, S: the store dtype of the per-step states
template <typename T, typename S>
__host__ __device__ BwdPlan bwd_plan(int H, int P, bool has_proj, int R, int C) {
  BwdPlan p;
  p.us = round_up(cdiv(H, C), 8);
  p.u16 = round_up(p.us, 16);
  p.g = 4 * p.us;
  p.ps = round_up(cdiv(P, C), 4);
  p.pw = C * p.ps;
  p.p16 = round_up(P, 16);
  p.nd = kMma<T> ? p.u16 : p.us;
  p.wrows = p.p16 > p.pw ? p.p16 : p.pw;
  const int pad = 16 / (int)sizeof(T);
  p.arow = kMma<T> ? 8 : R;
  p.prow = kMma<T> ? 8 : R;
  p.lda = p.p16 + pad;
  p.ldg = p.g + pad;
  p.lwh = p.g + pad;
  p.lpj = p.p16 + pad;
  if constexpr (kMma<T>) {
    // at most two slices where the partials are large: shared memory is full
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
  const size_t part = part_g + part_d > part_h ? part_g + part_d : part_h;
  p.off_dq = align128(sizeof(T) * (size_t)p.arow * p.lda);
  p.off_gq = p.off_dq + align128(sizeof(T) * (size_t)p.arow * p.lda);
  p.off_dh = p.off_gq + align128(sizeof(T) * (size_t)p.arow * p.ldg);
  p.off_dnx = p.off_dh + align128(sizeof(float) * (size_t)R * p.pw);
  p.off_dnx2 = p.off_dnx + align128(sizeof(float) * (size_t)R * p.pw);
  p.off_hraw = p.off_dnx2 + align128(sizeof(float) * (size_t)R * p.pw);
  p.off_craw = p.off_hraw + align128(sizeof(S) * (size_t)R * P);
  p.off_gxs = p.off_craw + align128(sizeof(S) * (size_t)R * p.us);
  p.off_rows = p.off_gxs + align128(sizeof(float) * (size_t)R * 4 * p.us);
  p.off_dc = p.off_rows + align128(sizeof(float) * 3 * (size_t)R);
  p.off_inbox = p.off_dc + align128(sizeof(float) * (size_t)R * p.us);
  p.off_part = p.off_inbox + align128(sizeof(float) * (size_t)C * R * p.ps);
  p.off_wh = p.off_part + align128(sizeof(float) * part);
  p.off_pj = p.off_wh + (kMma<T> ? align128(sizeof(T) * (size_t)p.wrows * p.lwh) : 0);
  p.bytes = p.off_pj + (kMma<T> && has_proj ? align128(sizeof(T) * (size_t)p.u16 * p.lpj) : 0);
  return p;
}

// T: the compute dtype (bf16: the products on the tensor cores, the slices
// in shared memory; float32: FMA, the slices read from L2); S: the store
// dtype
template <typename T, typename S, int R, int C>
__global__ void __launch_bounds__(kThreads, 1) lstm_bwd_kernel(
    const float* __restrict__ gx,     // [T, 2B, 4H]
    const int* __restrict__ lengths,  // [B]
    const float* __restrict__ keep,   // [T, B] or null
    const S* __restrict__ c_all,      // [T, 2B, H] store dtype
    const S* __restrict__ h_all,      // [T, 2B, P] store dtype
    const T* __restrict__ wh_sl,      // [2, C, P16, 4, US]
    const T* __restrict__ pj_sl,      // [2, C, U16, P16] or null (P == H)
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
    float* __restrict__ peep_part) {  // [tiles, 2, 3, H] or null
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int dir = blockIdx.y, tile = blockIdx.x / C, b0 = tile * R;
  const int nr = min(R, batch - b0);
  const bool has_proj = pj_sl != nullptr;
  const BwdPlan pl = bwd_plan<T, S>(H, P, has_proj, R, C);
  const int US = pl.us, G = pl.g, PS = pl.ps, PW = pl.pw, P16 = pl.p16;
  const int prow = pl.prow, nd = pl.nd;
  const int u0 = q * US, nu = max(0, min(US, H - u0));
  const int p0 = q * PS;
  const int tid = threadIdx.x;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* hq = reinterpret_cast<T*>(smem_raw);                  // [arow][lda] h_prev
  T* dq = reinterpret_cast<T*>(smem_raw + pl.off_dq);      // [arow][lda] dout_p
  T* gq = reinterpret_cast<T*>(smem_raw + pl.off_gq);      // [arow][ldg] dgates
  float* dh = reinterpret_cast<float*>(smem_raw + pl.off_dh);    // [R][PW]
  float* dnx = reinterpret_cast<float*>(smem_raw + pl.off_dnx);  // [R][PW] dout
  // the step before's loads, staged by cp.async: dout (swapped with dnx),
  // the raw h and c rows, the owned units' gx
  float* dnx_next = reinterpret_cast<float*>(smem_raw + pl.off_dnx2);  // [R][PW]
  S* h_raw = reinterpret_cast<S*>(smem_raw + pl.off_hraw);             // [R][P]
  S* c_raw = reinterpret_cast<S*>(smem_raw + pl.off_craw);             // [R][US]
  float* gx_s = reinterpret_cast<float*>(smem_raw + pl.off_gxs);       // [R][4][US]
  // each row's keep at steps of either parity, and its length
  float* keep_s = reinterpret_cast<float*>(smem_raw + pl.off_rows);    // [2][R]
  int* len_s = reinterpret_cast<int*>(keep_s + 2 * R);                 // [R]
  float* dc = reinterpret_cast<float*>(smem_raw + pl.off_dc);    // [R][US]
  float* inbox = reinterpret_cast<float*>(smem_raw + pl.off_inbox);  // [C][R][PS]
  float* part = reinterpret_cast<float*>(smem_raw + pl.off_part);
  float* part_d = part + (size_t)pl.gates.slices * prow * G;
  T* wh_s = reinterpret_cast<T*>(smem_raw + pl.off_wh);
  T* pj_s = reinterpret_cast<T*>(smem_raw + pl.off_pj);

  const size_t slot = (size_t)dir * C + q;
  const T* wh_g = wh_sl + slot * (size_t)P16 * G;
  const T* pj_g = has_proj ? pj_sl + slot * (size_t)pl.u16 * P16 : nullptr;
  const T zero = Dtype<T>::from_float(0.0f);
  if constexpr (kMma<T>) {
    copy_rows(wh_s, pl.lwh, wh_g, G, P16);
    for (int i = tid; i < (pl.wrows - P16) * pl.lwh; i += kThreads)
      wh_s[(size_t)P16 * pl.lwh + i] = zero;
    if (has_proj) copy_rows(pj_s, pl.lpj, pj_g, P16, pl.u16);
  }
  for (int i = tid; i < pl.arow * pl.lda; i += kThreads) hq[i] = dq[i] = zero;
  for (int i = tid; i < pl.arow * pl.ldg; i += kThreads) gq[i] = zero;
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
  float gnext[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cnext = 0.0f;

  // What step tt reads that no carry feeds: dout, the previous h (for hq,
  // kept and rounded) and, for the owned units, gx and the previous c.
  // fetch_step starts their copies into the staging buffers a step ahead
  // (cp.async, 4 elements a copy: H and P are multiples of 4, and so are
  // u0 and nu); stash_step, after they landed, puts them where the step
  // reads them.
  float keep_next = 1.0f;  // thread r < nr: row r's keep at the step fetched
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
  // after the copies landed: the row keeps of step tt, then a barrier,
  // then stash_step
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
    if (own_b) {
#pragma unroll
      for (int k = 0; k < 4; ++k) gnext[k] = gx_s[(rb * 4 + k) * US + jb];
      cnext = tt > 0 ? kps[rb] * ld(c_raw, (size_t)rb * US + jb) : 0.0f;
    }
  };
  auto gate_product = [&]() {
    if constexpr (kMma<T>)
      mma_product_f32add<false>(hq, pl.lda, P16, wh_s, pl.lwh, G, pl.gates, part);
    else
      fma_product<R>(hq, pl.lda, P16, wh_g, G, G, pl.gates, part);
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
            db += part_d[((size_t)s * prow + rb) * nd + jb];
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
        // the peephole sums take dgates as stored
        sum_i = fmaf(stored[0], c0, sum_i);
        sum_f = fmaf(stored[2], c0, sum_f);
        sum_o = fmaf(stored[3], cn, sum_o);
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

typedef LstmBwdArgs Args;
typedef LstmBwdLaunch Launch;

// K2's plan with C blocks and R rows a cluster, and whether its units a
// block, threads and shared memory fit a block
template <typename T, typename S>
bool bwd_fits(int H, int P, bool has_proj, int rows, int C, BwdPlan* plan) {
  *plan = bwd_plan<T, S>(H, P, has_proj, rows, C);
  return plan->us <= kLayerUnits && rows * plan->us <= kThreads &&
         plan->bytes <= kMaxSmemPerBlock;
}

// K2's plans, in the order they are tried: resident on 8 blocks (R = 4
// fits), resident on 16 (R = 2 fits), streamed on 16 (bf16, R = 2 fits;
// lstm_bwd_streamed.cu)
enum Kind { kNone = 0, kResident = 1, kStreamed = 2 };

struct Route {
  Kind kind;
  int blocks;
};

template <typename T, typename S>
Route bwd_route(int H, int P, bool has_proj) {
  BwdPlan pl;
  if (bwd_fits<T, S>(H, P, has_proj, 4, kCluster, &pl)) return Route{kResident, kCluster};
  if (bwd_fits<T, S>(H, P, has_proj, 2, kWideCluster, &pl)) return Route{kResident, kWideCluster};
  if (kMma<T> && lstm_bwd_streamed_fits(H, P, has_proj, std::is_same<S, __nv_bfloat16>::value,
                                        kWideCluster, 2, -1))
    return Route{kStreamed, kWideCluster};
  return Route{kNone, 0};
}

// Set up the launch with R rows a cluster, if its shared memory fits and
// the occupancy API says all 2·ceil(B/R) clusters are resident at once (with
// `all`) or at least one is; launch unless `dry`.  how->rows = 0: not with
// this R.
template <typename T, typename S, int R, int C>
cudaError_t launch_rows(const Args& a, bool all, bool dry, Launch* how) {
  how->rows = 0;
  BwdPlan pl;
  const bool has_proj = a.proj_rows != nullptr;
  if (!bwd_fits<T, S>(a.units, a.out_dim, has_proj, R, C, &pl))
    return cudaSuccess;
  auto kernel = lstm_bwd_kernel<T, S, R, C>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int fit;
  cudaError_t err = cluster_config(kernel, a.batch, R, C, pl.bytes, a.stream, &cfg, attr, &fit);
  if (err != cudaSuccess) return err;
  const int clusters = 2 * cdiv(a.batch, R);
  if (fit < (all ? clusters : 1)) return cudaSuccess;
  // bf16 holds its slices; float32 reads wh twice and the proj rows once
  // from L2 at every step
  const long long wh = (long long)sizeof(T) * pl.p16 * pl.g;
  const long long pj = has_proj ? (long long)sizeof(T) * pl.u16 * pl.p16 : 0;
  *how = Launch{C, R, clusters, fit, pl.bytes, kMma<T> ? wh + pj : 0,
                kMma<T> ? 0 : 2 * wh + pj};
  if (dry) return cudaSuccess;
  const bool peeps = a.peep != nullptr;
  float* peep_part = peeps ? (float*)a.scratch : nullptr;
  err = cudaLaunchKernelEx(
      &cfg, kernel, (const float*)a.gx, (const int*)a.lengths, (const float*)a.keep,
      (const S*)a.c_all, (const S*)a.h_all, (const T*)a.wh_sl, (const T*)a.proj_rows,
      (const float*)a.peep, a.forget_bias, (const float*)a.dout, (const float*)a.dcfin,
      (const float*)a.dhfin, a.steps, a.batch, a.units, a.out_dim, (S*)a.dgates,
      (T*)a.outb_st, (T*)a.doutp_st, (float*)a.dc_in, (float*)a.dh_in, peep_part);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The smallest R of {4, 6, 8} whose clusters are all resident at once;
// else the largest with at least one resident (the clusters then run in
// waves; with 16 blocks R = 2 last); else the launch is refused, as it is
// for shapes with no plan (bwd_route).
template <typename T, typename S, int C>
cudaError_t choose_rows(const Args& a, bool dry, Launch* how) {
  cudaError_t err;
  for (int pass = 0; pass < 2; ++pass) {
    const bool all = pass == 0;
    err = all ? launch_rows<T, S, 4, C>(a, all, dry, how) : launch_rows<T, S, 8, C>(a, all, dry, how);
    if (err != cudaSuccess || how->rows) return err;
    err = launch_rows<T, S, 6, C>(a, all, dry, how);
    if (err != cudaSuccess || how->rows) return err;
    err = all ? launch_rows<T, S, 8, C>(a, all, dry, how) : launch_rows<T, S, 4, C>(a, all, dry, how);
    if (err != cudaSuccess || how->rows) return err;
  }
  if constexpr (C > kCluster) {
    err = launch_rows<T, S, 2, C>(a, false, dry, how);
    if (err != cudaSuccess || how->rows) return err;
  }
  return cudaErrorInvalidConfiguration;
}

template <typename T, typename S>
cudaError_t choose(const Args& a, bool dry, Launch* how) {
  *how = Launch{0, 0, 0, 0, 0, 0, 0};
  const Route route = bwd_route<T, S>(a.units, a.out_dim, a.proj_rows != nullptr);
  if (route.kind == kStreamed)
    return lstm_bwd_streamed(a, std::is_same<S, __nv_bfloat16>::value, kWideCluster, 0, -1, dry,
                             a.peep ? (float*)a.scratch : nullptr, how);
  switch (route.kind == kResident ? route.blocks : 0) {
    case kCluster:
      return choose_rows<T, S, kCluster>(a, dry, how);
    case kWideCluster:
      return choose_rows<T, S, kWideCluster>(a, dry, how);
    default:
      return cudaErrorInvalidConfiguration;
  }
}

// A bf16 launch on the plan that `plan` names, at R = `rows` (chip_smoke.py
// holds the plans against each other): 1, this shape's resident plan; 2,
// the streamed plan with the blocks lstm_bwd_fits answers (the resident
// plan's, so the dh partials are summed over the same blocks) and at most
// half of wh's steps resident, so that the ring streams wh too; 3, the
// same with every step of wh resident (refused where they do not all fit);
// 4, with as many resident as fit.
template <typename S>
cudaError_t forced(const Args& a, int plan, int rows, Launch* how) {
  typedef __nv_bfloat16 T;
  *how = Launch{0, 0, 0, 0, 0, 0, 0};
  const Route route = bwd_route<T, S>(a.units, a.out_dim, a.proj_rows != nullptr);
  if (plan >= 2 && plan <= 4)
    return lstm_bwd_streamed(a, std::is_same<S, __nv_bfloat16>::value, route.blocks, rows,
                             plan == 2 ? cdiv(a.out_dim, 16) / 2 : plan == 3 ? kAllHeld : -1,
                             false, a.peep ? (float*)a.scratch : nullptr, how);
  if (plan != 1 || route.kind != kResident) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaErrorInvalidConfiguration;
  switch (route.blocks * 16 + rows) {
    case kCluster * 16 + 4: err = launch_rows<T, S, 4, kCluster>(a, false, false, how); break;
    case kCluster * 16 + 6: err = launch_rows<T, S, 6, kCluster>(a, false, false, how); break;
    case kCluster * 16 + 8: err = launch_rows<T, S, 8, kCluster>(a, false, false, how); break;
    case kWideCluster * 16 + 2: err = launch_rows<T, S, 2, kWideCluster>(a, false, false, how); break;
    case kWideCluster * 16 + 4: err = launch_rows<T, S, 4, kWideCluster>(a, false, false, how); break;
    case kWideCluster * 16 + 6: err = launch_rows<T, S, 6, kWideCluster>(a, false, false, how); break;
    case kWideCluster * 16 + 8: err = launch_rows<T, S, 8, kWideCluster>(a, false, false, how); break;
    default: break;
  }
  if (err == cudaSuccess && !how->rows) return cudaErrorInvalidConfiguration;
  return err;
}

// the peephole partials lead the scratch: one [2, 3, H] per row tile of the
// smallest R (2)
size_t peep_floats(int batch, int units) { return (size_t)cdiv(batch, 2) * 2 * 3 * units; }

// The recurrence on its plan (`plan` 0), or on a forced plan and R (bf16:
// `forced`), then the weight gradients
template <typename T, typename S>
int launch(int device, const Args& a, int plan = 0, int rows = 0) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int H = a.units, P = a.out_dim;
  if (a.batch <= 0 || a.steps <= 0) return cudaSuccess;
  if (H <= 0 || P <= 0 || H % 4 || P % 4 || (!a.proj_rows && P != H))
    return cudaErrorInvalidValue;
  Launch how;
  if constexpr (kMma<T>)
    err = plan ? forced<S>(a, plan, rows, &how) : choose<T, S>(a, false, &how);
  else
    err = choose<T, S>(a, false, &how);
  if (err != cudaSuccess) return err;
  constexpr bool kBf16 = kMma<T>;
  return lstm_bwd_wgrad(kBf16, std::is_same<S, __nv_bfloat16>::value, a.h_all, a.keep,
                        a.dgates, a.proj_rows ? a.outb_st : nullptr, a.doutp_st,
                        a.peep ? (const float*)a.scratch : nullptr,
                        cdiv(a.batch, how.rows), a.steps, a.batch, H, P, a.dwh, a.dproj,
                        a.dpeep, (float*)a.scratch + peep_floats(a.batch, H), a.stream);
}

}  // namespace

#define LSTM_BWD_PACK                                                          \
  Args{gx, lengths, keep, c_all, h_all, wh_sl, proj_rows, peep, forget_bias,  \
       dout, dcfin, dhfin, steps, batch, units, out_dim, dgates, outb_st,     \
       doutp_st, dc_in, dh_in, dwh, dproj, dpeep, scratch, (cudaStream_t)stream}

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
  return (long long)peep_floats(batch, units) +
         lstm_bwd_wgrad_scratch_floats(steps, batch, units, out_dim);
}

// lstm_bwd_bf16 on a forced plan and R (`plan` 1 resident, 2-4 streamed
// with half, all or as much of wh resident as fits; see `forced`): the slices laid out for lstm_bwd_fits's blocks
extern "C" int lstm_bwd_bf16_forced(LSTM_BWD_ARGS, int plan, int rows) {
  return store_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(device, LSTM_BWD_PACK, plan, rows)
                    : launch<__nv_bfloat16, float>(device, LSTM_BWD_PACK, plan, rows);
}

// The blocks a cluster of K2's launch plan for this shape (8 or 16;
// negative for the streamed plan, whose weight rows are laid out padded),
// or 0 when K2 has none: host arithmetic only, no CUDA call.  R = 4 (16 blocks: R = 2) needs the least threads and shared
// memory, so K2 takes a shape when that plan fits; whether any of its
// clusters is resident is the occupancy API's to say at the launch.
extern "C" int lstm_bwd_fits(int units, int out_dim, int has_proj, int bf16,
                             int store_bf16) {
  if (units <= 0 || out_dim <= 0) return 0;
  const bool proj = has_proj != 0;
  const Route r = !bf16 ? (store_bf16 ? bwd_route<float, __nv_bfloat16>(units, out_dim, proj)
                                      : bwd_route<float, float>(units, out_dim, proj))
                 : store_bf16 ? bwd_route<__nv_bfloat16, __nv_bfloat16>(units, out_dim, proj)
                              : bwd_route<__nv_bfloat16, float>(units, out_dim, proj);
  return r.kind == kStreamed ? -r.blocks : r.blocks;
}

// How K2 would launch on `device` at this shape (its states in the compute
// dtype): blocks a cluster, rows a cluster, clusters, clusters resident at
// once, dynamic shared memory a block, whether the plan is the streamed
// one, and the weight bytes a block holds and streams a step; a CUDA error
// if it cannot.  With `at` > 0 and a streamed plan, the launch at R = `at`
// (a forced launch's).
extern "C" int lstm_bwd_config(int device, int batch, int units, int out_dim,
                               int has_proj, int bf16, int* blocks, int* rows,
                               int* clusters, int* resident, long long* smem,
                               int* streamed, long long* held, long long* streams,
                               int at) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args a = {};
  a.batch = batch;
  a.units = units;
  a.out_dim = out_dim;
  a.proj_rows = has_proj ? (const void*)1 : nullptr;
  Launch how = {0, 0, 0, 0, 0, 0, 0};
  const bool stream = bf16 && bwd_route<__nv_bfloat16, __nv_bfloat16>(units, out_dim, has_proj != 0)
                                  .kind == kStreamed;
  if (stream && at > 0)
    err = lstm_bwd_streamed(a, true, kWideCluster, at, -1, true, nullptr, &how);
  else
    err = bf16 ? choose<__nv_bfloat16, __nv_bfloat16>(a, true, &how)
               : choose<float, float>(a, true, &how);
  *blocks = how.blocks;
  *rows = how.rows;
  *clusters = how.clusters;
  *resident = how.resident;
  *smem = (long long)how.smem;
  *streamed = stream;
  *held = how.held;
  *streams = how.streamed;
  return err;
}
