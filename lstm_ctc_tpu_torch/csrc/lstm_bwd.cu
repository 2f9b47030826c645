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
// runs this launch and then computes them itself).
//
// The weight gradients (:331-371) are this file's own kernels too, over
// per-step stashes the recurrence writes (c_new, the pre-projection output
// out_blk, dout_p; the TPU kernel keeps them in VMEM):
//   dwh = Σ_(t,b) h_prevᵀ·dgates,  dproj = Σ out_blkᵀ·dout_p
//   (lstm_bwd_common.cuh's wgrad_kernel),
//   dpeep = Σ dgates_i·c_prev, Σ dgates_f·c_prev, Σ dgates_o·c_new
//   (peep_partial_kernel, then split_sum_kernel, in a fixed order).
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

#include "lstm_bwd_common.cuh"
#include "lstm_bwd_entry.cuh"

namespace {

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
    block_product(a_h, P, P, wh_d, G, G, part);
    __syncthreads();
    for (int i = tid; i < nr * G; i += kThreads) {
      const int r = i / G, g = i - r * G;
      gates[i] = gx[(row0 + r) * G + g] + part_sum(part, sg.slices, G, r, g);
    }
    __syncthreads();
    // 3. dout_blk = dout_p · projᵀ
    if (has_proj) {
      block_product(a_dp, P, P, pj_d, H, H, part);
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
    block_product(a_dg, G, G, wht_d, P, P, part);
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

// h of the step before, times this step's keep (the states a step starts
// from; zeros at t = 0): the dwh product's left operand, of direction dir
template <typename S>
struct PrevKept {
  const S* h;
  const float* keep;
  int batch, width;
  __device__ float operator()(int dir, int t, int b, int m) const {
    if (t == 0) return 0.0f;
    const float v = ld(h, ((size_t)(t - 1) * 2 * batch + (size_t)dir * batch + b) * width + m);
    return keep ? v * keep[(size_t)t * batch + b] : v;
  }
};

// Scratch floats K2 needs: the split partials of both products and the
// peephole partials.
__host__ size_t scratch_floats(int steps, int batch, int H, int P) {
  const int rows = steps * batch;
  return (size_t)wgrad_splits(rows, 2, P, 4 * H) * 2 * P * 4 * H
         + (size_t)wgrad_splits(rows, 2, H, P) * 2 * H * P
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

struct Args {
  const void *gx, *lengths, *keep, *c_all, *h_all, *wh, *wht, *projt, *peep;
  float forget_bias;
  const void *dout, *dcfin, *dhfin;
  int steps, batch, units, out_dim;
  void *dgates, *cnew_st, *outb_st, *doutp_st, *dc_in, *dh_in;
  void *dwh, *dproj, *dpeep, *scratch;
  cudaStream_t stream;
};

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
  float* proj_partial = wh_partial + (size_t)wgrad_splits(rows, 2, P, 4 * H) * 2 * P * 4 * H;
  float* peep_partial = proj_partial + (size_t)wgrad_splits(rows, 2, H, P) * 2 * H * P;
  const int B2 = 2 * a.batch;
  err = wgrad(PrevKept<S>{(const S*)a.h_all, (const float*)a.keep, a.batch, P},
              Rows<S>{(const S*)a.dgates, B2, a.batch, 4 * H}, bf16, a.steps, 2,
              a.batch, P, 4 * H, wh_partial, a.dwh, a.stream);
  if (err != cudaSuccess) return err;
  if (a.projt) {
    err = wgrad(Rows<float>{(const float*)a.outb_st, B2, a.batch, H},
                Rows<float>{(const float*)a.doutp_st, B2, a.batch, P}, bf16, a.steps, 2,
                a.batch, H, P, proj_partial, a.dproj, a.stream);
    if (err != cudaSuccess) return err;
  }
  if (a.peep) {
    const int chunks = cdiv(a.steps * a.batch, kPeepRows);
    peep_partial_kernel<S><<<dim3(chunks, 2), 256, 0, a.stream>>>(
        (const S*)a.dgates, (const S*)a.c_all, (const float*)a.cnew_st,
        (const float*)a.keep, a.steps, a.batch, H, peep_partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    split_sum_kernel<<<264, 256, 0, a.stream>>>(peep_partial, chunks,
                                                (size_t)2 * 3 * H, (float*)a.dpeep);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

#define LSTM_BWD_PACK                                                         \
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
