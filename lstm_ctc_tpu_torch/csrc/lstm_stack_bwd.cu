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
//   dz      = dgates·[wx_l; wh_l]ᵀ,
//   din     = residual_l·dchain + dz[:, :P]   (layer l's input cotangent),
//   dh_prev = (1-m)·dh + dz[:, P:].
// c_prev and h_prev are the stored states of step s-1 (cinit and hinit,
// rounded to the store dtype, at s = 0), in_prev the stored chain of layer
// l-1 at s-1 (zero for layer 0, whose input product gx0 is outside).  dgates
// of every layer is emitted in the store dtype (layer 0's rows are dgx0, for
// the input projection's backward outside, as XLA does it outside the TPU
// kernel), with the stashes the weight gradients need: c_new, the
// pre-projection output out_blk and dout_p (the TPU kernel keeps them in
// VMEM).  After the recurrence, this file's own kernels sum over (s, b):
//   dwz[l]   = Σ [in_prev, h_prev]ᵀ·dgates     (wgrad_kernel, shared with K2),
//   dproj[l] = Σ out_blkᵀ·dout_p               (wgrad_kernel),
//   dbias[l] = Σ dgates, and the peephole sums Σ dg_i·c_prev, Σ dg_f·c_prev,
//   Σ dg_o·c_new                               (stack_colsum_kernel),
// split over the rows with the partials added in a fixed order; no atomics.
// Operands of every product are rounded to the compute dtype; sums, the
// carries and every output but dgates stay float32, and the float32 path
// uses FMA only, never TF32.
//
// What bounds it on the H100: as for K2, the reverse recurrence is
// sequential; a step reads the layer's [wx; wh] twice (as wz and wzᵀ) and
// proj once, 3.3 MB in bf16 at H = P = 320.  Design: K2's (lstm_bwd_common.
// cuh): one block per (layer, kRows batch rows) walks s = S-1 .. 0 and
// reads the weights from L2 at every step.  The layers run as a pipeline,
// as the reverse wavefront does: layer l at step s needs layer l+1's din
// at s+1, which that layer's block writes to a float32 scratch [L, S, B, P]
// and announces by counting its finished steps in a flag (a fence, then an
// atomic store; the reader polls with atomics and reads din from L2).  A
// block only ever waits on the layer above, and every block of a launch is
// resident at once (the launcher asks the occupancy API and splits the
// batch into launches that fit, and launches cooperatively, which the card
// refuses rather than run a grid it cannot hold), so the waits cannot
// deadlock.

#include <type_traits>

#include "lstm_bwd_common.cuh"

namespace {

// Shared-memory plan (floats): operands and carries, then the partials.
struct Plan {
  size_t a_z, a_dp, cp, dc, dh, dp, dch, gates, dob, a_dg, part, total;
};

__host__ __device__ Plan plan(int H, int P) {
  Plan p;
  const int G = 4 * H;
  size_t o = 0;
  p.a_z = o;   o += (size_t)kRows * 2 * P;
  p.a_dp = o;  o += (size_t)kRows * P;
  p.cp = o;    o += (size_t)kRows * H;
  p.dc = o;    o += (size_t)kRows * H;
  p.dh = o;    o += (size_t)kRows * P;
  p.dp = o;    o += (size_t)kRows * P;
  p.dch = o;   o += (size_t)kRows * P;
  p.gates = o; o += (size_t)kRows * G;
  p.dob = o;   o += (size_t)kRows * H;
  p.a_dg = o;  o += (size_t)kRows * G;
  o = (o + 3) / 4 * 4;  // 16-byte aligned partials
  p.part = o;
  const size_t pg = (size_t)split_of(G, 2 * P).slices * G;
  const size_t pp = (size_t)split_of(H, P).slices * H;
  const size_t pz = (size_t)split_of(2 * P, G).slices * 2 * P;
  size_t most = pg > pp ? pg : pp;
  most = most > pz ? most : pz;
  p.total = o + kRows * most;
  return p;
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads) stack_bwd_kernel(
    const int* __restrict__ seed,     // [1] or null (no dropout)
    const float* __restrict__ gx0,    // [S, B, 4H]
    const float* __restrict__ mask,   // [S, L·B]
    const S* __restrict__ chain,      // [S, L·B, P] store dtype
    const S* __restrict__ c_all,      // [S, L·B, H] store dtype
    const S* __restrict__ h_all,      // [S, L·B, P] store dtype
    const float* __restrict__ cinit,  // [L·B, H]
    const float* __restrict__ hinit,  // [L·B, P]
    const T* __restrict__ wz,         // [L, 2P, 4H]
    const T* __restrict__ wzt,        // [L, 4H, 2P]
    const T* __restrict__ projt,      // [L, P, H] or null (P == H)
    const float* __restrict__ bias,   // [L, 4H]
    const float* __restrict__ peep,   // [L, 3, H] or null
    float forget_bias, float keep_prob, int residual,
    const float* __restrict__ dout,   // [S, B, P]
    const float* __restrict__ dcfin,  // [L·B, H]
    const float* __restrict__ dhfin,  // [L·B, P]
    int steps, int layers, int batch, int H, int P,
    S* __restrict__ dgates,           // [S, L·B, 4H]
    float* __restrict__ cnew_st,      // [S, L·B, H]
    float* __restrict__ outb_st,      // [S, L·B, H] or null
    float* __restrict__ doutp_st,     // [S, L·B, P] or null
    float* __restrict__ dcinit,       // [L·B, H]
    float* __restrict__ dhinit,       // [L·B, P]
    float* __restrict__ din,          // [L, S, B, P] (layer 0's unwritten)
    float* __restrict__ dc_in,        // [S, L·B, H] or null
    float* __restrict__ dh_in,        // [S, L·B, P] or null
    int row0,                         // the first batch row of this launch
    int* __restrict__ flags) {        // [L, gridDim.x], zero at launch
  // block (x, y) owns rows row0 + x·kRows .. of layer L-1-y: the layers
  // above come first in the grid's order
  const int b0 = row0 + blockIdx.x * kRows;
  const int l = layers - 1 - blockIdx.y;
  const int nr = min(kRows, batch - b0);
  const int G = 4 * H, LB = layers * batch, tid = threadIdx.x;
  const bool has_proj = projt != nullptr;
  const Plan pl = plan(H, P);
  extern __shared__ __align__(16) float sm[];
  float *a_z = sm + pl.a_z, *a_dp = sm + pl.a_dp, *cp = sm + pl.cp;
  float *dc = sm + pl.dc, *dh = sm + pl.dh, *dp = sm + pl.dp;
  float *dch = sm + pl.dch, *gates = sm + pl.gates, *dob = sm + pl.dob;
  float *a_dg = sm + pl.a_dg, *part = sm + pl.part;
  for (int i = tid; i < (int)pl.part; i += kThreads) sm[i] = 0.0f;
  const bool drop = seed != nullptr && keep_prob < 1.0f;
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;
  const float inv_keep = 1.0f / keep_prob;
  const size_t plane = (size_t)steps * batch * P;  // one layer's din
  const int P2 = 2 * P;

  const size_t lrow = (size_t)l * batch + b0;
  const bool res = l > 0 && ((residual >> l) & 1);
  const bool last = l == layers - 1;
  const float* dabove = last ? nullptr : din + (size_t)(l + 1) * plane;
  float* dmine = din + (size_t)l * plane;
  const T* wz_l = wz + (size_t)l * P2 * G;
  const T* wzt_l = wzt + (size_t)l * G * P2;
  const T* pj_l = has_proj ? projt + (size_t)l * P * H : nullptr;
  const float* pd = peep ? peep + (size_t)l * 3 * H : nullptr;
  // layer 0's input slab of wz is zero: its products skip it
  const int zoff = l > 0 ? 0 : P;
  const int zc = P2 - zoff;
  const Split sg = split_of(G, zc), sp = split_of(H, P), sz = split_of(zc, G);
  __syncthreads();
  for (int i = tid; i < nr * H; i += kThreads)
    dc[i] = dcfin[(lrow + i / H) * H + i % H];
  for (int i = tid; i < nr * P; i += kThreads)
    dh[i] = dhfin[(lrow + i / P) * P + i % P];
  __syncthreads();

  int* const above = last ? nullptr : flags + (size_t)(l + 1) * gridDim.x + blockIdx.x;
  int* const mine = flags + (size_t)l * gridDim.x + blockIdx.x;
  for (int s = steps - 1; s >= 0; --s) {
    const size_t srow = (size_t)s * LB + lrow;      // this step's rows
    const size_t brow = (size_t)s * batch + b0;     // rows of [S, B, ·]
    // layer l+1's din at s+1 must be written: it has finished S-1-s
    // steps (its flag counts them)
    if (!last && s + 1 < steps) {
      if (tid == 0) {
        // a wait of seconds means a fault: end the launch with an error
        // rather than hang (a step takes tens of microseconds)
        for (long long spins = 0; atomicAdd(above, 0) < steps - 1 - s; ++spins) {
          if (spins > (1LL << 26)) __trap();
          __nanosleep(64);
        }
        __threadfence();
      }
      __syncthreads();
    }
    // 1. operands: z = [in_prev, h_prev], dout_p, c_prev
    for (int i = tid; i < nr * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      const float m = mask[srow + r];
      const float hp = s > 0 ? ld(h_all, (srow - LB + r) * P + p)
                             : rnd<S>(hinit[(lrow + r) * P + p]);
      const float ip = (l > 0 && s > 0) ? ld(chain, (srow - LB - batch + r) * P + p) : 0.0f;
      a_z[r * P2 + p] = rnd<T>(ip);
      a_z[r * P2 + P + p] = rnd<T>(hp);
      float dcv = 0.0f;
      if (last)
        dcv = dout[(brow + r) * P + p];
      else if (s + 1 < steps)
        dcv = __ldcg(dabove + (brow + batch + r) * P + p);  // from L2
      if (drop)
        dcv *= drop_factor((uint32_t)(srow + r), (uint32_t)p, sd, keep_prob, inv_keep);
      const float v = m * (dcv + dh[i]);
      dp[i] = v;
      a_dp[i] = rnd<T>(v);
      dch[i] = res ? dcv : 0.0f;
      if (doutp_st) doutp_st[(srow + r) * P + p] = v;
      if (dh_in) dh_in[(srow + r) * P + p] = dh[i];
    }
    for (int i = tid; i < nr * H; i += kThreads) {
      const int r = i / H, u = i - r * H;
      cp[i] = s > 0 ? ld(c_all, (srow - LB + r) * H + u)
                    : rnd<S>(cinit[(lrow + r) * H + u]);
      if (dc_in) dc_in[(srow + r) * H + u] = dc[i];
    }
    __syncthreads();
    // 2. the gates, recomputed
    block_product(a_z + zoff, P2, zc, wz_l + (size_t)zoff * G, G, G, part);
    __syncthreads();
    for (int i = tid; i < nr * G; i += kThreads) {
      const int r = i / G, g = i - r * G;
      const float base = l == 0 ? gx0[(brow + r) * G + g] : bias[(size_t)l * G + g];
      gates[i] = base + part_sum(part, sg.slices, G, r, g);
    }
    __syncthreads();
    // 3. dout_blk = dout_p · projᵀ
    if (has_proj) {
      block_product(a_dp, P, P, pj_l, H, H, part);
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
      const float m = mask[srow + r];
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
      dc[i] = dcp;
      const float dgv[4] = {d_i, d_j, d_f, d_o};
      S* dg_row = dgates + (srow + r) * G;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dg_row[k * H + u] = Dtype<S>::from_float(dgv[k]);
        a_dg[r * G + k * H + u] = rnd<T>(dgv[k]);
      }
      cnew_st[(srow + r) * H + u] = cn;
      if (outb_st) outb_st[(srow + r) * H + u] = so * tc;
    }
    __syncthreads();
    // 5. dz = dgates · wzᵀ: din (layers above 0) and dh_prev
    block_product(a_dg, G, G, wzt_l + zoff, P2, zc, part);
    __syncthreads();
    for (int i = tid; i < nr * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      const float m = mask[srow + r];
      dh[i] = (1.0f - m) * dh[i] + part_sum(part, sz.slices, zc, r, zc - P + p);
      if (l > 0) dmine[(brow + r) * P + p] = dch[i] + part_sum(part, sz.slices, zc, r, p);
    }
    // this step's din is visible to the layer below before its flag
    if (l > 0) __threadfence();
    __syncthreads();
    if (l > 0 && tid == 0) atomicExch(mine, steps - s);
  }
  // the carries left after step 0 are the initial states' cotangents
  for (int i = tid; i < nr * H; i += kThreads)
    dcinit[(lrow + i / H) * H + i % H] = dc[i];
  for (int i = tid; i < nr * P; i += kThreads)
    dhinit[(lrow + i / P) * P + i % P] = dh[i];
}

template <typename S>
struct ZPrev {  // z = [in_prev, h_prev], the operand the gates were made from
  const S* chain;
  const S* h_all;
  const float* hinit;
  int lb, batch, P;
  __device__ float operator()(int l, int s, int b, int m) const {
    if (m < P)
      return l > 0 && s > 0
                 ? ld(chain, ((size_t)(s - 1) * lb + (size_t)(l - 1) * batch + b) * P + m)
                 : 0.0f;
    m -= P;
    return s > 0 ? ld(h_all, ((size_t)(s - 1) * lb + (size_t)l * batch + b) * P + m)
                 : rnd<S>(hinit[((size_t)l * batch + b) * P + m]);
  }
};

// partial[chunk][l][4H + 3H]: over kPeepRows rows (s, b) of layer l, the
// bias sums Σ dgates and the peephole sums Σ dg_i·c_prev, Σ dg_f·c_prev,
// Σ dg_o·c_new (c_prev: the stored c of step s-1, cinit rounded at s = 0)
template <typename S>
__global__ void __launch_bounds__(256) stack_colsum_kernel(
    const S* __restrict__ dgates, const S* __restrict__ c_all,
    const float* __restrict__ cinit, const float* __restrict__ cnew,
    int steps, int layers, int batch, int H, float* __restrict__ partial) {
  const int chunk = blockIdx.x, l = blockIdx.y, G = 4 * H, LB = layers * batch;
  const int k0 = chunk * kPeepRows, k1 = min(steps * batch, k0 + kPeepRows);
  float* out = partial + ((size_t)chunk * layers + l) * (G + 3 * H);
  for (int c = threadIdx.x; c < G + 3 * H; c += 256) {
    float v = 0.0f;
    for (int k = k0; k < k1; ++k) {
      const int s = k / batch, b = k - s * batch;
      const size_t row = (size_t)s * LB + (size_t)l * batch + b;
      if (c < G) {
        v += ld(dgates, row * G + c);
        continue;
      }
      const int which = (c - G) / H, u = (c - G) - which * H;
      if (which == 2) {
        v = fmaf(ld(dgates, row * G + 3 * H + u), cnew[row * H + u], v);
      } else {
        const float c0 = s > 0 ? ld(c_all, (row - LB) * H + u)
                               : rnd<S>(cinit[((size_t)l * batch + b) * H + u]);
        v = fmaf(ld(dgates, row * G + 2 * which * H + u), c0, v);
      }
    }
    out[c] = v;
  }
}

// Scratch floats K13 needs: the split partials of both products, the
// column-sum partials, and the layers' step counters (int32).
__host__ size_t scratch_floats(int steps, int layers, int batch, int H, int P) {
  const int rows = steps * batch;
  return (size_t)wgrad_splits(rows, layers, 2 * P, 4 * H) * layers * 2 * P * 4 * H
         + (size_t)wgrad_splits(rows, layers, H, P) * layers * H * P
         + (size_t)cdiv(rows, kPeepRows) * layers * 7 * H
         + (size_t)layers * cdiv(batch, kRows);
}

struct StackArgs {
  const void *seed, *gx0, *mask, *chain, *c_all, *h_all, *cinit, *hinit;
  const void *wz, *wzt, *projt, *bias, *peep;
  float forget_bias, keep_prob;
  int residual;
  const void *dout, *dcfin, *dhfin;
  int steps, layers, batch, units, out_dim;
  void *dgates, *cnew_st, *outb_st, *doutp_st, *dcinit, *dhinit, *din;
  void *dc_in, *dh_in, *dwz, *dproj, *dcols, *scratch;
  cudaStream_t stream;
};

// One launch of the recurrence over rows row0 .. of every layer, as a
// cooperative launch: the card runs every block at once or refuses it.
template <typename T, typename S>
cudaError_t launch_rows(const StackArgs& a, dim3 grid, size_t smem, int row0,
                        int* flags) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, stack_bwd_kernel<T, S>, (const int*)a.seed, (const float*)a.gx0,
      (const float*)a.mask, (const S*)a.chain, (const S*)a.c_all,
      (const S*)a.h_all, (const float*)a.cinit, (const float*)a.hinit,
      (const T*)a.wz, (const T*)a.wzt, (const T*)a.projt,
      (const float*)a.bias, (const float*)a.peep, a.forget_bias, a.keep_prob,
      a.residual, (const float*)a.dout, (const float*)a.dcfin,
      (const float*)a.dhfin, a.steps, a.layers, a.batch, a.units, a.out_dim,
      (S*)a.dgates, (float*)a.cnew_st, (float*)a.outb_st, (float*)a.doutp_st,
      (float*)a.dcinit, (float*)a.dhinit, (float*)a.din, (float*)a.dc_in,
      (float*)a.dh_in, row0, flags);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename S>
int launch(int device, const StackArgs& a) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int H = a.units, P = a.out_dim, L = a.layers;
  if (a.batch <= 0 || a.steps <= 0 || L <= 0) return cudaSuccess;
  if (H <= 0 || P <= 0 || H % 4 || P % 4 || (!a.projt && P != H))
    return cudaErrorInvalidValue;
  const Plan pl = plan(H, P);
  const size_t smem = pl.total * sizeof(float);
  if (smem > kMaxSmemPerBlock) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(stack_bwd_kernel<T, S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = a.steps * a.batch, LB = L * a.batch;
  float* z_partial = (float*)a.scratch;
  float* proj_partial = z_partial + (size_t)wgrad_splits(rows, L, 2 * P, 4 * H) * L * 2 * P * 4 * H;
  float* col_partial = proj_partial + (size_t)wgrad_splits(rows, L, H, P) * L * H * P;
  int* flags = (int*)(col_partial + (size_t)cdiv(rows, kPeepRows) * L * 7 * H);

  // The layers wait on each other through their flags, so every block of
  // a launch must be resident at once: a launch takes as many row pairs
  // as the card holds for all L layers, and a larger batch takes several
  // launches, one after another on the stream.
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stack_bwd_kernel<T, S>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int pairs = per_sm * sms / L;  // row pairs a launch can hold
  if (pairs < 1) return cudaErrorCooperativeLaunchTooLarge;
  for (int row0 = 0; row0 < a.batch; row0 += pairs * kRows) {
    const int nblk = min(pairs, cdiv(a.batch - row0, kRows));
    err = cudaMemsetAsync(flags, 0, sizeof(int) * L * nblk, a.stream);
    if (err != cudaSuccess) return err;
    err = launch_rows<T, S>(a, dim3(nblk, L), smem, row0, flags);
    if (err != cudaSuccess) return err;
  }

  const bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  err = wgrad(ZPrev<S>{(const S*)a.chain, (const S*)a.h_all, (const float*)a.hinit, LB, a.batch, P},
              Rows<S>{(const S*)a.dgates, LB, a.batch, 4 * H}, bf16, a.steps, L, a.batch,
              2 * P, 4 * H, z_partial, a.dwz, a.stream);
  if (err != cudaSuccess) return err;
  if (a.projt) {
    err = wgrad(Rows<float>{(const float*)a.outb_st, LB, a.batch, H},
                Rows<float>{(const float*)a.doutp_st, LB, a.batch, P}, bf16, a.steps, L,
                a.batch, H, P, proj_partial, a.dproj, a.stream);
    if (err != cudaSuccess) return err;
  }
  const int chunks = cdiv(rows, kPeepRows);
  stack_colsum_kernel<S><<<dim3(chunks, L), 256, 0, a.stream>>>(
      (const S*)a.dgates, (const S*)a.c_all, (const float*)a.cinit,
      (const float*)a.cnew_st, a.steps, L, a.batch, H, col_partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_sum_kernel<<<264, 256, 0, a.stream>>>(col_partial, chunks,
                                              (size_t)L * 7 * H, (float*)a.dcols);
  return cudaGetLastError();
}

}  // namespace

#define LSTM_STACK_BWD_ARGS                                                    \
  int device, const void *seed, const void *gx0, const void *mask,            \
      const void *chain, const void *c_all, const void *h_all,                \
      const void *cinit, const void *hinit, const void *wz, const void *wzt,  \
      const void *projt, const void *bias, const void *peep,                  \
      float forget_bias, float keep_prob, int residual, const void *dout,     \
      const void *dcfin, const void *dhfin, int steps, int layers, int batch, \
      int units, int out_dim, int store_bf16, void *dgates, void *cnew_st,    \
      void *outb_st, void *doutp_st, void *dcinit, void *dhinit, void *din,   \
      void *dc_in, void *dh_in, void *dwz, void *dproj, void *dcols,          \
      void *scratch, void *stream
#define LSTM_STACK_BWD_PACK                                                    \
  StackArgs{seed, gx0, mask, chain, c_all, h_all, cinit, hinit, wz, wzt,      \
            projt, bias, peep, forget_bias, keep_prob, residual, dout, dcfin, \
            dhfin, steps, layers, batch, units, out_dim, dgates, cnew_st,     \
            outb_st, doutp_st, dcinit, dhinit, din, dc_in, dh_in, dwz, dproj, \
            dcols, scratch, (cudaStream_t)stream}

extern "C" int lstm_stack_bwd_f32(LSTM_STACK_BWD_ARGS) {
  return store_bf16 ? launch<float, __nv_bfloat16>(device, LSTM_STACK_BWD_PACK)
                    : launch<float, float>(device, LSTM_STACK_BWD_PACK);
}

extern "C" int lstm_stack_bwd_bf16(LSTM_STACK_BWD_ARGS) {
  return store_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(device, LSTM_STACK_BWD_PACK)
                    : launch<__nv_bfloat16, float>(device, LSTM_STACK_BWD_PACK);
}

extern "C" long long lstm_stack_bwd_scratch_floats(int steps, int layers, int batch,
                                                   int units, int out_dim) {
  return (long long)scratch_floats(steps, layers, batch, units, out_dim);
}
