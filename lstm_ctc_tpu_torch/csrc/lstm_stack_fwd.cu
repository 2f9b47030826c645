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
// Design: K1's cluster machinery (lstm_cluster.cuh).  One 8-block cluster
// per tile of R batch rows owns those rows through the whole stack, layer
// after layer.  Rows never interact, so clusters never wait on each other:
// no flags, no co-residency requirement, no possible deadlock.  For each
// layer l >= 1 a block first computes its units' input product in(s)·wx_l +
// bias_l for every s (off the recurrence: in is known, layer l-1 is done),
// with wx_l's slice staged in the shared memory that wh_l's slice takes
// next, into the float32 scratch gxl (in bf16, 16 (step, row) pairs to a
// tensor-core tile, each warp a 16-column tile over the whole depth); then
// it loads wh_l and proj_l's slices and runs K1's step loop over s with gxl
// as its gx.  A layer's float32
// chain goes to a ping-pong scratch (the last layer's is `out`), which the
// next layer reads for its input product and its residual.  The sequential
// chain is L·S steps, where the wavefront's is S: a layer pipeline (one
// cluster per layer and row tile, chains passed through flags) is later
// work.  The input projection of layer 0 (gx0) is a GEMM outside, as it is
// outside the TPU kernel; gx0 stays float32 here (JAX rounds it to the
// compute dtype, :670; a bfloat16-only difference, ROADMAP queue 3).
//
// Operands of every product are rounded to the compute dtype; sums, the
// carries and `out` stay float32; chain, c_all and h_all are written in the
// store dtype (float32 or, with states_bf16, bfloat16) when non-null.

#include "lstm_cluster.cuh"

namespace {

// The input product of one 16-row tile on the tensor cores: a is [16][lda]
// bf16 in shared memory, w [depth rounded to 16][cols] bf16 with row stride
// ldw.  A warp owns a 16-column tile and the whole depth, and hands each sum
// (row, column, value) to `put`: no partial sums to add.
template <typename Put>
__device__ __forceinline__ void input_tile(const __nv_bfloat16* a, int lda,
                                           int depth, const __nv_bfloat16* w,
                                           int ldw, int cols, Put put) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* a_lane = a + (lane & 15) * lda + (lane >> 4) * 8;
  const __nv_bfloat16* w_lane = w + (size_t)(lane & 15) * ldw + (lane >> 4) * 8;
  for (int n = threadIdx.x / 32; n < cols / 16; n += kWarps) {
    float d[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int k = 0; k < cdiv(depth, 16); ++k) {
      uint32_t fa[4], fb[4];
      ldsm_x4(fa, a_lane + k * 16);
      ldsm_x4_trans(fb, w_lane + (size_t)k * 16 * ldw + n * 16);
      mma_16816(d[0], fa, fb[0], fb[1]);
      mma_16816(d[1], fa, fb[2], fb[3]);
    }
    // lane holds rows lane / 4 and + 8, columns 2·(lane % 4) and + 1 of
    // each 8-column half
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        put((lane >> 2) + 8 * (e >> 1), n * 16 + 8 * h + 2 * (lane & 3) + (e & 1),
            d[h][e]);
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads) stack_fwd_kernel(
    const int* __restrict__ seed,       // [1] or null (no dropout)
    const float* __restrict__ gx0,      // [S, B, 4H] layer 0's x·wx0 + b0
    const float* __restrict__ mask,     // [S, L·B]
    const T* __restrict__ wx_sl,        // [L, 8, P16, 4, US] (layer 0 unread)
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
    float* __restrict__ gxl,            // scratch [S, B, 4H]
    float* __restrict__ in32) {         // scratch [2, S, B, P]
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / kCluster) * R;
  const int nr = min(R, batch - b0);
  const int H = units, P = out_dim, LB = layers * batch;
  const bool has_proj = proj_sl != nullptr;
  const Plan pl = plan<T>(H, P, has_proj, R);
  const int US = pl.us, PS = pl.ps, G = 4 * US, own = pl.own, prow = pl.prow;
  const int u0 = q * US, nu = max(0, min(US, H - u0));
  const int p0 = q * PS, np = max(0, min(PS, P - p0));
  const int own_n = has_proj ? np : nu, own_0 = has_proj ? p0 : u0;
  const int tid = threadIdx.x;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* hq = reinterpret_cast<T*>(smem_raw);                    // [arow][QS] h
  T* cellf = reinterpret_cast<T*>(smem_raw + pl.off_cell);   // [arow][HS]
  float* c_own = reinterpret_cast<float*>(smem_raw + pl.off_c);  // [R][US]
  float* h_own = reinterpret_cast<float*>(smem_raw + pl.off_h);  // [R][own]
  T* stage = reinterpret_cast<T*>(smem_raw + pl.off_stage);  // [R][US or PS]
  float* part = reinterpret_cast<float*>(smem_raw + pl.off_part);
  T* wh_s = reinterpret_cast<T*>(smem_raw + pl.base_bytes);  // bf16 slices
  T* pj_s = wh_s + (size_t)round_up(P, 16) * pl.lwa;

  const size_t wh_elems = (size_t)round_up(P, 16) * G;
  const size_t pj_elems = has_proj ? (size_t)round_up(H, 16) * PS : 0;
  const size_t plane = (size_t)steps * batch * P;  // one [S, B, P] chain
  const T zero = Dtype<T>::from_float(0.0f);
  const bool drop = seed != nullptr && keep_prob < 1.0f;
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;
  const float inv_keep = 1.0f / keep_prob;

  // phase b: thread (rb, jb) owns one unit of one row
  const int rb = tid / US, jb = tid - rb * US;
  const bool in_b = tid < R * US && rb < nr;
  const bool own_b = in_b && jb < nu;
  const int ub = u0 + jb;

  for (int l = 0; l < layers; ++l) {
    const size_t slot = (size_t)l * kCluster + q;
    const size_t lrow = (size_t)l * batch + b0;  // first row of the tile in [L·B]
    const float* prev = l > 0 ? in32 + (size_t)((l - 1) & 1) * plane : nullptr;
    float* next = l == layers - 1 ? out : in32 + (size_t)(l & 1) * plane;
    const bool res = l > 0 && ((residual >> l) & 1);
    const float* pd = peep ? peep + (size_t)l * 3 * H : nullptr;
    const float* aa = aff_a ? aff_a + (size_t)l * P : nullptr;
    const float* ab = aff_b ? aff_b + (size_t)l * P : nullptr;
    const float* gx = gx0;

    // the finished chain value of (step s, row r, column p)
    auto finish = [&](float v, int s, int r, int p) {
      if (drop)
        v *= drop_factor((uint32_t)((size_t)s * LB + lrow + r), (uint32_t)p, sd,
                         keep_prob, inv_keep);
      if (aa) v = v * aa[p] + ab[p];
      return v;
    };

    // 1. layer l >= 1: gxl[s] = in(s)·wx_l + bias_l for the owned units,
    // `per` steps at a time: the rows of hq are (step, row) pairs
    if (l > 0) {
      const T* wx_g = wx_sl + slot * wh_elems;
      if constexpr (kMma<T>) copy_rows(wh_s, pl.lwa, wx_g, G, round_up(P, 16));
      const int per = pl.arow / R;
      for (int s0 = 0; s0 < steps; s0 += per) {
        for (int i = tid; i < pl.arow * pl.qs; i += kThreads) {
          const int row = i / pl.qs, k = i - row * pl.qs;
          const int s = s0 + row / R, r = row % R;
          float v = 0.0f;
          if (row < per * R && s > 0 && s < steps && r < nr && k < P)
            v = prev[((size_t)(s - 1) * batch + b0 + r) * P + k];
          hq[i] = Dtype<T>::from_float(v);
        }
        __syncthreads();
        if constexpr (kMma<T>) {
          input_tile(hq, pl.qs, P, wh_s, pl.lwa, G, [&](int row, int c, float v) {
            const int s = s0 + row / R, r = row % R, k = c / US, j = c - k * US;
            if (row < per * R && s < steps && r < nr && j < nu)
              gxl[((size_t)s * batch + b0 + r) * 4 * H + k * H + u0 + j] =
                  v + bias[(size_t)l * 4 * H + k * H + u0 + j];
          });
        } else {
          fma_product<R>(hq, pl.qs, P, wx_g, G, G, pl.gates, part);
          __syncthreads();
          for (int i = tid; i < nr * G; i += kThreads) {
            const int r = i / G, c = i - r * G, k = c / US, j = c - k * US;
            if (j < nu) {
              float v = bias[(size_t)l * 4 * H + k * H + u0 + j];
              for (int sl = 0; sl < pl.gates.slices; ++sl)
                v += part[((size_t)sl * prow + r) * G + c];
              gxl[((size_t)s0 * batch + b0 + r) * 4 * H + k * H + u0 + j] = v;
            }
          }
        }
        __syncthreads();
      }
      gx = gxl;
    }

    // 2. the layer's recurrent weights and its initial states
    const T* wh_g = wh_sl + slot * wh_elems;
    const T* pj_g = has_proj ? proj_sl + slot * pj_elems : nullptr;
    if constexpr (kMma<T>) {
      copy_rows(wh_s, pl.lwa, wh_g, G, round_up(P, 16));
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
    float gnext[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (own_b && steps > 0) {
      const float* g = gx + (size_t)(b0 + rb) * 4 * H;
#pragma unroll
      for (int k = 0; k < 4; ++k) gnext[k] = g[k * H + ub];
    }
    cluster.sync();  // every block's states and weights are in place

    // 3. the step loop (K1's, with the chain and the layer's rows)
    for (int s = 0; s < steps; ++s) {
      const size_t srow = (size_t)s * LB + lrow;    // rows of [S, L·B, ·]
      const size_t brow = (size_t)s * batch + b0;   // rows of [S, B, ·]

      // a. gate sums for the owned units
      if constexpr (kMma<T>)
        mma_product(hq, pl.qs, P, wh_s, pl.lwa, G, pl.gates, part);
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
            if (res && s > 0) ch += prev[(brow - batch + rb) * P + ub];
            ch = finish(ch, s, rb, ub);
            next[(brow + rb) * P + ub] = ch;
            if (chain) put_state(chain, (srow + rb) * P + ub, ch, states_bf16);
            share = hv;
          }
          if (s + 1 < steps) {
            const float* g = gx + (brow + batch + rb) * 4 * H;
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
        mma_product(cellf, pl.hs, H, pj_s, pl.lwd, PS, pl.proj, part);
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
          if (res && s > 0) ch += prev[(brow - batch + r) * P + p];
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

    // 4. the layer's final states; its chain is visible to the whole
    // cluster before the next layer reads it
    for (int i = tid; i < nr * US; i += kThreads) {
      const int r = i / US, j = i - r * US;
      if (j < nu) cfin[(lrow + r) * H + u0 + j] = c_own[i];
    }
    for (int i = tid; i < nr * own; i += kThreads) {
      const int r = i / own, j = i - r * own;
      if (j < own_n) hfin[(lrow + r) * P + own_0 + j] = h_own[i];
    }
    __threadfence();
    cluster.sync();
  }
}

struct StackArgs {
  const void *seed, *gx0, *mask, *wx_sl, *wh_sl, *proj_sl, *bias, *peep;
  const void *cinit, *hinit, *aff_a, *aff_b;
  float forget_bias, keep_prob;
  int residual, steps, layers, batch, units, out_dim;
  void *out, *chain, *c_all, *h_all;
  bool states_bf16;
  void *cfin, *hfin, *gxl, *in32;
  cudaStream_t stream;
};

// Launch with R rows per cluster.  Clusters never wait on each other, so
// any grid is safe; unless `force`, first ask the occupancy API whether all
// ceil(B/R) clusters fit at once (one wave), and launch nothing
// (*launched = false) if they do not.
template <typename T, int R>
cudaError_t launch_rows(const StackArgs& a, bool force, bool* launched) {
  *launched = false;
  const bool has_proj = a.proj_sl != nullptr;
  const Plan pl = plan<T>(a.units, a.out_dim, has_proj, R);
  if (R * pl.us > kThreads) return cudaErrorInvalidValue;
  const size_t smem = pl.base_bytes + pl.weight_bytes;
  if (smem > kMaxSmemPerBlock) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      stack_fwd_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  const int clusters = cdiv(a.batch, R);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * clusters, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!force) {
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, (const void*)stack_fwd_kernel<T, R>, &cfg);
    if (err != cudaSuccess) return err;
    if (fit < clusters) return cudaSuccess;
  }
  err = cudaLaunchKernelEx(
      &cfg, stack_fwd_kernel<T, R>, (const int*)a.seed, (const float*)a.gx0,
      (const float*)a.mask, (const T*)a.wx_sl, (const T*)a.wh_sl,
      (const T*)a.proj_sl, (const float*)a.bias, (const float*)a.peep,
      (const float*)a.cinit, (const float*)a.hinit, (const float*)a.aff_a,
      (const float*)a.aff_b, a.forget_bias, a.keep_prob, a.residual, a.steps,
      a.layers, a.batch, a.units, a.out_dim, (float*)a.out, a.chain, a.c_all,
      a.h_all, a.states_bf16, (float*)a.cfin, (float*)a.hfin, (float*)a.gxl,
      (float*)a.in32);
  if (err != cudaSuccess) return err;
  *launched = true;
  return cudaGetLastError();
}

template <typename T>
int launch(int device, const StackArgs& a) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (a.batch <= 0 || a.steps <= 0 || a.layers <= 0) return cudaSuccess;
  if (a.units <= 0 || a.out_dim <= 0 || (!a.proj_sl && a.out_dim != a.units) ||
      (a.aff_a == nullptr) != (a.aff_b == nullptr))
    return cudaErrorInvalidValue;
  bool launched = false;
  err = launch_rows<T, 4>(a, false, &launched);
  if (err != cudaSuccess || launched) return err;
  err = launch_rows<T, 6>(a, false, &launched);
  if (err != cudaSuccess || launched) return err;
  return launch_rows<T, 8>(a, true, &launched);
}

}  // namespace

#define LSTM_STACK_FWD_ARGS                                                    \
  int device, const void *seed, const void *gx0, const void *mask,            \
      const void *wx_sl, const void *wh_sl, const void *proj_sl,              \
      const void *bias, const void *peep, const void *cinit,                  \
      const void *hinit, const void *aff_a, const void *aff_b,                \
      float forget_bias, float keep_prob, int residual, int steps,            \
      int layers, int batch, int units, int out_dim, void *out, void *chain,  \
      void *c_all, void *h_all, int states_bf16, void *cfin, void *hfin,      \
      void *gxl, void *in32, void *stream
#define LSTM_STACK_FWD_PACK                                                    \
  StackArgs{seed, gx0, mask, wx_sl, wh_sl, proj_sl, bias, peep, cinit, hinit, \
            aff_a, aff_b, forget_bias, keep_prob, residual, steps, layers,    \
            batch, units, out_dim, out, chain, c_all, h_all,                  \
            states_bf16 != 0, cfin, hfin, gxl, in32, (cudaStream_t)stream}

extern "C" int lstm_stack_fwd_f32(LSTM_STACK_FWD_ARGS) {
  return launch<float>(device, LSTM_STACK_FWD_PACK);
}

extern "C" int lstm_stack_fwd_bf16(LSTM_STACK_FWD_ARGS) {
  return launch<__nv_bfloat16>(device, LSTM_STACK_FWD_PACK);
}
