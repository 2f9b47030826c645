// Kernel A: one BLSTM layer's whole-sequence forward, both directions.
//
// Replaces the TPU kernel lstm_ctc_tpu/ops/lstm_pallas.py _make_fwd_kernel
// (:57-131), launched by pallas_fwd (:474) from bilstm_dual_scan_fused
// (:694).  Per step and direction: gates = gx[t] + h·wh, TF gate order
// (i, j, f, o) with peepholes on i, f from c_prev and on o from c_new,
// sigmoid(f + forget_bias), out = sigmoid(o)·tanh(c_new), the projection,
// then dynamic_rnn masking (c and h freeze past the length, out is zero
// there) and the packed-row reset (keep = 0 zeroes the carry first).
//
// What bounds it on the H100: the recurrence is sequential, so each step's
// latency is what counts.  A step needs the direction's recurrent and
// projection weights (320x1280 + 320x320: 1.0 MB in bf16).  The TPU kernel
// keeps them in VMEM; one block here has at most 227 KB of shared memory,
// and a block that re-reads them from L2 every step spends ~30 us a step
// (measured, PERF.md).
//
// Design: a thread-block cluster of 8 blocks per (direction, tile of R
// batch rows) owns the whole time loop.  Block q of a cluster owns hidden
// units [q·US, (q+1)·US) (all four gates of them) and projection columns
// [q·PS, (q+1)·PS); its slices of wh and proj are copied into its shared
// memory once and stay there.  Per step:
//   a. gate sums: the full rounded h [R, P] times the wh slice;
//   b. the cell update of the owned units; the rounded cell output is
//      staged and written into every block of the cluster (distributed
//      shared memory, 16-byte stores);
//   c. cluster barrier;
//   d. the owned projection columns from the full cell output;
//   e. masking; the new rounded h slice is written into every block;
//   f. cluster barrier.
// Without a projection (P == H) the cell output is the step output, and the
// cluster barriers sit after a and after b.  Operands of both products are
// rounded to the compute dtype; sums, the carry and every output stay
// float32.  In bf16 both products run on the tensor cores (ldmatrix and
// mma.sync m16n8k16, h padded to 16 rows), and the slices (~140 KB at
// H = P = 320, the recipes' widest) must fit in shared memory.  In f32,
// which must not round to TF32, they are FMA split over all threads (4
// columns and a slice of k each), and the slices are read from L2 at every
// width (at the flagship size they do not fit in shared memory).
//
// One bf16 block fills an SM, and only so many 8-block clusters are
// resident at once (14 on an H100 SXM): the launcher asks the occupancy API
// and takes the smallest R of {4, 6, 8} whose 2·ceil(B/R) clusters all fit,
// so the grid runs in one wave (B = 32: R = 6, 12 clusters).
//
// The wrapper lays the weights out per slice ([2, 8, P16, 4, US] and
// [2, 8, H16, PS]: US a multiple of 8, PS of 16, the depths P16 and H16
// rounded up to 16, zero-padded).  The kernel allocates nothing and
// launches on the caller's stream.  c_all and h_all (the per-step states a
// backward pass needs) are written only when non-null, in float32 or, with
// states_bf16, in bfloat16 (the store dtype of lstm_pallas.py:483-484).

#include "lstm_cluster.cuh"

namespace {

template <typename T, int R>
__global__ void __launch_bounds__(kThreads) lstm_fwd_kernel(
    const float* __restrict__ gx,      // [T, 2B, 4H], forward rows first
    const int* __restrict__ lengths,   // [B]
    const float* __restrict__ keep,    // [T, B] or null
    const T* __restrict__ wh_sl,       // [2, 8, P16, 4, US]
    const T* __restrict__ proj_sl,     // [2, 8, H16, PS] or null (P == H)
    const float* __restrict__ peep,    // [2, 3, H] or null
    float forget_bias, int steps, int batch, int units, int out_dim,
    float* __restrict__ out,           // [T, 2B, P]
    void* __restrict__ c_all,          // [T, 2B, H] or null
    void* __restrict__ h_all,          // [T, 2B, P] or null
    bool states_bf16,                  // c_all, h_all in bfloat16
    float* __restrict__ cfin,          // [2B, H]
    float* __restrict__ hfin) {        // [2B, P]
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int dir = blockIdx.y;
  const int b0 = (blockIdx.x / kCluster) * R;
  const int nr = min(R, batch - b0);
  const int H = units, P = out_dim;
  const bool has_proj = proj_sl != nullptr;
  const Plan pl = plan<T>(H, P, has_proj, R);
  const int US = pl.us, PS = pl.ps, G = 4 * US, own = pl.own, prow = pl.prow;
  const int u0 = q * US, nu = max(0, min(US, H - u0));
  const int p0 = q * PS, np = max(0, min(PS, P - p0));
  const int tid = threadIdx.x;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* hq = reinterpret_cast<T*>(smem_raw);                    // [arow][QS] h
  T* cellf = reinterpret_cast<T*>(smem_raw + pl.off_cell);   // [arow][HS]
  float* c_own = reinterpret_cast<float*>(smem_raw + pl.off_c);  // [R][US]
  float* h_own = reinterpret_cast<float*>(smem_raw + pl.off_h);  // [R][own]
  T* stage = reinterpret_cast<T*>(smem_raw + pl.off_stage);  // [R][US or PS]
  float* part = reinterpret_cast<float*>(smem_raw + pl.off_part);
  T* wres = reinterpret_cast<T*>(smem_raw + pl.base_bytes);  // bf16 slices

  const size_t slot = (size_t)dir * kCluster + q;
  const size_t wh_elems = (size_t)round_up(P, 16) * G;
  const size_t pj_elems = has_proj ? (size_t)round_up(H, 16) * PS : 0;
  const T* wh_g = wh_sl + slot * wh_elems;
  const T* pj_g = has_proj ? proj_sl + slot * pj_elems : nullptr;
  T* wh_s = wres;  // the shared-memory copies (bf16 only)
  T* pj_s = wres + (size_t)round_up(P, 16) * pl.lwa;
  if constexpr (kMma<T>) {
    copy_rows(wh_s, pl.lwa, wh_g, G, round_up(P, 16));
    if (has_proj) copy_rows(pj_s, pl.lwd, pj_g, PS, round_up(H, 16));
  }
  const T zero = Dtype<T>::from_float(0.0f);
  for (int i = tid; i < pl.arow * pl.qs; i += kThreads) hq[i] = zero;
  for (int i = tid; i < pl.arow * pl.hs; i += kThreads) cellf[i] = zero;
  for (int i = tid; i < R * US; i += kThreads) c_own[i] = 0.0f;
  for (int i = tid; i < R * own; i += kThreads) h_own[i] = 0.0f;
  const float* pd = peep ? peep + (size_t)dir * 3 * H : nullptr;

  // phase b: thread (rb, jb) owns one unit of one row; its gx is fetched
  // a step ahead
  const int rb = tid / US, jb = tid - rb * US;
  const bool in_b = tid < R * US && rb < nr;
  const bool own_b = in_b && jb < nu;
  const int ub = u0 + jb;
  const int len_b = own_b ? lengths[b0 + rb] : 0;
  float gnext[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (own_b && steps > 0) {
    const float* g = gx + ((size_t)dir * batch + b0 + rb) * 4 * H;
#pragma unroll
    for (int k = 0; k < 4; ++k) gnext[k] = g[k * H + ub];
  }
  cluster.sync();  // every block is resident and initialised

  for (int t = 0; t < steps; ++t) {
    const size_t row0 = (size_t)t * 2 * batch + (size_t)dir * batch + b0;

    // 0. packed-row reset of the carry (the same on every block)
    if (keep) {
      for (int i = tid; i < nr * pl.qs; i += kThreads) {
        const float kp = keep[(size_t)t * batch + b0 + i / pl.qs];
        hq[i] = Dtype<T>::from_float(Dtype<T>::to_float(hq[i]) * kp);
      }
      for (int i = tid; i < nr * US; i += kThreads)
        c_own[i] *= keep[(size_t)t * batch + b0 + i / US];
      for (int i = tid; i < nr * own; i += kThreads)
        h_own[i] *= keep[(size_t)t * batch + b0 + i / own];
    }
    __syncthreads();

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
          for (int s = 0; s < pl.gates.slices; ++s)
            v += part[((size_t)s * prow + rb) * G + k * US + jb];
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
        const float m = t < len_b ? 1.0f : 0.0f;
        const float cv = m * cn + (1.0f - m) * cp;
        c_own[ib] = cv;
        if (c_all) put_state(c_all, (row0 + rb) * H + ub, cv, states_bf16);
        if (has_proj) {
          share = o;
        } else {
          const float hv = m * o + (1.0f - m) * h_own[ib];
          h_own[ib] = hv;
          out[(row0 + rb) * P + ub] = m * o;
          if (h_all) put_state(h_all, (row0 + rb) * P + ub, hv, states_bf16);
          share = hv;
        }
        if (t + 1 < steps) {
          const float* g = gx + (row0 + 2 * (size_t)batch + rb) * 4 * H;
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

    // e. masking; share the new h slice
    for (int i = tid; i < nr * PS; i += kThreads) {
      const int r = i / PS, j = i - r * PS;
      float share = 0.0f;
      if (j < np) {
        const int p = p0 + j;
        float o = 0.0f;
        for (int s = 0; s < pl.proj.slices; ++s)
          o += part[((size_t)s * prow + r) * PS + j];
        const float m = t < lengths[b0 + r] ? 1.0f : 0.0f;
        const float hv = m * o + (1.0f - m) * h_own[i];
        h_own[i] = hv;
        out[(row0 + r) * P + p] = m * o;
        if (h_all) put_state(h_all, (row0 + r) * P + p, hv, states_bf16);
        share = hv;
      }
      stage[i] = Dtype<T>::from_float(share);
    }
    __syncthreads();
    share_slice(cluster, stage, nr, PS, hq, pl.qs, p0);
    cluster.sync();
  }

  const size_t frow = (size_t)dir * batch + b0;
  for (int i = tid; i < nr * US; i += kThreads) {
    const int r = i / US, j = i - r * US;
    if (j < nu) cfin[(frow + r) * H + u0 + j] = c_own[i];
  }
  const int own_n = has_proj ? np : nu, own_0 = has_proj ? p0 : u0;
  for (int i = tid; i < nr * own; i += kThreads) {
    const int r = i / own, j = i - r * own;
    if (j < own_n) hfin[(frow + r) * P + own_0 + j] = h_own[i];
  }
}

struct Args {
  const void *gx, *lengths, *keep, *wh_sl, *proj_sl, *peep;
  float forget_bias;
  int steps, batch, units, out_dim;
  void *out, *c_all, *h_all;
  bool states_bf16;
  void *cfin, *hfin;
  cudaStream_t stream;
};

// Launch with R rows per cluster.  Unless `force`, first ask the occupancy
// API whether all 2·ceil(B/R) clusters fit at once, and launch nothing
// (*launched = false) if they do not.
template <typename T, int R>
cudaError_t launch_rows(const Args& a, bool force, bool* launched) {
  *launched = false;
  const bool has_proj = a.proj_sl != nullptr;
  const Plan pl = plan<T>(a.units, a.out_dim, has_proj, R);
  if (R * pl.us > kThreads) return cudaErrorInvalidValue;
  const size_t smem = pl.base_bytes + pl.weight_bytes;
  if (smem > kMaxSmemPerBlock) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  const int clusters = 2 * cdiv(a.batch, R);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * cdiv(a.batch, R), 2, 1);
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
    err = cudaOccupancyMaxActiveClusters(&fit, (const void*)lstm_fwd_kernel<T, R>, &cfg);
    if (err != cudaSuccess) return err;
    if (fit < clusters) return cudaSuccess;
  }
  err = cudaLaunchKernelEx(
      &cfg, lstm_fwd_kernel<T, R>, (const float*)a.gx, (const int*)a.lengths,
      (const float*)a.keep, (const T*)a.wh_sl, (const T*)a.proj_sl,
      (const float*)a.peep, a.forget_bias, a.steps, a.batch, a.units,
      a.out_dim, (float*)a.out, a.c_all, a.h_all, a.states_bf16,
      (float*)a.cfin, (float*)a.hfin);
  if (err != cudaSuccess) return err;
  *launched = true;
  return cudaGetLastError();
}

template <typename T>
int launch(int device, const Args& a) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (a.batch <= 0) return cudaSuccess;
  if (a.units <= 0 || a.out_dim <= 0 || (!a.proj_sl && a.out_dim != a.units))
    return cudaErrorInvalidValue;
  bool launched = false;
  err = launch_rows<T, 4>(a, false, &launched);
  if (err != cudaSuccess || launched) return err;
  err = launch_rows<T, 6>(a, false, &launched);
  if (err != cudaSuccess || launched) return err;
  return launch_rows<T, 8>(a, true, &launched);
}

}  // namespace

#define LSTM_FWD_ARGS                                                          \
  int device, const void *gx, const void *lengths, const void *keep,          \
      const void *wh_sl, const void *proj_sl, const void *peep,               \
      float forget_bias, int steps, int batch, int units, int out_dim,        \
      void *out, void *c_all, void *h_all, int states_bf16, void *cfin,       \
      void *hfin, void *stream
#define LSTM_FWD_PACK                                                          \
  Args{gx, lengths, keep, wh_sl, proj_sl, peep, forget_bias, steps, batch,    \
       units, out_dim, out, c_all, h_all, states_bf16 != 0, cfin, hfin,       \
       (cudaStream_t)stream}

extern "C" int lstm_fwd_f32(LSTM_FWD_ARGS) {
  return launch<float>(device, LSTM_FWD_PACK);
}

extern "C" int lstm_fwd_bf16(LSTM_FWD_ARGS) {
  return launch<__nv_bfloat16>(device, LSTM_FWD_PACK);
}

extern "C" int lstm_fwd_cluster_size() { return kCluster; }

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
