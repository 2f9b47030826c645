// Kernel K3: K2 with the layer's input side folded in.
//
// Replaces the TPU kernel lstm_ctc_tpu/ops/lstm_pallas.py pallas_bwd_fold
// (:544), _make_bwd_kernel with fold_dx=True (:149-154, :163-205, :224-228,
// :373-399, :412-416), launched by the VJP fusedx_bwd (:651-672).  It gives
// everything K2 gives except the dgates stream, and the input side of the
// layer over the dgates its recurrence computes (dg, in the store dtype):
//
//   dwx[g]   = x[g](cdt)ᵀ · dg[g](cdt)      [D, 4H] float32 sums
//   dbias[g] = Σ over (t, b) of dg[g]        [4H]    float32
//   dx[g]    = dg[g](cdt) · wx[g](cdt)ᵀ      [B, T, D] float32 sums,
//                                            rounded to the store dtype
//
// for each direction g, with x[g] the layer's input (g = 0) or its reverse
// (g = 1), laid out [2, B, T, D], and dx in the same layout.
//
// Design.  The recurrence and the recurrent weight gradients are K2's own
// launch (lstm_bwd.cu), which writes dg into a scratch buffer the wrapper
// gives it; the TPU kernel keeps dg in VMEM for the same products.  Then
// two tiled products of this file: one block per (M tile, 128 columns,
// direction, split of the depth) walks its depth in chunks of 64, staging
// both operands in shared memory in the compute dtype (double-buffered,
// one barrier a chunk), with tile_product.cuh's tile products (bf16:
// ldmatrix + mma.sync on the tensor cores; float32: FMA, never TF32).  dx
// has tiles enough to fill the card; dwx has few (200 at the flagship), so
// its rows are split, each split writes its partial sums, and a last pass
// adds them in split order.  The dwx blocks of the first M tile also sum
// dbias from the loaded values before the rounding: each thread keeps one
// column's sum over every other row, and the two sums of a column are
// added in a fixed order.  No atomics: the result does not depend on the
// schedule.
//
// What bounds it on the H100: at the flagship's layers 1-3 (B = 32,
// T = 384, H = P = 320, D = 640) each of the two folded products is
// 2·T·2B·4H·D = 40.3 GFLOP (0.04 ms on the bf16 tensor cores), beside K2's
// recurrence, which is bound by its per-step latency (PERF.md).  The
// products' tiles are fed by plain loads, without TMA or wgmma.

#include "lstm_bwd_entry.cuh"
#include "tile_product.cuh"

namespace {

constexpr int kCols = kMaxV;  // columns of the output per block (N)
constexpr int kChunk = 64;    // depth per staged chunk (K)

template <typename X>
__device__ __forceinline__ float load(const X* p, size_t i) {
  return Dtype<X>::to_float(p[i]);
}

// The rows of one direction are r = t·B + b; dg holds them at row
// t·2B + g·B + b of its [T, 2B, 4H] layout, x and dx at (g·B + b)·T + t of
// their [2, B, T, D] layout.
struct Rows {
  int steps, batch;
  __device__ size_t dg(int g, int r) const {
    const int t = r / batch, b = r - t * batch;
    return (size_t)t * 2 * batch + (size_t)g * batch + b;
  }
  __device__ size_t x(int g, int r) const {
    const int t = r / batch, b = r - t * batch;
    return ((size_t)g * batch + b) * steps + t;
  }
};

// dx[g] = dg[g] · wx[g]ᵀ: M = T·B rows, N = D, K = 4H
template <typename T, typename S>
struct DxProduct {
  Rows rows;
  int M, N, K;
  const S* dg;     // [T, 2B, 4H] store dtype
  const T* wxt;    // [2, 4H, D] compute dtype
  S* dx;           // [2, B, T, D] store dtype

  // as[m][k] = dg row m0 + m, column k0 + k (k fastest: dg rows are
  // contiguous in k)
  __device__ void stage_a(T* as, int ld, int g, int m0, int k0, int k1) const {
    constexpr int kM = Tile<T>::kRows;
    for (int i = threadIdx.x; i < kM * kChunk; i += kThreads) {
      const int m = i / kChunk, k = i - m * kChunk;
      float v = 0.0f;
      if (m0 + m < M && k0 + k < k1) v = load(dg, rows.dg(g, m0 + m) * K + k0 + k);
      as[m * ld + k] = Dtype<T>::from_float(v);
    }
  }
  // bs[k][n] = wxᵀ[g][k0 + k][n0 + n]
  __device__ void stage_b(T* bs, int ld, int g, int k0, int k1, int n0, float&) const {
    for (int i = threadIdx.x; i < kChunk * kCols; i += kThreads) {
      const int k = i / kCols, n = i - k * kCols;
      T v = Dtype<T>::from_float(0.0f);
      if (k0 + k < k1 && n0 + n < N) v = wxt[((size_t)g * K + k0 + k) * N + n0 + n];
      bs[k * ld + n] = v;
    }
  }
  __device__ void finish(const float* zs, int ld, int g, int, int m0, int n0,
                         const float*) const {
    constexpr int kM = Tile<T>::kRows;
    for (int i = threadIdx.x; i < kM * kCols; i += kThreads) {
      const int m = i / kCols, n = i - m * kCols;
      if (m0 + m < M && n0 + n < N)
        dx[rows.x(g, m0 + m) * N + n0 + n] = Dtype<S>::from_float(zs[m * ld + n]);
    }
  }
};

// dwx[g] = x[g]ᵀ · dg[g]: M = D, N = 4H, K = T·B rows; and dbias[g].  The
// rows are split among blocks; each split writes its partial sums.
template <typename T, typename S>
struct DwxProduct {
  Rows rows;
  int M, N, K;
  const float* x;     // [2, B, T, D] float32
  const S* dg;        // [T, 2B, 4H] store dtype
  float* dwx_part;    // [splits, 2, D, 4H]
  float* dbias_part;  // [splits, 2, 4H]

  // as[m][k] = x of row k0 + k, column m0 + m (m fastest: x rows are
  // contiguous in m)
  __device__ void stage_a(T* as, int ld, int g, int m0, int k0, int k1) const {
    constexpr int kM = Tile<T>::kRows;
    for (int i = threadIdx.x; i < kM * kChunk; i += kThreads) {
      const int k = i / kM, m = i - k * kM;
      float v = 0.0f;
      if (m0 + m < M && k0 + k < k1) v = x[rows.x(g, k0 + k) * M + m0 + m];
      as[m * ld + k] = Dtype<T>::from_float(v);
    }
  }
  // bs[k][n] = dg of row k0 + k, column n0 + n; thread tid always stages
  // column tid % kCols (kThreads is a multiple of kCols), so it sums that
  // column's dbias over its rows, before the rounding to the compute dtype
  __device__ void stage_b(T* bs, int ld, int g, int k0, int k1, int n0,
                          float& col_sum) const {
    for (int i = threadIdx.x; i < kChunk * kCols; i += kThreads) {
      const int k = i / kCols, n = i - k * kCols;
      float v = 0.0f;
      if (k0 + k < k1 && n0 + n < N) v = load(dg, rows.dg(g, k0 + k) * N + n0 + n);
      col_sum += v;
      bs[k * ld + n] = Dtype<T>::from_float(v);
    }
  }
  __device__ void finish(const float* zs, int ld, int g, int split, int m0, int n0,
                         const float* sums) const {
    constexpr int kM = Tile<T>::kRows;
    const size_t part = (size_t)split * 2 + g;
    for (int i = threadIdx.x; i < kM * kCols; i += kThreads) {
      const int m = i / kCols, n = i - m * kCols;
      if (m0 + m < M && n0 + n < N)
        dwx_part[(part * M + m0 + m) * N + n0 + n] = zs[m * ld + n];
    }
    if (blockIdx.y != 0) return;
    const int n = threadIdx.x;
    if (n < kCols && n0 + n < N) {
      float v = 0.0f;
      for (int s = 0; s < kThreads / kCols; ++s) v += sums[s * kCols + n];
      dbias_part[part * N + n0 + n] = v;
    }
  }
};

template <typename T>
struct FoldLayout {
  Layout l;  // product: K = kChunk, N = kCols
  size_t a_elems, b_elems, buf_bytes, sums_offset, bytes;
};

template <typename T>
__host__ __device__ FoldLayout<T> fold_layout() {
  FoldLayout<T> f;
  f.l = layout<T>(kChunk, kCols);
  f.a_elems = (size_t)Tile<T>::kRows * f.l.ldx;  // A [kM][ldx]
  f.b_elems = (size_t)kChunk * f.l.ldw;           // B [kChunk][ldw]
  f.buf_bytes = sizeof(T) * (f.a_elems + f.b_elems);
  const size_t z_bytes = sizeof(float) * Tile<T>::kRows * (size_t)f.l.ldz;
  f.sums_offset = 2 * f.buf_bytes > z_bytes ? 2 * f.buf_bytes : z_bytes;
  f.bytes = f.sums_offset + sizeof(float) * kThreads;
  return f;
}

// One block: the [kM, kCols] output tile (m0, n0) of direction
// blockIdx.z % 2, over the depth [split·split_depth, (split + 1)·split_depth)
// of split blockIdx.z / 2.
template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads) fold_product_kernel(Op op, int split_depth) {
  constexpr int kM = Tile<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const FoldLayout<T> f = fold_layout<T>();
  const int g = blockIdx.z % 2, split = blockIdx.z / 2;
  const int m0 = blockIdx.y * kM, n0 = blockIdx.x * kCols;
  const int k_begin = split * split_depth, k_end = min(op.K, k_begin + split_depth);
  float* sums = reinterpret_cast<float*>(smem_raw + f.sums_offset);
  float col_sum = 0.0f;
  typename Product<T>::Acc acc;
  acc.zero();
  for (int k0 = k_begin, c = 0; k0 < k_end; k0 += kChunk, ++c) {
    T* as = reinterpret_cast<T*>(smem_raw + (c & 1) * f.buf_bytes);
    T* bs = as + f.a_elems;
    op.stage_a(as, f.l.ldx, g, m0, k0, k_end);
    op.stage_b(bs, f.l.ldw, g, k0, k_end, n0, col_sum);
    __syncthreads();
    acc.product(as, bs, 0, kChunk, f.l);
  }
  __syncthreads();  // every warp is done with the buffers zs aliases
  float* zs = reinterpret_cast<float*>(smem_raw);
  acc.store(zs, f.l);
  sums[threadIdx.x] = col_sum;
  __syncthreads();
  op.finish(zs, f.l.ldz, g, split, m0, n0, sums);
}

template <typename T, typename Op>
cudaError_t run_product(const Op& op, int splits, cudaStream_t stream) {
  const FoldLayout<T> f = fold_layout<T>();
  cudaError_t err = set_smem(fold_product_kernel<T, Op>, f.bytes);
  if (err != cudaSuccess) return err;
  const int split_depth = cdiv(cdiv(op.K, splits), kChunk) * kChunk;
  const dim3 grid(cdiv(op.N, kCols), cdiv(op.M, Tile<T>::kRows), 2 * splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  fold_product_kernel<T, Op><<<grid, kThreads, f.bytes, stream>>>(op, split_depth);
  return cudaGetLastError();
}

// SMs of the device, or 0 if it cannot be asked
int sm_count(int device) {
  int sms = 0;
  return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) == cudaSuccess
             ? sms
             : 0;
}

// Splits of dwx's rows: the product has only 2·(D / kM)·(4H / 128) output
// tiles (200 in bf16 at the flagship), so its rows are split until there
// are about eight blocks for each of the device's ``sms`` SMs, none
// shorter than eight chunks.
template <typename T>
int dwx_splits(int rows, int d_in, int h4, int sms) {
  const int tiles = 2 * cdiv(d_in, Tile<T>::kRows) * cdiv(h4, kCols);
  const int want = cdiv(8 * sms, tiles), most = cdiv(rows, 8 * kChunk);
  return want < most ? want : (most < 1 ? 1 : most);
}

template <typename T>
size_t fold_scratch_floats(int steps, int batch, int units, int d_in, int sms) {
  const int h4 = 4 * units;
  return (size_t)dwx_splits<T>(steps * batch, d_in, h4, sms) * 2 * ((size_t)d_in + 1) * h4;
}

struct FoldArgs {
  int steps, batch, units, d_in, sms;
  const void *x, *wxt, *dgates;
  void *dx, *dwx, *dbias;
  float* partial;  // fold_scratch_floats
  cudaStream_t stream;
};

template <typename T, typename S>
int fold(const FoldArgs& a) {
  if (a.sms <= 0) return cudaErrorInvalidDevice;
  const Rows rows{a.steps, a.batch};
  const int rows_n = a.steps * a.batch, h4 = 4 * a.units;
  cudaError_t err = run_product<T>(
      DxProduct<T, S>{rows, rows_n, a.d_in, h4, (const S*)a.dgates,
                      (const T*)a.wxt, (S*)a.dx},
      1, a.stream);
  if (err != cudaSuccess) return err;
  const int splits = dwx_splits<T>(rows_n, a.d_in, h4, a.sms);
  float* dbias_part = a.partial + (size_t)splits * 2 * a.d_in * h4;
  err = run_product<T>(
      DwxProduct<T, S>{rows, a.d_in, h4, rows_n, (const float*)a.x,
                       (const S*)a.dgates, a.partial, dbias_part},
      splits, a.stream);
  if (err != cudaSuccess) return err;
  split_sum_kernel<<<264, 256, 0, a.stream>>>(a.partial, splits, (size_t)2 * a.d_in * h4,
                                              (float*)a.dwx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_sum_kernel<<<cdiv(2 * h4, 256), 256, 0, a.stream>>>(dbias_part, splits,
                                                             (size_t)2 * h4, (float*)a.dbias);
  return cudaGetLastError();
}

}  // namespace

// K2's arguments (dgates: the scratch the recurrence writes dg into;
// scratch: lstm_bwd_fold_scratch_floats, K2's part first), then x
// [2, B, T, D] float32, wxᵀ [2, 4H, D] in the compute dtype, D, and the
// outputs dx [2, B, T, D] in the store dtype, dwx [2, D, 4H], dbias [2, 4H]
#define LSTM_FOLD_ARGS                                                  \
  LSTM_BWD_ARGS, const void *x, const void *wxt, int d_in, void *dx,    \
      void *dwx, void *dbias
#define LSTM_FOLD_PACK                                                  \
  FoldArgs{steps, batch, units, d_in, sm_count(device), x, wxt, dgates, \
           dx, dwx, dbias,                                              \
           (float*)scratch + lstm_bwd_scratch_floats(steps, batch, units, out_dim), \
           (cudaStream_t)stream}

extern "C" int lstm_bwd_fold_f32(LSTM_FOLD_ARGS) {
  const int err = lstm_bwd_f32(LSTM_BWD_PASS);
  if (err != 0 || steps <= 0 || batch <= 0) return err;
  return store_bf16 ? fold<float, __nv_bfloat16>(LSTM_FOLD_PACK)
                    : fold<float, float>(LSTM_FOLD_PACK);
}

extern "C" int lstm_bwd_fold_bf16(LSTM_FOLD_ARGS) {
  const int err = lstm_bwd_bf16(LSTM_BWD_PASS);
  if (err != 0 || steps <= 0 || batch <= 0) return err;
  return store_bf16 ? fold<__nv_bfloat16, __nv_bfloat16>(LSTM_FOLD_PACK)
                    : fold<__nv_bfloat16, float>(LSTM_FOLD_PACK);
}

// Scratch floats K3 needs on ``device``: K2's, then the partial sums of dwx
// and dbias; -1 if the device's SM count cannot be read
extern "C" long long lstm_bwd_fold_scratch_floats(int device, int steps, int batch,
                                                  int units, int out_dim, int d_in,
                                                  int bf16) {
  const int sms = sm_count(device);
  if (sms <= 0) return -1;
  return lstm_bwd_scratch_floats(steps, batch, units, out_dim) +
         (long long)(bf16 ? fold_scratch_floats<__nv_bfloat16>(steps, batch, units, d_in, sms)
                          : fold_scratch_floats<float>(steps, batch, units, d_in, sms));
}
