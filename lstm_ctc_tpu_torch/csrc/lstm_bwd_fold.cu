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
// The layout.  The TPU kernel computes these products inside the
// recurrence's time blocks, from the dgates it keeps in VMEM, so that no
// dgates stream leaves the kernel.  Here the recurrence and the recurrent
// weight gradients are K2's own launch (lstm_bwd.cu), which writes dg into
// a scratch [T, 2B, 4H] in the store dtype (direction g's row (t, b) at
// row t·2B + g·B + b); the products below read it back, from L2 in part.
// x and dx are [2, B, T, D]: row (t, b) of direction g at (g·B + b)·T + t.
//
// bf16, the main path: the products are wg_product.cuh's engine, fed by
// TMA boxes of 64 rows of 64 bf16.
//   * dx (K-major): a 128-row tile is two segments of 64 consecutive t of
//     one (g, b), one a consumer warpgroup, so that its dg rows are one box
//     (64 t at a stride of 2B rows) and its dx rows are contiguous; wx
//     [2, D, 4H] is already K-major for this product (no transposed copy).
//   * dwx (MN-major): the depth is the rows of direction g, walked in
//     chunks of 64 t of one b (the same boxes of dg, and of x); it is split
//     over blocks where its 2·(D/128)·(4H/128) tiles cannot fill the card,
//     each split writes its partial sums, and a last pass adds them in
//     split order.
//   * x arrives as float32: one pass casts it to bf16 rows padded to a
//     multiple of 8 (16-byte aligned rows for the copy engine).
//   * dbias: a side pass sums the dg columns as stored, in float32, each
//     thread two columns over 64 consecutive rows (r = t·B + b), then the
//     row groups in wg_product.cuh's group_sum order; with float32 dg it
//     also writes the bf16 copy the products read.
// No atomics: the results do not depend on the schedule.
//
// float32: the FMA tile product of tile_product.cuh (no TF32), one block
// per (32-row tile, 128 columns, direction, split of the depth), both
// operands staged element by element (fold_product_kernel).
//
// What bounds it on the H100: at the flagship's layers 1-3 (B = 32,
// T = 384, H = P = 320, D = 640) each of the two folded products is
// 2·T·2B·4H·D = 40.3 GFLOP (0.04 ms on the bf16 tensor cores), beside K2's
// recurrence, which is bound by its per-step latency (PERF.md).

#include "lstm_bwd_entry.cuh"
#include "wg_product.cuh"

namespace {

constexpr int kCols = kMaxV;  // float32: columns of the output per block (N)
constexpr int kChunk = 64;    // float32: depth per staged chunk (K)
constexpr int kM = Tile<float>::kRows;

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

// ---- float32: FMA tile products ----

// dx[g] = dg[g] · wx[g]ᵀ: M = T·B rows, N = D, K = 4H
template <typename S>
struct DxProduct {
  Rows rows;
  int M, N, K;
  const S* dg;      // [T, 2B, 4H] store dtype
  const float* wx;  // [2, D, 4H]
  S* dx;            // [2, B, T, D] store dtype

  // as[m][k] = dg row m0 + m, column k0 + k (k fastest: dg rows are
  // contiguous in k)
  __device__ void stage_a(float* as, int ld, int g, int m0, int k0, int k1) const {
    for (int i = threadIdx.x; i < kM * kChunk; i += kThreads) {
      const int m = i / kChunk, k = i - m * kChunk;
      float v = 0.0f;
      if (m0 + m < M && k0 + k < k1) v = Dtype<S>::to_float(dg[rows.dg(g, m0 + m) * K + k0 + k]);
      as[m * ld + k] = v;
    }
  }
  // bs[k][n] = wx[g][n0 + n][k0 + k] (k fastest: wx rows are contiguous in k)
  __device__ void stage_b(float* bs, int ld, int g, int k0, int k1, int n0, float&) const {
    for (int i = threadIdx.x; i < kChunk * kCols; i += kThreads) {
      const int n = i / kChunk, k = i - n * kChunk;
      float v = 0.0f;
      if (k0 + k < k1 && n0 + n < N) v = wx[((size_t)g * N + n0 + n) * K + k0 + k];
      bs[k * ld + n] = v;
    }
  }
  __device__ void finish(const float* zs, int ld, int g, int, int m0, int n0,
                         const float*) const {
    for (int i = threadIdx.x; i < kM * kCols; i += kThreads) {
      const int m = i / kCols, n = i - m * kCols;
      if (m0 + m < M && n0 + n < N)
        dx[rows.x(g, m0 + m) * N + n0 + n] = Dtype<S>::from_float(zs[m * ld + n]);
    }
  }
};

// dwx[g] = x[g]ᵀ · dg[g]: M = D, N = 4H, K = T·B rows; and dbias[g].  The
// rows are split among blocks; each split writes its partial sums.
template <typename S>
struct DwxProduct {
  Rows rows;
  int M, N, K;
  const float* x;     // [2, B, T, D] float32
  const S* dg;        // [T, 2B, 4H] store dtype
  float* dwx_part;    // [splits, 2, D, 4H]
  float* dbias_part;  // [splits, 2, 4H]

  // as[m][k] = x of row k0 + k, column m0 + m (m fastest: x rows are
  // contiguous in m)
  __device__ void stage_a(float* as, int ld, int g, int m0, int k0, int k1) const {
    for (int i = threadIdx.x; i < kM * kChunk; i += kThreads) {
      const int k = i / kM, m = i - k * kM;
      float v = 0.0f;
      if (m0 + m < M && k0 + k < k1) v = x[rows.x(g, k0 + k) * M + m0 + m];
      as[m * ld + k] = v;
    }
  }
  // bs[k][n] = dg of row k0 + k, column n0 + n; thread tid always stages
  // column tid % kCols (kThreads is a multiple of kCols), so it sums that
  // column's dbias over its rows
  __device__ void stage_b(float* bs, int ld, int g, int k0, int k1, int n0,
                          float& col_sum) const {
    for (int i = threadIdx.x; i < kChunk * kCols; i += kThreads) {
      const int k = i / kCols, n = i - k * kCols;
      float v = 0.0f;
      if (k0 + k < k1 && n0 + n < N) v = Dtype<S>::to_float(dg[rows.dg(g, k0 + k) * N + n0 + n]);
      col_sum += v;
      bs[k * ld + n] = v;
    }
  }
  __device__ void finish(const float* zs, int ld, int g, int split, int m0, int n0,
                         const float* sums) const {
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

struct FoldLayout {
  Layout l;  // product: K = kChunk, N = kCols
  size_t a_elems, b_elems, buf_bytes, sums_offset, bytes;
};

__host__ __device__ inline FoldLayout fold_layout() {
  FoldLayout f;
  f.l = layout<float>(kChunk, kCols);
  f.a_elems = (size_t)kM * f.l.ldx;      // A [kM][ldx]
  f.b_elems = (size_t)kChunk * f.l.ldw;  // B [kChunk][ldw]
  f.buf_bytes = sizeof(float) * (f.a_elems + f.b_elems);
  const size_t z_bytes = sizeof(float) * kM * (size_t)f.l.ldz;
  f.sums_offset = 2 * f.buf_bytes > z_bytes ? 2 * f.buf_bytes : z_bytes;
  f.bytes = f.sums_offset + sizeof(float) * kThreads;
  return f;
}

// One block: the [kM, kCols] output tile (m0, n0) of direction
// blockIdx.z % 2, over the depth [split·split_depth, (split + 1)·split_depth)
// of split blockIdx.z / 2.
template <typename Op>
__global__ void __launch_bounds__(kThreads) fold_product_kernel(Op op, int split_depth) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const FoldLayout f = fold_layout();
  const int g = blockIdx.z % 2, split = blockIdx.z / 2;
  const int m0 = blockIdx.y * kM, n0 = blockIdx.x * kCols;
  const int k_begin = split * split_depth, k_end = min(op.K, k_begin + split_depth);
  float* sums = reinterpret_cast<float*>(smem_raw + f.sums_offset);
  float col_sum = 0.0f;
  FmaAcc acc;
  acc.zero();
  for (int k0 = k_begin, c = 0; k0 < k_end; k0 += kChunk, ++c) {
    float* as = reinterpret_cast<float*>(smem_raw + (c & 1) * f.buf_bytes);
    float* bs = as + f.a_elems;
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

template <typename Op>
cudaError_t run_product(const Op& op, int splits, cudaStream_t stream) {
  const FoldLayout f = fold_layout();
  cudaError_t err = set_smem(fold_product_kernel<Op>, f.bytes);
  if (err != cudaSuccess) return err;
  const int split_depth = cdiv(cdiv(op.K, splits), kChunk) * kChunk;
  const dim3 grid(cdiv(op.N, kCols), cdiv(op.M, kM), 2 * splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  fold_product_kernel<Op><<<grid, kThreads, f.bytes, stream>>>(op, split_depth);
  return cudaGetLastError();
}

// Splits of dwx's rows: the product has only 2·(D / kM)·(4H / 128) output
// tiles, so its rows are split until there are about eight blocks for
// each of the device's ``sms`` SMs, none shorter than eight chunks.
int dwx_splits_f32(int rows, int d_in, int h4, int sms) {
  const int tiles = 2 * cdiv(d_in, kM) * cdiv(h4, kCols);
  const int want = cdiv(8 * sms, tiles), most = cdiv(rows, 8 * kChunk);
  return want < most ? want : (most < 1 ? 1 : most);
}

struct FoldArgs {
  int steps, batch, units, d_in, sms;
  const void *x, *wx, *dgates;
  void *dx, *dwx, *dbias;
  float* scratch;  // fold_scratch_floats, after K2's
  cudaStream_t stream;
};

template <typename S>
int fold_f32(const FoldArgs& a) {
  const Rows rows{a.steps, a.batch};
  const int rows_n = a.steps * a.batch, h4 = 4 * a.units;
  cudaError_t err = run_product(
      DxProduct<S>{rows, rows_n, a.d_in, h4, (const S*)a.dgates, (const float*)a.wx, (S*)a.dx},
      1, a.stream);
  if (err != cudaSuccess) return err;
  const int splits = dwx_splits_f32(rows_n, a.d_in, h4, a.sms);
  float* dbias_part = a.scratch + (size_t)splits * 2 * a.d_in * h4;
  err = run_product(DwxProduct<S>{rows, a.d_in, h4, rows_n, (const float*)a.x,
                                  (const S*)a.dgates, a.scratch, dbias_part},
                    splits, a.stream);
  if (err != cudaSuccess) return err;
  split_sum_kernel<<<264, 256, 0, a.stream>>>(a.scratch, splits, (size_t)2 * a.d_in * h4,
                                              (float*)a.dwx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_sum_kernel<<<cdiv(2 * h4, 256), 256, 0, a.stream>>>(dbias_part, splits, (size_t)2 * h4,
                                                             (float*)a.dbias);
  return cudaGetLastError();
}

// ---- bf16: the engine ----

constexpr int kSeg = 64;        // t of one segment or chunk (a box's rows)
constexpr int kSumRows = 64;    // rows of one group of the dbias side sum

// dx[g] = dg[g] · wx[g]ᵀ, K-major.  Tile = ((g·tiles_m + tm)·tiles_n + tn);
// warpgroup wg of row tile tm takes segment s = 2·tm + wg of direction g:
// b = s / segs, t = (s % segs)·64 .. + 63
template <typename S>
struct DxOp {
  static constexpr int kTrans = 0;
  int steps, batch, segs, tiles_m, tiles_n, chunks, d;
  S* dx;  // [2, B, T, D]

  __device__ void where(int tile, int wg, int& g, int& b, int& t0, int& tn) const {
    tn = tile % tiles_n;
    const int r = tile / tiles_n, tm = r % tiles_m, s = 2 * tm + wg;
    g = r / tiles_m;
    b = s / segs;
    t0 = (s - b * segs) * kSeg;
  }
  __device__ void range(int, int, int& k0, int& k1) const {
    k0 = 0;
    k1 = chunks;
  }
  // dg [T, 2B, 4H] as (4H, B, 2, T): 64 columns of 64 t; a segment past
  // the batch reads rows past T (zero)
  __device__ Coord a_box(int tile, int wg, int k) const {
    int g, b, t0, tn;
    where(tile, wg, g, b, t0, tn);
    return b < batch ? Coord{{k * 64, b, g, t0}} : Coord{{k * 64, 0, g, steps}};
  }
  // wx [2, D, 4H] as (4H, D, 2, 1): 64 columns of 64 rows of D
  __device__ Coord b_box(int tile, int j, int k) const {
    const int tn = tile % tiles_n, g = tile / tiles_n / tiles_m;
    return Coord{{k * 64, kEngTile * tn + 64 * j, g, 0}};
  }
  __device__ void store(int tile, int, const float (&acc)[64], const Frag& f) const {
    int g, b, t0, tn;
    where(tile, f.wg, g, b, t0, tn);
    if (b >= batch) return;
    const bool pairs = (d & 1) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + f.row + 8 * h;
      if (t >= steps) continue;
      S* row = dx + (((size_t)g * batch + b) * steps + t) * d;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = kEngTile * tn + 8 * j + f.col;
        if (col >= d) continue;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (pairs) {
          if constexpr (sizeof(S) == 2)
            *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(v0, v1);
          else
            *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
        } else {
          row[col] = Dtype<S>::from_float(v0);
          if (col + 1 < d) row[col + 1] = Dtype<S>::from_float(v1);
        }
      }
    }
  }
};

// dwx[g] = x[g]ᵀ · dg[g], MN-major.  Tile = ((g·tiles_m + tm)·tiles_n + tn);
// chunk k of the depth is t = (k % segs)·64 .. + 63 of b = k / segs; split
// `split` writes its partial to out + split·2·D·4H
struct DwxOp {
  static constexpr int kTrans = 1;
  int steps, batch, segs, tiles_m, tiles_n, chunks, splits, d, h4;
  float* out;  // [splits, 2, D, 4H]

  __device__ void range(int, int split, int& k0, int& k1) const {
    split_range(chunks, splits, split, k0, k1);
  }
  // x(bf16) [2, B, T, Dp] as (D, T, 2B, 1): 64 columns of D, 64 t
  __device__ Coord a_box(int tile, int wg, int k) const {
    const int tm = tile / tiles_n % tiles_m, g = tile / tiles_n / tiles_m, b = k / segs;
    return Coord{{kEngTile * tm + 64 * wg, (k - b * segs) * kSeg, g * batch + b, 0}};
  }
  // dg [T, 2B, 4H] as (4H, B, 2, T): 64 columns of 4H, 64 t
  __device__ Coord b_box(int tile, int j, int k) const {
    const int tn = tile % tiles_n, g = tile / tiles_n / tiles_m, b = k / segs;
    return Coord{{kEngTile * tn + 64 * j, b, g, (k - b * segs) * kSeg}};
  }
  __device__ void store(int tile, int split, const float (&acc)[64], const Frag& f) const {
    const int tn = tile % tiles_n, tm = tile / tiles_n % tiles_m, g = tile / tiles_n / tiles_m;
    float* part = out + ((size_t)split * 2 + g) * d * h4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = kEngTile * tm + 64 * f.wg + f.row + 8 * h;
      if (m >= d) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = kEngTile * tn + 8 * j + f.col;
        if (n < h4)
          *reinterpret_cast<float2*>(part + (size_t)m * h4 + n) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
};

// dbias partials: part[q][g][k] = Σ over rows r = t·B + b in
// [64 q, 64 q + 64) of direction g, in order, of dg[t][g·B + b][k] as
// stored (float32); thread i of the grid's x takes columns 2i, 2i + 1 of
// [2, 4H].  With `copy`, also dg in bf16 (float32 dg only).
template <typename S>
__global__ void dg_column_sums(const S* __restrict__ dg, int steps, int batch, int h4,
                               float* __restrict__ part, __nv_bfloat16* __restrict__ copy) {
  const int pair = blockIdx.x * blockDim.x + threadIdx.x;
  if (pair >= h4) return;  // 2·4H columns, two a thread
  const int g = 2 * pair / h4, k = 2 * pair - g * h4, q = blockIdx.y;
  const int r0 = q * kSumRows, n = min(steps * batch - r0, kSumRows);
  int t = r0 / batch, b = r0 - t * batch;
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    const size_t at = (((size_t)t * 2 + g) * batch + b) * h4 + k;
    float2 v;
    if constexpr (sizeof(S) == 2) {
      v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dg + at));
    } else {
      v = *reinterpret_cast<const float2*>(dg + at);
      if (copy != nullptr)
        *reinterpret_cast<__nv_bfloat162*>(copy + at) = __floats2bfloat162_rn(v.x, v.y);
    }
    s0 += v.x;
    s1 += v.y;
    if (++b == batch) {
      b = 0;
      ++t;
    }
  }
  float* dst = part + ((size_t)q * 2 + g) * h4 + k;
  dst[0] = s0;
  dst[1] = s1;
}

// The bf16 body's scratch, in floats from a 256-byte aligned start: x in
// bf16, dg in bf16 (float32 dg only), dwx's partials (more than one split
// only), dbias's partials.
struct Bf16Plan {
  int dp, segs, tiles_m_dx, tiles_n_dx, tiles_dwx, chunks_dwx, splits, groups;
  size_t xb, dgb, dwx_part, dbias_part, floats;
};

inline Bf16Plan bf16_plan(int steps, int batch, int units, int d_in, int store_bf16, int sms) {
  Bf16Plan p;
  const int h4 = 4 * units;
  p.dp = round8(d_in);
  p.segs = cdiv(steps, kSeg);
  p.tiles_m_dx = cdiv(batch * p.segs, 2);
  p.tiles_n_dx = cdiv(d_in, kEngTile);
  p.tiles_dwx = 2 * cdiv(d_in, kEngTile) * cdiv(h4, kEngTile);
  p.chunks_dwx = batch * p.segs;
  p.splits = engine_splits(p.tiles_dwx, p.chunks_dwx, sms);
  p.groups = cdiv(steps * batch, kSumRows);
  size_t o = 0;
  p.xb = o;
  o += align64((size_t)2 * batch * steps * p.dp / 2);
  p.dgb = o;
  if (!store_bf16) o += align64((size_t)steps * 2 * batch * h4 / 2);
  p.dwx_part = o;
  if (p.splits > 1) o += align64((size_t)p.splits * 2 * d_in * h4);
  p.dbias_part = o;
  o += align64((size_t)p.groups * 2 * h4);
  p.floats = o + 64;  // slack for the alignment of the start
  return p;
}

template <typename S>
int fold_bf16(const FoldArgs& a) {
  const int steps = a.steps, batch = a.batch, d = a.d_in, h4 = 4 * a.units;
  const Bf16Plan p = bf16_plan(steps, batch, a.units, d, sizeof(S) == 2, a.sms);
  float* base = (float*)(((uintptr_t)a.scratch + 255) & ~(uintptr_t)255);
  __nv_bfloat16* xb = (__nv_bfloat16*)(base + p.xb);
  __nv_bfloat16* dgb = sizeof(S) == 2 ? (__nv_bfloat16*)a.dgates : (__nv_bfloat16*)(base + p.dgb);
  float* dwx_part = p.splits > 1 ? base + p.dwx_part : (float*)a.dwx;
  float* dbias_part = base + p.dbias_part;
  const cudaStream_t s = a.stream;

  cudaError_t err = cast_rows((const float*)a.x, 2 * batch * steps, d, p.dp, xb, s);
  if (err != cudaSuccess) return err;
  dg_column_sums<S><<<dim3(cdiv(h4, 128), p.groups), 128, 0, s>>>(
      (const S*)a.dgates, steps, batch, h4, dbias_part, sizeof(S) == 2 ? nullptr : dgb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = sum_groups(dbias_part, p.groups, 2 * h4, (float*)a.dbias, s)) != cudaSuccess)
    return err;

  // dg [T, 2B, 4H] as (4H, B, 2, T); wx [2, D, 4H] as (4H, D, 2, 1);
  // x(bf16) [2, B, T, Dp] as (D, T, 2B, 1); strides in bytes
  CUtensorMap dg_map, wx_map, x_map;
  const uint64_t row = (uint64_t)h4 * 2;
  if ((err = bf16_map(&dg_map, dgb, {(uint64_t)h4, (uint64_t)batch, 2, (uint64_t)steps},
                      {row, row * batch, row * 2 * batch}, 1, 64)) != cudaSuccess)
    return err;
  if ((err = bf16_map(&wx_map, a.wx, {(uint64_t)h4, (uint64_t)d, 2, 1},
                      {row, row * d, row * d * 2}, 64, 1)) != cudaSuccess)
    return err;
  const uint64_t xrow = (uint64_t)p.dp * 2;
  if ((err = bf16_map(&x_map, xb, {(uint64_t)d, (uint64_t)steps, (uint64_t)2 * batch, 1},
                      {xrow, xrow * steps, xrow * steps * 2 * batch}, 64, 1)) != cudaSuccess)
    return err;

  const DxOp<S> dx_op{steps, batch, p.segs, p.tiles_m_dx, p.tiles_n_dx, cdiv(h4, 64), d,
                      (S*)a.dx};
  err = run_engine(dg_map, wx_map, dx_op, 2 * p.tiles_m_dx * p.tiles_n_dx, 1, s);
  if (err != cudaSuccess) return err;
  const DwxOp dwx_op{steps, batch, p.segs, cdiv(d, kEngTile), cdiv(h4, kEngTile), p.chunks_dwx,
                     p.splits, d, h4, dwx_part};
  err = run_engine(x_map, dg_map, dwx_op, p.tiles_dwx, p.splits, s);
  if (err != cudaSuccess || p.splits == 1) return err;
  return sum_splits(dwx_part, p.splits, (size_t)2 * d * h4, (float*)a.dwx, a.sms, s);
}

size_t fold_f32_scratch_floats(int steps, int batch, int units, int d_in, int sms) {
  const int h4 = 4 * units;
  return (size_t)dwx_splits_f32(steps * batch, d_in, h4, sms) * 2 * ((size_t)d_in + 1) * h4;
}

}  // namespace

// K2's arguments (dgates: the scratch the recurrence writes dg into;
// scratch: lstm_bwd_fold_scratch_floats, K2's part first), then x
// [2, B, T, D] float32, wx [2, D, 4H] in the compute dtype, D, and the
// outputs dx [2, B, T, D] in the store dtype, dwx [2, D, 4H], dbias [2, 4H]
#define LSTM_FOLD_ARGS                                                  \
  LSTM_BWD_ARGS, const void *x, const void *wx, int d_in, void *dx,     \
      void *dwx, void *dbias
#define LSTM_FOLD_PACK                                                  \
  FoldArgs{steps, batch, units, d_in, device_sms(device), x, wx, dgates, \
           dx, dwx, dbias,                                              \
           (float*)scratch + lstm_bwd_scratch_floats(steps, batch, units, out_dim), \
           (cudaStream_t)stream}

extern "C" int lstm_bwd_fold_f32(LSTM_FOLD_ARGS) {
  const int err = lstm_bwd_f32(LSTM_BWD_PASS);
  if (err != 0 || steps <= 0 || batch <= 0) return err;
  const FoldArgs a = LSTM_FOLD_PACK;
  if (a.sms <= 0) return cudaErrorInvalidDevice;
  return store_bf16 ? fold_f32<__nv_bfloat16>(a) : fold_f32<float>(a);
}

extern "C" int lstm_bwd_fold_bf16(LSTM_FOLD_ARGS) {
  const int err = lstm_bwd_bf16(LSTM_BWD_PASS);
  if (err != 0 || steps <= 0 || batch <= 0) return err;
  const FoldArgs a = LSTM_FOLD_PACK;
  if (a.sms <= 0) return cudaErrorInvalidDevice;
  return store_bf16 ? fold_bf16<__nv_bfloat16>(a) : fold_bf16<float>(a);
}

// Scratch floats K3 needs on ``device``: K2's, then the bf16 body's plan or
// the float32 body's partial sums of dwx and dbias; -1 if the device's SM
// count cannot be read
extern "C" long long lstm_bwd_fold_scratch_floats(int device, int steps, int batch,
                                                  int units, int out_dim, int d_in,
                                                  int bf16, int store_bf16) {
  const int sms = device_sms(device);
  if (sms <= 0) return -1;
  return lstm_bwd_scratch_floats(steps, batch, units, out_dim) +
         (long long)(bf16 ? bf16_plan(steps, batch, units, d_in, store_bf16, sms).floats
                          : fold_f32_scratch_floats(steps, batch, units, d_in, sms));
}
