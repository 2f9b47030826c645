// K6 and K8: the MoE head's fused expert mix, backward to x and the gate.
//
// Replaces the TPU kernels lstm_ctc_tpu/ops/moe_pallas.py _bwd_kernel
// (:271-280, K6, launched by _pallas_bwd :391) and _bwd_kernel_noemit
// (:282-287, K8, launched by _pallas_bwd_noemit :475), whose math is
// _dz_core (:222-243) and _bwd_dz (:245-269).  From the stash th = tanh(x·W
// + b) [N, E·V] that K5 wrote, the output cotangent gout [N, V], the gate
// [N, E] and the same hash mask m at global (n, e·V + v):
//
//   a     = tau · th · m
//   dz    = gate[n, e] · gout[n, v] · tau (1 - th²) · m
//   dgate = sum_v gout[n, v] · a[n, e, v]             float32
//   dx    = dz (compute dtype) · Wᵀ                     float32 sums
//
// K6 also writes dz in the compute dtype, for the weight gradient dw =
// xᵀ·dz that stays one torch.matmul outside (as it is one XLA dot outside
// the Pallas kernel there).  K8, the first pass of the opt-in "twokernel"
// backward, does not: K9 (moe_wgrad.cu) recomputes dz for dw and db.  Both
// are moe_bwd_wgmma with and without the dz store, so they agree bit for
// bit.
//
// bf16, the main path (moe_bwd_wgmma).  What bounds it on the H100: by
// count, bytes (th read and dz written once, 149 MB each at N = 14336, D =
// 640, E = V = 72: 0.105 ms at 3.35 TB/s) just above the dx product's
// 95.1 GFLOP (0.096 ms); in fact the elementwise dz stage, latency-bound
// on the 8 warps that the 160-register accumulators leave a block (PERF.md
// section 6).
//
// dz once per element: a block owns 64 rows and a slice of 4·NI columns
// of D (NI = 160 for D > 256), all of D up to 640, so there dz of its rows
// is made once (a wider D takes slices that each make it again).  dx = dz
// · Wᵀ is one product of depth E·V, chunked by 64 across expert
// boundaries (no padding at V = 72); the gate factor is per element.
//
// Roles: both warpgroups make dz of chunk c + 1 (16 columns a thread, four
// threads a row, th and the gates loaded a chunk ahead) into a swizzled
// shared-memory slot, the products' A, while the products of chunk c run:
// warpgroup g owns dx columns [2 NI g, 2 NI (g + 1)) of the slice as two
// m64nNIk16 accumulators, 160 registers a thread, which is why the block
// has 256 threads (255 registers each) and no copy warp.  W comes packed
// (ops/moe_kernels.py bwd_pack: per slice and chunk, Wᵀ as [4 NI][64],
// swizzled; W is [D, E·V], already K-major for this product).
//
// gout: up to V = 128 the block holds its rows' [64][V] tile (32 KB at
// most), read once.  Past it (K6 only, up to V = 4096: every V whose lcm
// with 128 is at most 4096, as the reference's fused kernels take) a
// thread's 16 columns of chunk c need gout[n, k mod V] (one or two expert
// segments), which each thread copies by cp.async a chunk ahead into its
// own places of one of two gout slots (16 KB each, in the same 32 KB); the
// order of every sum is the same either way.  (Staging at every V ran K6
// slower at V = 72 on the H100 than the tile, so the tile stays where it
// fits.)
//
// The ring: two W stages of [4 NI][64] (80 KB each at NI = 160) and two dz
// slots.  full[c % 2] completes by the bytes of chunk c's copy; after the
// products of chunk c complete (wgmma.wait_group 0), every warp arrives on
// empty[c % 2] and thread 0, once all have, copies chunk c + 2 into the
// stage; a block barrier a chunk then publishes the next dz slot.  Slot
// (c + 1) % 2 is free when dz of chunk c + 1 is written: chunk c - 1's
// products, its last reader, completed before the previous barrier.
//
// dgate: each thread sums gout · a over its 16 columns in k order, one
// sum per expert segment; a segment that starts and ends inside the thread
// is complete and written; the thread's first and last segments go to
// lane 0 of the row, which joins them in lane order to the expert carried
// from the previous chunk.  tests/test_torch_moe_layout.py emulates the
// order.  For V >= 8 a unit of 8 columns holds at most one expert
// boundary, so its columns pick gate and sum by select, with no branch.
//
// The grid: one block a 64-row tile and slice, one block an SM (~200 KB
// of shared memory); 224 blocks at N = 14336 run in two waves on 132 SMs.
// Clusters of two sharing each W stage by multicast were measured slower
// (the pair of blocks then waits for each other every chunk), so they are
// not used.  Deterministic: fixed sums, no atomics.
//
// K9's first stage (moe_dz_db_kernel) is this body's dz units alone, with
// no product and no dgate, on blocks of 64 rows and 8 chunks.
//
// K7's first stage (moe_bwd_wgrad.cu) is this body with two changes that
// leave dx and dgate bit for bit K6's: dz goes to a scratch whose rows are
// `ldz` apart (E·V rounded up to 8, 16-byte aligned rows for the copy
// engine), and the blocks of slice 0 also write db's partials: per 64-row
// tile and column, the float32 sum of the unrounded dz over the tile's rows
// (in each warp over its 8 rows by three exchanges, ((r0 + r1) + (r2 + r3))
// + ((r4 + r5) + (r6 + r7)); then the 8 warps' sums in warp order, by 64
// threads while the next chunk's products run), which a last pass adds
// over the tiles (wg_product.cuh's group_sum order).
//
// float32: the FMA tile product of tile_product.cuh (no TF32), one block a
// (row tile, 128 columns of D) looping over the experts and, past V = 128,
// over K-chunks of 128 of each expert (moe_bwd_kernel).

#include "tile_product.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kSlice = 128;     // columns of D per block (the product's N)
constexpr int kRowLanes = 16;   // threads per row in the dz stage

struct BwdLayout {
  Layout l;               // product: K = a chunk of V (at most kMaxV), N = kSlice
  size_t dz_elems, w_elems, buf_bytes;
};

constexpr int kRows = Tile<float>::kRows;  // rows of a block

__host__ __device__ BwdLayout bwd_layout(int v) {
  BwdLayout b;
  b.l = layout<float>(min(v, kMaxV), kSlice);
  b.dz_elems = (size_t)kRows * b.l.ldx;   // dz tile [NB][ldx]
  b.w_elems = (size_t)b.l.dp * b.l.ldw;   // W_eᵀ slice [vp16][ldw]
  b.buf_bytes = sizeof(float) * (b.dz_elems + b.w_elems);
  return b;
}

size_t bwd_smem(int v) {
  const BwdLayout b = bwd_layout(v);
  const size_t z_bytes = sizeof(float) * kRows * (size_t)b.l.ldz;
  return 2 * b.buf_bytes > z_bytes ? 2 * b.buf_bytes : z_bytes;
}

// The float32 path: the FMA tile product of tile_product.cuh (no TF32).
// Each expert's product of depth K = V runs in K-chunks of at most 128
// columns (the W_eᵀ slice [K][128 + pad] of a chunk fits beside its dz
// tile); a lane's dgate sum runs over its columns of every chunk in order
// and is reduced at the expert's end, so the order of every sum is that of
// one unchunked product.
template <bool kEmit>
__global__ void __launch_bounds__(kThreads) moe_bwd_kernel(
    const float* __restrict__ th,    // [N, E·V]
    const float* __restrict__ w,     // [D, E·V]
    const float* __restrict__ gate,  // [N, E]
    const float* __restrict__ gout,  // [N, V]
    const int32_t* __restrict__ seed_dev,  // [1] (read if dropout)
    int n, int d, int experts, int v, float tau, float keep_prob,
    float* __restrict__ dx,          // [N, D]
    float* __restrict__ dgate,       // [N, E]
    float* __restrict__ dz_out) {    // [N, E·V] (K6)
  constexpr int kRowsPerPass = kThreads / kRowLanes;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const BwdLayout bl = bwd_layout(v);
  const Layout& l = bl.l;
  // the D slices of one row tile are neighbours in the grid, so they run
  // together and share the tile's th through L2
  const int d0 = blockIdx.x * kSlice, n0 = blockIdx.y * kRows;
  const bool lead = blockIdx.x == 0;  // writes dz and dgate
  const int ev = experts * v;
  const bool dropout = keep_prob < 1.0f;
  const float inv_keep = 1.0f / keep_prob;
  const uint32_t seed = dropout ? (uint32_t)seed_dev[0] : 0u;
  const int rlane = threadIdx.x % kRowLanes, rsub = threadIdx.x / kRowLanes;

  constexpr int kPasses = kRows / kRowsPerPass;
  Product<float>::Acc acc;
  acc.zero();
  float dg[kPasses];  // each pass's row: the open expert's dgate sum of the lane
#pragma unroll
  for (int p = 0; p < kPasses; ++p) dg[p] = 0.0f;
  int it = 0;  // the (expert, K-chunk) step: its buffers
  for (int e = 0; e < experts; ++e) {
    for (int k0 = 0; k0 < v; k0 += kMaxV, ++it) {
      const int kc = min(kMaxV, v - k0), col = e * v + k0;
      const bool last = k0 + kc == v;
      float* dzs = reinterpret_cast<float*>(smem_raw + (it & 1) * bl.buf_bytes);
      float* ws = dzs + bl.dz_elems;
      // W_eᵀ's chunk for this slice: ws[c][j] = W[d0 + j, e·V + k0 + c], zero padded
      for (int i = threadIdx.x; i < kSlice * l.dp; i += kThreads) {
        const int j = i / l.dp, c = i - j * l.dp;
        ws[c * l.ldw + j] = (c < kc && d0 + j < d) ? w[(size_t)(d0 + j) * ev + col + c] : 0.0f;
      }
      // dz of the row tile for the chunk of expert e, and at its end dgate[:, e]
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int r = p * kRowsPerPass + rsub, nn = n0 + r;
        const bool row_ok = nn < n;
        const float g = row_ok ? gate[(size_t)nn * experts + e] : 0.0f;
#pragma unroll
        for (int jc = 0; jc < kMaxV / kRowLanes; ++jc) {
          const int c = rlane + kRowLanes * jc;
          if (c < l.dp) {
            float dz = 0.0f;
            if (row_ok && c < kc) {
              const float t = th[(size_t)nn * ev + col + c];
              const float q = gout[(size_t)nn * v + k0 + c];
              float a = tau * t;
              dz = g * q * (tau * (1.0f - t * t));
              if (dropout) {
                const float m = drop_factor((uint32_t)nn, (uint32_t)(col + c), seed,
                                            keep_prob, inv_keep);
                a *= m;
                dz *= m;
              }
              dg[p] = fmaf(q, a, dg[p]);
            }
            dzs[r * l.ldx + c] = dz;
            if (kEmit && lead && row_ok && c < kc) dz_out[(size_t)nn * ev + col + c] = dz;
          }
        }
        if (last) {
          float sum = dg[p];
#pragma unroll
          for (int off = kRowLanes / 2; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          if (lead && row_ok && rlane == 0) dgate[(size_t)nn * experts + e] = sum;
          dg[p] = 0.0f;
        }
      }
      __syncthreads();
      acc.product(dzs, ws, 0, l.dp, l);
    }
  }

  __syncthreads();  // every warp is done with the buffers zs aliases
  float* zs = reinterpret_cast<float*>(smem_raw);
  acc.store(zs, l);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * kSlice; i += kThreads) {
    const int r = i / kSlice, j = i - r * kSlice;
    if (n0 + r < n && d0 + j < d) dx[(size_t)(n0 + r) * d + d0 + j] = zs[r * l.ldz + j];
  }
}

int launch_f32(int device, const void* th, const void* w, const void* gate, const void* gout,
               const void* seed, int n, int d, int experts, int v, float tau, float keep_prob,
               void* dx, void* dgate, void* dz, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  if (v <= 0 || v > kMaxTargets || d <= 0 || experts <= 0) return cudaErrorInvalidValue;
  if (keep_prob < 1.0f && seed == nullptr) return cudaErrorInvalidValue;
  if (cdiv(n, kRows) > 65535) return cudaErrorInvalidValue;
  const size_t smem = bwd_smem(v);
  const dim3 grid(cdiv(d, kSlice), cdiv(n, kRows));
  auto kernel = dz != nullptr ? moe_bwd_kernel<true> : moe_bwd_kernel<false>;
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)th, (const float*)w, (const float*)gate, (const float*)gout,
      (const int32_t*)seed, n, d, experts, v, tau, keep_prob, (float*)dx, (float*)dgate,
      (float*)dz);
  return cudaGetLastError();
}


// ---- bf16: warpgroup products fed by bulk copies ----

constexpr int kWgRows = 64;                    // rows of a block (wgmma's M)
constexpr int kWgThreads = 256;                // two warpgroups, up to 255 registers a thread
constexpr int kSlots = 2;                      // W stages [4 NI][64] and dz slots [64][64]
constexpr int kDzSlot = kWgRows * kSwRow;
constexpr int kLanesPerRow = 4;                // threads a row of a chunk in the dz stage
constexpr int kPerLane = 64 / kLanesPerRow;    // and the columns of each
constexpr int kUnits = kPerLane / 8;           // in 16-byte units of bf16

// wgmma's N: a block's slice of D is 4 NI columns, NI for each of the two
// products of each warpgroup; ops/moe_kernels.py bwd_pack_width gives the
// same
__host__ __device__ constexpr int bwd_ni(int d) { return d <= 256 ? 64 : 160; }

constexpr int kWarpSums = 8 * 64;               // db: a chunk's column sums of 8 warps
// gout of a chunk, a thread's 16 columns: [4 quads][256 threads][4] float32
constexpr int kGoutSlotFloats = kWgThreads * kPerLane;
static_assert(kSlots * kGoutSlotFloats >= kWgRows * kMaxV, "the gout tile of V <= 128 fits");

// W stages, dz slots, two gout slots, the barriers, with `db` two chunks'
// warp sums; 1 KB of slack for alignment
inline size_t bwd_wg_smem(int ni, bool db) {
  return 1024 + (size_t)kSlots * (4 * ni * kSwRow + kDzSlot) +
         (size_t)kSlots * kGoutSlotFloats * sizeof(float) + 2 * kSlots * sizeof(uint64_t) +
         (db ? 2 * kWarpSums * sizeof(float) : 0);
}

// The sums of one 8-column unit's unrounded dz over the 8 rows of a warp
// (row = lane / 4; the lanes of one part, lane % 4, hold the same columns):
// three exchanges, each keeping half of the columns, so that lane l ends
// with column 4 ((l >> 2) & 1) + 2 ((l >> 3) & 1) + ((l >> 4) & 1) of the
// unit, summed ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)) (an add of
// two lanes gives the same sum on both: float addition commutes)
__device__ __forceinline__ float unit_column_sum(const float (&v)[8], int lane) {
  const bool h1 = lane & 4, h2 = lane & 8, h3 = lane & 16;
  float s4[4], s2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s4[i] = (h1 ? v[4 + i] : v[i]) + __shfl_xor_sync(0xffffffffu, h1 ? v[i] : v[4 + i], 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    s2[i] = (h2 ? s4[2 + i] : s4[i]) + __shfl_xor_sync(0xffffffffu, h2 ? s4[i] : s4[2 + i], 8);
  return (h3 ? s2[1] : s2[0]) + __shfl_xor_sync(0xffffffffu, h3 ? s2[0] : s2[1], 16);
}

// db's partial of one 64-row tile and column `col` of a chunk: the 8 warps'
// sums of the unrounded dz (unit_column_sum's) added in warp order
__device__ __forceinline__ float db_tile_sum(const float* wsums, int col) {
  float sum = 0.0f;
#pragma unroll
  for (int q = 0; q < 8; ++q) sum += wsums[q * 64 + col];
  return sum;
}

// One thread in the dz stage: row `row` of the block, columns k = 64c + 16
// part .. + 15 of each chunk c; the four threads of a row are neighbouring
// lanes.  Lane part 0 carries the sum of the expert still open at a chunk's
// end into the next chunk.
struct DzLane {
  int row, part, nn;
  bool ok;
  uint32_t hrow;  // the hash's row and seed terms
  int run_e;      // part 0: the open expert (-1 before the first)
  float run;      // and its sum so far
};

// 16 bytes that are read once: not kept in L1, where the gate rows stay
__device__ __forceinline__ uint4 load_once(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// What a thread's part of chunk c reads from memory, loaded a chunk ahead
// of its use: its th (zero where there is none; rows of E·V a multiple of
// 8 only, else dz_chunk reads th itself) and the gates of the (at most
// three, for V >= 8) experts its 16 columns touch.
struct Ahead {
  uint4 th[kUnits];
  float g[3];
};

__device__ __forceinline__ void fetch_ahead(Ahead& a, const __nv_bfloat16* __restrict__ th,
                                            const float* __restrict__ gate, const DzLane& st,
                                            int c, int experts, int v) {
  const int kk = experts * v, kb = c * 64 + st.part * kPerLane;
  const bool live = st.ok && kb < kk;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int k0 = kb + 8 * u;
    a.th[u] = live && (kk & 7) == 0 && k0 < kk ? load_once(th + (size_t)st.nn * kk + k0)
                                              : make_uint4(0u, 0u, 0u, 0u);
  }
  const int e0 = live ? kb / v : experts;
  const float* row = gate + (size_t)st.nn * experts;
#pragma unroll
  for (int i = 0; i < 3; ++i) a.g[i] = e0 + i < experts ? __ldg(row + e0 + i) : 0.0f;
}

// gout of a thread's columns k = kb .. kb + 15 of chunk c, gout[n, k mod V]
// (zero, one or more expert segments), copied a chunk ahead of its use by
// cp.async into the thread's own places of a gout slot, [quad][thread][4]
// (quad j holds columns 4j .. 4j + 3), so no other thread reads them and no
// barrier is needed: the thread waits for its own copies (cp.async.wait)
// before dz_chunk reads them.  vec4 (V a multiple of 4, gout 16-byte
// aligned): four 16-byte copies, none crossing an expert's end; else sixteen
// of 4 bytes.  Nothing is copied past E·V or N; the caller commits.
__device__ __forceinline__ void fetch_gout(float* slot, const float* __restrict__ gout,
                                           const DzLane& st, int c, int kk, int v, bool vec4) {
  const int kb = c * 64 + st.part * kPerLane;
  if (!st.ok || kb >= kk) return;
  const float* row = gout + (size_t)st.nn * v;
  float* dst = slot + threadIdx.x * 4;
  int col = kb % v;
  if (vec4) {
#pragma unroll
    for (int j = 0; j < kPerLane / 4; ++j) {
      if (kb + 4 * j < kk) cp_async16_fill(dst + j * kWgThreads * 4, row + col, 16);
      col += 4;
      if (col == v) col = 0;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      if (kb + i < kk) cp_async4_fill(dst + (i >> 2) * kWgThreads * 4 + (i & 3), row + col, 4);
      if (++col == v) col = 0;
    }
  }
}

// A thread's walk over its columns of a chunk: the expert e of the next
// column, its position vv in e's V columns and e's gate g, the sum of the
// open segment, and the thread's first segment once one closed.
struct Walk {
  int e, vv;
  float g, sum;
  int first_e;
  float first_sum;
  bool single;  // no segment closed yet in this chunk
};

// expert w.e's segment ends with this sum: the thread's first segment goes
// to the lane join, a later one is complete and written
__device__ __forceinline__ void close_segment(Walk& w, float sum, float* dgate_row) {
  if (w.single) {
    w.first_e = w.e;
    w.first_sum = sum;
    w.single = false;
  } else {
    dgate_row[w.e] = sum;
  }
}

// dz of 8 columns (any V, columns past E·V zero); kGate: also the dgate
// sums (K6's body; K9's dz stage leaves them out).  gout from the row's
// [V] tile (kTile) or as the unit's 8 values fetch_gout staged.
template <bool kGate, bool kTile>
__device__ __forceinline__ void dz_unit(const float (&t)[8], float (&dzf)[8], Walk& w, int k0,
                                        int kk, const float* grow, const float (&q8)[8],
                                        const float* __restrict__ gate_row,
                                        float* __restrict__ dgate_row, int experts, int v,
                                        float tau, bool dropout, uint32_t hx, uint32_t thr,
                                        float inv_keep) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float dz = 0.0f;
    if (k0 + i < kk) {
      const float q = kTile ? grow[w.vv] : q8[i];
      float a = tau * t[i];
      dz = w.g * q * (tau * (1.0f - t[i] * t[i]));
      if (dropout) {
        const float m = hash_keeps(hx + (uint32_t)i * kHashCol, thr) ? inv_keep : 0.0f;
        a *= m;
        dz *= m;
      }
      w.sum = fmaf(q, a, w.sum);
      if (++w.vv == v) {  // expert w.e ends here
        if (kGate) close_segment(w, w.sum, dgate_row);
        w.sum = 0.0f;
        w.vv = 0;
        ++w.e;
        w.g = w.e < experts ? __ldg(gate_row + w.e) : 0.0f;
      }
    }
    dzf[i] = dz;
  }
}

// the same for V >= 8 and 8 columns inside E·V: at most one expert ends in
// them, at column bnd - 1, so the columns take their gate and sum by select
// and the code has no branch per column (the sums in the same order)
template <bool kDrop, bool kGate, bool kTile>
__device__ __forceinline__ void dz_unit_wide(const float (&t)[8], float (&dzf)[8], Walk& w,
                                             const float* grow, const float (&q8)[8],
                                             const float (&gates)[3], int e0,
                                             float* __restrict__ dgate_row, int v, float tau,
                                             uint32_t hx, uint32_t thr, float inv_keep) {
  const int bnd = v - w.vv;
  const bool ends = bnd <= 8;
  const float gn = w.e == e0 ? gates[1] : gates[2];  // the next expert's (zero past E)
  float lo = w.sum, hi = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool next = i >= bnd;
    const float q = kTile ? grow[next ? w.vv + i - v : w.vv + i] : q8[i];
    float a = tau * t[i];
    float dz = (next ? gn : w.g) * q * (tau * (1.0f - t[i] * t[i]));
    if (kDrop) {
      const float m = hash_keeps(hx + (uint32_t)i * kHashCol, thr) ? inv_keep : 0.0f;
      a *= m;
      dz *= m;
    }
    const float s = fmaf(q, a, next ? hi : lo);
    lo = next ? lo : s;
    hi = next ? s : hi;
    dzf[i] = dz;
  }
  if (ends) {
    if (kGate) close_segment(w, lo, dgate_row);
    ++w.e;
    w.g = gn;
    w.sum = hi;
    w.vv = 8 - bnd;
  } else {
    w.sum = lo;
    w.vv += 8;
  }
}

// dz of chunk c into `slot` (swizzled, the products' A), K6's dz stream, and
// dgate: each thread sums gout · a over its elements in k order, one sum
// per expert segment; a segment that starts and ends inside the thread is
// complete and written at once; the first and the last go to lane part 0
// of the row, which joins them in lane order to the expert carried from
// the previous chunk.  The order of every sum is fixed.  Without kGate
// (K9's dz stage) there is no slot and no dgate: dz and db's warp sums
// only, their bits those of K6's body.
template <bool kEmit, bool kDb, bool kGate, bool kTile>
__device__ __forceinline__ void dz_chunk(int c, unsigned char* slot, DzLane& st, const Ahead& ah,
                                         const __nv_bfloat16* __restrict__ th,
                                         const float* __restrict__ gate, const float* gq,
                                         float* __restrict__ dgate,
                                         __nv_bfloat16* __restrict__ dz_out, int ldz,
                                         float* wsum, int experts, int v, float tau,
                                         bool dropout, uint32_t thr, float inv_keep) {
  const int kk = experts * v, kb = c * 64 + st.part * kPerLane;
  const int lane = threadIdx.x & 31, base = lane & ~(kLanesPerRow - 1);
  const bool live = st.ok && kb < kk;
  const bool vec = (kk & 7) == 0;  // th and dz rows in whole 16-byte units
  const bool wide = vec && v >= 8;
  const float* gate_row = gate + (size_t)st.nn * experts;
  float* dgate_row = kGate ? dgate + (size_t)st.nn * experts : nullptr;
  Walk w;
  w.e = experts;
  w.vv = 0;
  w.g = 0.0f;
  w.sum = 0.0f;
  w.first_e = experts;
  w.first_sum = 0.0f;
  w.single = true;
  const int e0 = live ? kb / v : experts;
  if (live) {
    w.e = e0;
    w.vv = kb - e0 * v;
    w.g = ah.g[0];
  }
  const __nv_bfloat16* trow = th + (size_t)st.nn * kk;
  // gout: the row of the [64][V] tile (kTile), or this thread's places of
  // the chunk's gout slot (fetch_gout)
  const float* grow = gq + st.row * v;
  const float* qs = gq + threadIdx.x * 4;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int k0 = kb + 8 * u;
    const uint32_t hx = st.hrow + (uint32_t)k0 * kHashCol;
    uint32_t words[4] = {0u, 0u, 0u, 0u};
    float dzf[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const bool unit = live && k0 < kk;
    if (unit) {
      float t[8], q8[8];
      if (!kTile) {
        const float4 qa = *reinterpret_cast<const float4*>(qs + 2 * u * kWgThreads * 4);
        const float4 qb = *reinterpret_cast<const float4*>(qs + (2 * u + 1) * kWgThreads * 4);
        q8[0] = qa.x; q8[1] = qa.y; q8[2] = qa.z; q8[3] = qa.w;
        q8[4] = qb.x; q8[5] = qb.y; q8[6] = qb.z; q8[7] = qb.w;
      }
      if (vec) {
        const uint32_t* rw = &ah.th[u].x;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rw[i]));
          t[2 * i] = f.x;
          t[2 * i + 1] = f.y;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) t[i] = k0 + i < kk ? __bfloat162float(trow[k0 + i]) : 0.0f;
      }
      if (wide && dropout)
        dz_unit_wide<true, kGate, kTile>(t, dzf, w, grow, q8, ah.g, e0, dgate_row, v, tau, hx,
                                         thr, inv_keep);
      else if (wide)
        dz_unit_wide<false, kGate, kTile>(t, dzf, w, grow, q8, ah.g, e0, dgate_row, v, tau, hx,
                                          thr, inv_keep);
      else
        dz_unit<kGate, kTile>(t, dzf, w, k0, kk, grow, q8, gate_row, dgate_row, experts, v, tau,
                              dropout, hx, thr, inv_keep);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(dzf[2 * i], dzf[2 * i + 1]);
        words[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    const uint4 packed = make_uint4(words[0], words[1], words[2], words[3]);
    if (kGate) *reinterpret_cast<uint4*>(slot + sw128_offset(st.row, st.part * kUnits + u)) = packed;
    if (kDb && wsum != nullptr)
      wsum[(threadIdx.x / 32) * 64 + st.part * kPerLane + 8 * u + 4 * ((lane >> 2) & 1) +
           2 * ((lane >> 3) & 1) + ((lane >> 4) & 1)] = unit_column_sum(dzf, lane);
    if (kEmit && unit) {
      __nv_bfloat16* drow = dz_out + (size_t)st.nn * ldz + k0;
      if (vec) {
        *reinterpret_cast<uint4*>(drow) = packed;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (k0 + i < kk)
            drow[i] = __ushort_as_bfloat16((unsigned short)(words[i >> 1] >> (16 * (i & 1))));
      }
    }
  }

  if (!kGate) return;
  const int fe = w.single ? w.e : w.first_e;
  const float fs = w.single ? w.sum : w.first_sum;
#pragma unroll
  for (int j = 0; j < kLanesPerRow; ++j) {
    const int sfe = __shfl_sync(0xffffffffu, fe, base + j);
    const float sfs = __shfl_sync(0xffffffffu, fs, base + j);
    const int sle = __shfl_sync(0xffffffffu, w.e, base + j);
    const float sls = __shfl_sync(0xffffffffu, w.sum, base + j);
    const int ssingle = __shfl_sync(0xffffffffu, (int)w.single, base + j);
    if (st.part == 0 && st.ok) {
      if (sfe == st.run_e) {
        st.run += sfs;
      } else {
        if (st.run_e >= 0 && st.run_e < experts)
          dgate[(size_t)st.nn * experts + st.run_e] = st.run;
        st.run_e = sfe;
        st.run = sfs;
      }
      if (!ssingle) {  // the lane's first segment closed inside it
        if (st.run_e < experts) dgate[(size_t)st.nn * experts + st.run_e] = st.run;
        st.run_e = sle;
        st.run = sls;
      }
    }
  }
}

// dx columns col0 .. col0 + NI of rows r0 and r0 + 8 from an accumulator
template <int NI>
__device__ __forceinline__ void store_dx(const float (&acc)[NI / 2], float* __restrict__ dx,
                                         int n0, int r0, int cb, int col0, int n, int d) {
  const bool pairs = (d & 1) == 0;
#pragma unroll
  for (int j = 0; j < NI / 8; ++j) {
    const int col = col0 + 8 * j + cb;
    if (col >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nn = n0 + r0 + 8 * h;
      if (nn >= n) continue;
      float* dst = dx + (size_t)nn * d + col;
      const float a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
      if (pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(a, b);
      } else {
        dst[0] = a;
        if (col + 1 < d) dst[1] = b;
      }
    }
  }
}

// Both warpgroups compute dz of chunk c + 1 into slot (c + 1) % 2 while the
// products of chunk c run on the tensor cores: warpgroup g owns dx columns
// [2 NI g, 2 NI (g + 1)) of the block's slice as two m64nNIk16
// accumulators (160 registers a thread at NI = 160, which is why the block
// has no third warpgroup: 256 threads may use 255 registers each).  Thread
// 0 keeps the W ring full: chunk c + 2 goes into stage c % 2 once both
// blocks' warps released chunk c.  gout: with kTile (V <= 128) the block's
// [64][V] tile, read once; else each thread's columns copied a chunk ahead
// (fetch_gout) into two slots of the same 32 KB.
template <int NI, bool kEmit, bool kDb, bool kTile>
__global__ void __launch_bounds__(kWgThreads, 1) moe_bwd_wgmma(
    const __nv_bfloat16* __restrict__ th,  // [N, E·V]
    const __nv_bfloat16* __restrict__ wp,  // [slices][chunks][4 NI][64], swizzled
    const float* __restrict__ gate,        // [N, E]
    const float* __restrict__ gout,        // [N, V]
    const int32_t* __restrict__ seed_dev,  // [1] (read if dropout)
    int n, int d, int experts, int v, float tau, float keep_prob,
    float* __restrict__ dx,                // [N, D]
    float* __restrict__ dgate,             // [N, E]
    __nv_bfloat16* __restrict__ dz_out,    // [N, ldz] (K6, K7)
    int ldz,
    float* __restrict__ db_part) {         // [row tiles, E·V] (K7)
  constexpr uint32_t kStage = 4 * NI * kSwRow;
  constexpr int kRegs = NI / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ws = align1024(smem_raw);
  unsigned char* dzs = ws + kSlots * kStage;
  // gout: [64][V] (kTile) or [2][kGoutSlotFloats]
  float* gq = reinterpret_cast<float*>(dzs + kSlots * kDzSlot);
  uint64_t* full = reinterpret_cast<uint64_t*>(gq + kSlots * kGoutSlotFloats);
  uint64_t* empty = full + kSlots;
  float* wsums = reinterpret_cast<float*>(empty + kSlots);  // [2][8 warps][64]
  const int kk = experts * v, chunks = cdiv(kk, 64);
  const int n0 = blockIdx.x * kWgRows, slice = blockIdx.y;
  const bool db = kDb && slice == 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(wp) + (size_t)slice * chunks * kStage;

  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every warp
    }
    mbar_init_fence();
  }
  if (kTile)
    for (int i = tid; i < kWgRows * v; i += kWgThreads)
      gq[i] = n0 + i / v < n ? gout[(size_t)n0 * v + i] : 0.0f;
  __syncthreads();

  // chunk c of W into stage c % 2
  auto copy_w = [&](int c) {
    const int s = c % kSlots;
    mbar_expect(&full[s], kStage);
    bulk_copy(ws + (size_t)s * kStage, src + (size_t)c * kStage, kStage, &full[s]);
  };
  if (tid == 0)
    for (int c = 0; c < kSlots && c < chunks; ++c) copy_w(c);

  const bool dropout = keep_prob < 1.0f;
  const uint32_t seed = dropout ? (uint32_t)seed_dev[0] : 0u;
  const uint32_t thr = keep_threshold(keep_prob);
  const float inv_keep = 1.0f / keep_prob;
  DzLane st;
  st.row = tid / kLanesPerRow;
  st.part = tid % kLanesPerRow;
  st.nn = n0 + st.row;
  st.ok = st.nn < n;
  st.hrow = (uint32_t)st.nn * kHashRow + seed * kHashSeed;
  st.run_e = -1;
  st.run = 0.0f;
  Ahead ahead;
  fetch_ahead(ahead, th, gate, st, 0, experts, v);
  const bool gvec = (v & 3) == 0 && (reinterpret_cast<uintptr_t>(gout) & 15) == 0;
  if (!kTile) {
    fetch_gout(gq, gout, st, 0, kk, v, gvec);
    cp_async_commit();
  }

  const int g = tid / 128, wq = warp & 3;
  float acc0[kRegs], acc1[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) acc0[i] = acc1[i] = 0.0f;
  const uint32_t dz_a = smem_addr(dzs), w_a = smem_addr(ws) + 2 * NI * g * kSwRow;
  // step c runs the products of chunk c (none at c = -1) and makes dz of
  // chunk c + 1 meanwhile
  for (int c = -1; c < chunks; ++c) {
    const int s = c & 1;
    if (c >= 0) {
      mbar_wait(&full[s], (c / kSlots) & 1);
      __syncwarp();
      wg_fence();
      const uint32_t a = dz_a + s * kDzSlot, b = w_a + s * kStage;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int add = (c | ks) != 0;
        Wgmma<NI>::mma(acc0, sw128_desc(a + ks * 32), sw128_desc(b + ks * 32), add);
        Wgmma<NI>::mma(acc1, sw128_desc(a + ks * 32), sw128_desc(b + NI * kSwRow + ks * 32),
                       add);
      }
      wg_commit();
    }
    if (db && c >= 0 && tid < 64) {
      // chunk c's column sums, made by the last step's dz stage, in warp order
      const float sum = db_tile_sum(wsums + (c & 1) * kWarpSums, tid);
      if (c * 64 + tid < kk) db_part[(size_t)blockIdx.x * kk + c * 64 + tid] = sum;
    }
    if (c + 1 < chunks) {
      // slot (c + 1) % 2 was read by chunk c - 1, done before the last
      // barrier; so were the warp sums of chunk c - 1.  Staged gout: the
      // thread's copies of chunk c + 1 (the only ones in flight) land first.
      if (!kTile) cp_async_wait_all();
      dz_chunk<kEmit, kDb, true, kTile>(
          c + 1, dzs + ((c + 1) & 1) * kDzSlot, st, ahead, th, gate,
          kTile ? gq : gq + ((c + 1) & 1) * kGoutSlotFloats, dgate, dz_out, ldz,
          db ? wsums + ((c + 1) & 1) * kWarpSums : nullptr, experts, v, tau, dropout, thr,
          inv_keep);
      if (c + 2 < chunks) {
        fetch_ahead(ahead, th, gate, st, c + 2, experts, v);
        if (!kTile) {
          // into the slot chunk c read, in this thread's last dz stage
          fetch_gout(gq + (c & 1) * kGoutSlotFloats, gout, st, c + 2, kk, v, gvec);
          cp_async_commit();
        }
      }
    }
    if (c >= 0) {
      wg_wait<0>();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (tid == 0 && c + kSlots < chunks) {
        mbar_wait(&empty[s], (c / kSlots) & 1);  // every warp is done with chunk c
        copy_w(c + kSlots);
      }
    }
    fence_async_smem();
    __syncthreads();
  }
  wg_hold(acc0);
  wg_hold(acc1);
  if (st.part == 0 && st.ok && st.run_e >= 0 && st.run_e < experts)
    dgate[(size_t)st.nn * experts + st.run_e] = st.run;
  const int r0 = 16 * wq + (lane >> 2), cb = 2 * (lane & 3);
  const int col0 = slice * 4 * NI + 2 * NI * g;
  store_dx<NI>(acc0, dx, n0, r0, cb, col0, n, d);
  store_dx<NI>(acc1, dx, n0, r0, cb, col0 + NI, n, d);
}

template <int NI, bool kEmit, bool kDb, bool kTile>
cudaError_t launch_bwd_wgmma(const void* th, const void* wp, const void* gate, const void* gout,
                             const void* seed, int n, int d, int experts, int v, float tau,
                             float keep_prob, void* dx, void* dgate, void* dz, int ldz,
                             float* db_part, cudaStream_t stream) {
  const size_t smem = bwd_wg_smem(NI, kDb);
  auto kernel = moe_bwd_wgmma<NI, kEmit, kDb, kTile>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(n, kWgRows), cdiv(d, 4 * NI));
  kernel<<<grid, kWgThreads, smem, stream>>>(
      (const __nv_bfloat16*)th, (const __nv_bfloat16*)wp, (const float*)gate, (const float*)gout,
      (const int32_t*)seed, n, d, experts, v, tau, keep_prob, (float*)dx, (float*)dgate,
      (__nv_bfloat16*)dz, ldz, db_part);
  return cudaGetLastError();
}

int launch_bf16(int device, const void* th, const void* wp, const void* gate, const void* gout,
                const void* seed, int n, int d, int experts, int v, float tau, float keep_prob,
                void* dx, void* dgate, void* dz, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  // K6 takes V up to 4096 (past 128 with gout staged a chunk at a time);
  // K8 (no dz: the twokernel backward, whose K9 takes V <= 128) V <= 128
  if (v <= 0 || v > (dz != nullptr ? kMaxTargets : kMaxV) || d <= 0 || experts <= 0)
    return cudaErrorInvalidValue;
  if (keep_prob < 1.0f && seed == nullptr) return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int kk = experts * v;
  const bool tile = v <= kMaxV;
#define MOE_BWD_LAUNCH(NI, EMIT, TILE)                                                       \
  launch_bwd_wgmma<NI, EMIT, false, TILE>(th, wp, gate, gout, seed, n, d, experts, v, tau,   \
                                          keep_prob, dx, dgate, dz, kk, nullptr, s)
  if (bwd_ni(d) == 64) {
    if (dz == nullptr) return MOE_BWD_LAUNCH(64, false, true);
    return tile ? MOE_BWD_LAUNCH(64, true, true) : MOE_BWD_LAUNCH(64, true, false);
  }
  if (dz == nullptr) return MOE_BWD_LAUNCH(160, false, true);
  return tile ? MOE_BWD_LAUNCH(160, true, true) : MOE_BWD_LAUNCH(160, true, false);
#undef MOE_BWD_LAUNCH
}

// K9's first stage (moe_wgrad.cu): K6's dz units alone, with no dx product
// and no dgate sums (K8 made those), so nothing holds a block to one SM:
// a block owns 64 rows and kDzChunks chunks of 64 columns, its threads
// placed as in K6's body (a row a group of 4 lanes, 8 rows a warp), so dz
// and db's partials come out bit for bit as K7's first stage gives them.
// Each thread's th and gates of chunk c + 1 are loaded while chunk c's dz
// is made; one block barrier a chunk publishes the warp sums (two buffers,
// taken in turn), which 64 threads add in warp order.
constexpr int kDzChunks = 8;

__global__ void __launch_bounds__(kWgThreads) moe_dz_db_kernel(
    const __nv_bfloat16* __restrict__ th,  // [N, E·V]
    const float* __restrict__ gate,        // [N, E]
    const float* __restrict__ gout,        // [N, V]
    const int32_t* __restrict__ seed_dev,  // [1] (read if dropout)
    int n, int experts, int v, float tau, float keep_prob,
    __nv_bfloat16* __restrict__ dz_out,    // [N, ldz]
    int ldz,
    float* __restrict__ db_part) {         // [row tiles, E·V]
  extern __shared__ float dz_smem[];
  float* gs = dz_smem;                    // gout of the block's rows [64][V]
  float* wsums = dz_smem + kWgRows * v;   // [2][8 warps][64]
  const int kk = experts * v;
  const int n0 = blockIdx.x * kWgRows, tid = threadIdx.x;
  const int c0 = blockIdx.y * kDzChunks, c1 = min(c0 + kDzChunks, cdiv(kk, 64));
  for (int i = tid; i < kWgRows * v; i += kWgThreads)
    gs[i] = n0 + i / v < n ? gout[(size_t)n0 * v + i] : 0.0f;

  const bool dropout = keep_prob < 1.0f;
  const uint32_t seed = dropout ? (uint32_t)seed_dev[0] : 0u;
  const uint32_t thr = keep_threshold(keep_prob);
  const float inv_keep = 1.0f / keep_prob;
  DzLane st;
  st.row = tid / kLanesPerRow;
  st.part = tid % kLanesPerRow;
  st.nn = n0 + st.row;
  st.ok = st.nn < n;
  st.hrow = (uint32_t)st.nn * kHashRow + seed * kHashSeed;
  st.run_e = -1;
  st.run = 0.0f;
  Ahead ahead, next;
  fetch_ahead(ahead, th, gate, st, c0, experts, v);
  __syncthreads();  // gs is in

  for (int c = c0; c < c1; ++c) {
    if (c + 1 < c1) fetch_ahead(next, th, gate, st, c + 1, experts, v);
    // chunk c - 2's sums, the last readers of this buffer, were added
    // before the last barrier
    float* w = wsums + (c & 1) * kWarpSums;
    dz_chunk<true, true, false, true>(c, nullptr, st, ahead, th, gate, gs, nullptr, dz_out, ldz,
                                      w, experts, v, tau, dropout, thr, inv_keep);
    __syncthreads();
    if (tid < 64 && c * 64 + tid < kk)
      db_part[(size_t)blockIdx.x * kk + c * 64 + tid] = db_tile_sum(w, tid);
    if (c + 1 < c1) ahead = next;
  }
}

}  // namespace

// dz == NULL launches K8 (no dz stream); otherwise K6.  bf16: w is the
// packed image of ops/moe_kernels.py bwd_pack
#define MOE_BWD_ARGS                                                          \
  int device, const void *th, const void *w, const void *gate,               \
      const void *gout, const void *seed, int n, int d, int experts, int v,  \
      float tau, float keep_prob, void *dx, void *dgate, void *dz, void *stream
#define MOE_BWD_PASS \
  device, th, w, gate, gout, seed, n, d, experts, v, tau, keep_prob, dx, dgate, dz, stream

extern "C" int moe_bwd_f32(MOE_BWD_ARGS) { return launch_f32(MOE_BWD_PASS); }

extern "C" int moe_bwd_bf16(MOE_BWD_ARGS) { return launch_bf16(MOE_BWD_PASS); }

// K7's first stage (moe_bwd_wgrad.cu): K6's bf16 body with dz rows ldz
// apart (a multiple of 8, at least E·V) and db's partials [ceil(N / 64),
// E·V]; N > 0
extern "C" int moe_bwd_dz_db_bf16(MOE_BWD_ARGS, int ldz, float* db_part) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (v <= 0 || v > kMaxV || d <= 0 || experts <= 0 || n <= 0 || dz == nullptr ||
      ldz < experts * v || ldz % 8 != 0)
    return cudaErrorInvalidValue;
  if (keep_prob < 1.0f && seed == nullptr) return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bwd_ni(d) == 64)
    return launch_bwd_wgmma<64, true, true, true>(th, w, gate, gout, seed, n, d, experts, v,
                                                  tau, keep_prob, dx, dgate, dz, ldz, db_part, s);
  return launch_bwd_wgmma<160, true, true, true>(th, w, gate, gout, seed, n, d, experts, v, tau,
                                                 keep_prob, dx, dgate, dz, ldz, db_part, s);
}

// K9's first stage: dz in bf16 rows ldz apart (a multiple of 8, at least
// E·V) and db's partials [ceil(N / 64), E·V], bit for bit those of
// moe_bwd_dz_db_bf16; N > 0
extern "C" int moe_dz_db_bf16(int device, const void* th, const void* gate, const void* gout,
                              const void* seed, int n, int experts, int v, float tau,
                              float keep_prob, void* dz, int ldz, float* db_part, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (v <= 0 || v > kMaxV || experts <= 0 || n <= 0 || dz == nullptr ||
      ldz < experts * v || ldz % 8 != 0)
    return cudaErrorInvalidValue;
  if (keep_prob < 1.0f && seed == nullptr) return cudaErrorInvalidValue;
  if (cdiv(cdiv(experts * v, 64), kDzChunks) > 65535) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)kWgRows * v + 2 * kWarpSums);
  err = set_smem(moe_dz_db_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(n, kWgRows), cdiv(cdiv(experts * v, 64), kDzChunks));
  moe_dz_db_kernel<<<grid, kWgThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)th, (const float*)gate, (const float*)gout, (const int32_t*)seed, n,
      experts, v, tau, keep_prob, (__nv_bfloat16*)dz, ldz, db_part);
  return cudaGetLastError();
}
