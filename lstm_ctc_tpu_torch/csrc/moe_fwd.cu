// K4 and K5: the MoE head's fused expert mix, forward.
//
// Replaces the TPU kernels lstm_ctc_tpu/ops/moe_pallas.py _fwd_kernel (:212,
// K4) and _fwd_kernel_res (:217, K5), both with the body _fwd_body
// (:189-210), launched by _pallas_fwd (:358) from moe_mix_fused (:574):
//
//   out[n, v] = sum_e gate[n, e] * drop(tau * tanh(x[n] · W_e + b_e))[v]
//
// K4 (serving, evaluation) does not write the [N, E·V] expert tile to
// memory.  K5 (training) also stores th = tanh(x · W + b) [N, E·V] in the
// compute dtype for the backward (moe_bwd.cu), as the TPU kernel stashes
// it (:199-202, :369); its mix uses th unrounded.  Dropout keeps an element
// where hash_uniform(n, e·V + v, seed) < keep_prob and scales it by 1 /
// keep_prob; the hash is the reference's murmur3 finalizer, bit for bit.
// K4 takes the seed as an argument; K5 reads it from device memory, where
// the training step drew it, so the host never waits for it.
//
// bf16, the main paths (moe_fwd_wgmma).  What bounds it on the H100: by
// count, the expert product, 2·N·D·E·V (81.5 GFLOP at N = 12288, D = 640,
// E = V = 72: 0.082 ms on the bf16 tensor cores); in fact the epilogue,
// N·E·V tanhf, hashes and FMAs on the CUDA cores, whose dependent chains
// the few warps of a block hide badly: without its products the kernel
// takes ~3/4 of its time, without its epilogue ~3/5 (PERF.md section 6).
//
// Roles: a block owns 64 rows (wgmma's M).  G consumer warpgroups (G = 3
// for NP <= 72, 2 for NP = 128: z, mix and the bias prefetch must fit the
// registers a thread) and one copy warp.  The consumers cast the x tile
// to bf16 once into shared memory in the 128-byte-swizzled image that
// wgmma's descriptor reads (wgmma.cuh); it stays for all experts.  W comes
// packed (ops/moe_kernels.py fwd_pack: per expert and 64-deep chunk of D,
// W_eᵀ as [NP][64], V padded to NP, swizzled), so that a stage is filled
// by plain bulk copies of whole tiles, with no tensor map.  Where the x
// tile leaves room for fewer than two stages (D above 1344 at NP = 72,
// 1280 at NP = 128), x is streamed instead: each stage also holds its x
// chunk, which the consumers cast into it from global memory once the
// stage has landed, then meet at a named barrier before the products.
// Any D runs; the main shapes keep x resident.
//
// The ring: stage q = (group p, chunk c) holds the tiles of experts Gp ..
// Gp + G - 1 for chunk c; up to 16 stages, as shared memory holds (5 at D
// = 640).  full[q % S] completes by bytes (the copy warp's
// arrive.expect_tx and the copies' complete_tx), empty[q % S] by one
// arrival of every consumer warp once its products of that stage have
// completed (wgmma.wait_group 1, so the next chunk's products are already
// queued).  Every warpgroup consumes every stage in order, so a stage's
// barrier is never a whole phase ahead of its waiter (parity waits are
// unambiguous; a design where each warpgroup waited only on its own
// experts' stages broke that and was dropped).
//
// The epilogue: warpgroup g takes expert Gp + g; its m64nNPk16 accumulator
// holds, for every expert, the same (row, column) positions a thread, so
// mix += gate · drop(tau · tanh(z + b)) is an FMA per register into a
// second accumulator of the same shape: z never goes through shared
// memory, and no block barrier is needed per expert.  At V = NP the
// epilogue has no per-column branch, so the tanh chains can interleave.
// While one warpgroup's epilogue runs, the others' products run.  K5
// stores th as bf16 pairs from the registers.
//
// V past 128 (every V whose lcm with 128 is at most 4096, as the
// reference's fused kernels take): an expert's columns are cut into
// V-tiles of 128, the rest padded to the first compiled width that holds
// it (16, 32, 64, 72 or 128), and the V-tile is a grid dimension beside the
// row tile: a block mixes all E experts for its own columns only, since
// out[n, v] reads W's columns v of each expert and nothing else, so no
// block needs another's sums.  The x tile is read once a V-tile; the ring,
// the epilogue and the hash at global (n, e·V + v) are as above.  The tiles
// of 128 are one launch and the rest, if any, a second (its own NP).
//
// The grid: one block a 64-row tile (and V-tile), one block an SM
// (~180-220 KB of shared memory); 192 blocks at N = 12288, 224 at N =
// 14336 on 132 SMs run in two waves, the second 45% or 70% full.  Splitting the experts of a
// tile across blocks would even the waves but needs a second pass to sum
// the mixes; not done.  Clusters of two blocks sharing each W stage by
// multicast halve W's L2 traffic and were measured no faster (the kernel
// is bound by its epilogue, not by L2), so they are not used.
//
// Deterministic: each expert's chunks sum in order in the accumulator,
// each warpgroup's experts in order into its mix, and out = the
// warpgroups' mixes in warpgroup order; no atomics.
//
// float32: the FMA tile product of tile_product.cuh (no TF32), one block a
// tile of 32 rows and a V-tile of at most 128 columns, looping over the
// experts (moe_fwd_kernel).

#include "tile_product.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kChunk = 64;  // rows of W_e per shared-memory chunk

struct FwdLayout {
  Layout l;
  size_t x_bytes, w_elems, wz_bytes;
};

constexpr int kRows = Tile<float>::kRows;  // rows of a block

__host__ __device__ FwdLayout fwd_layout(int d, int v) {
  FwdLayout f;
  f.l = layout<float>(d, v);
  f.x_bytes = sizeof(float) * kRows * (size_t)f.l.ldx;
  f.w_elems = (size_t)kChunk * f.l.ldw;
  const size_t w_bytes = 2 * sizeof(float) * f.w_elems;  // two chunk buffers
  const size_t z_bytes = sizeof(float) * kRows * (size_t)f.l.ldz;
  f.wz_bytes = w_bytes > z_bytes ? w_bytes : z_bytes;
  return f;
}

// One chunk of a V-tile of W_e (rows k0 .. k0 + 64, the vt columns from
// column col = e·V + v0, zero padded to vp) held in registers as 16-byte
// vectors between its load and its store to shared memory.  Used when a
// row segment of W_e is a whole number of 16-byte vectors (V % 4 == 0).
struct ChunkRegs {
  static constexpr int kVecs = kChunk * (kMaxV / 4) / kThreads;
  uint4 reg[kVecs];

  __device__ void load(const float* __restrict__ w, int k0, int d, int ev, int col, int vt,
                       const Layout& l) {
    const int per_row = l.vp / 4;
    const int valid = vt / 4;
    const uint4* base = reinterpret_cast<const uint4*>(w + col);
    const int row_vecs = ev / 4;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      const int kk = idx / per_row, c = idx - kk * per_row;
      const int k = k0 + kk;
      reg[j] = (kk < kChunk && k < d && c < valid)
                   ? __ldg(base + (size_t)k * row_vecs + c)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ void store(float* ws, const Layout& l) const {
    const int per_row = l.vp / 4;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      const int kk = idx / per_row, c = idx - kk * per_row;
      if (kk < kChunk) reinterpret_cast<uint4*>(ws + (size_t)kk * l.ldw)[c] = reg[j];
    }
  }
};

// The same chunk staged element by element (any V).
__device__ void stage_scalar(float* ws, const float* __restrict__ w, int k0, int d, int ev,
                             int col, int vt, const Layout& l) {
  for (int i = threadIdx.x; i < kChunk * l.vp; i += kThreads) {
    const int kk = i / l.vp, c = i - kk * l.vp;
    const int k = k0 + kk;
    ws[kk * l.ldw + c] = (k < d && c < vt) ? w[(size_t)k * ev + col + c] : 0.0f;
  }
}

// The float32 path: the FMA tile product of tile_product.cuh (no TF32).  A
// block owns 32 rows and one V-tile of at most 128 columns (the tile
// product's widest N), columns v0 = 128 blockIdx.y .. of every expert: the
// mix of its columns needs no other block's.
template <bool kStash>
__global__ void __launch_bounds__(kThreads, 2) moe_fwd_kernel(
    const float* __restrict__ x,     // [N, D]
    const float* __restrict__ w,     // [D, E·V]
    const float* __restrict__ b,     // [E·V]
    const float* __restrict__ gate,  // [N, E]
    int n, int d, int experts, int v, float tau, float keep_prob,
    uint32_t seed_arg,               // K4's seed
    const int32_t* __restrict__ seed_dev,  // K5's seed [1] (read if dropout)
    float* __restrict__ out,         // [N, V]
    float* __restrict__ th) {        // [N, E·V] (K5)
  constexpr int kPerRow = kThreads / kRows;  // threads per output row
  constexpr int kCols = kMaxV / kPerRow;     // output columns per thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int v0 = blockIdx.y * kMaxV, vt = min(kMaxV, v - v0);
  const FwdLayout f = fwd_layout(d, vt);
  const Layout& l = f.l;
  float* xs = reinterpret_cast<float*>(smem_raw);                // [NB][ldx]
  float* ws = reinterpret_cast<float*>(smem_raw + f.x_bytes);    // 2 x [64][ldw]
  float* zs = reinterpret_cast<float*>(smem_raw + f.x_bytes);    // [NB][ldz]
  const int n0 = blockIdx.x * kRows;
  const int ev = experts * v;
  const bool vec = v % 4 == 0;
  const bool dropout = keep_prob < 1.0f;
  const uint32_t seed = kStash ? (dropout ? (uint32_t)seed_dev[0] : 0u) : seed_arg;

  // the x tile, once for all experts
  for (int i = threadIdx.x; i < kRows * l.dp; i += kThreads) {
    const int r = i / l.dp, k = i - r * l.dp;
    xs[r * l.ldx + k] = (n0 + r < n && k < d) ? x[(size_t)(n0 + r) * d + k] : 0.0f;
  }

  const int row = threadIdx.x / kPerRow, lane = threadIdx.x % kPerRow;
  const bool row_ok = n0 + row < n;
  const float inv_keep = 1.0f / keep_prob;
  float mix[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) mix[j] = 0.0f;

  Product<float>::Acc acc;
  acc.zero();
  ChunkRegs next;
  const int chunks = (l.dp + kChunk - 1) / kChunk;
  const int total = experts * chunks;
  if (vec) next.load(w, 0, d, ev, v0, vt, l);
  for (int it = 0; it < total; ++it) {
    const int e = it / chunks, k0 = (it - e * chunks) * kChunk;
    const int col = e * v + v0;  // the tile's first column of expert e
    float* buf = ws + (it & 1) * f.w_elems;
    if (vec)
      next.store(buf, l);
    else
      stage_scalar(buf, w, k0, d, ev, col, vt, l);
    __syncthreads();
    if (vec && it + 1 < total) {
      const int e2 = (it + 1) / chunks;
      next.load(w, (it + 1 - e2 * chunks) * kChunk, d, ev, e2 * v + v0, vt, l);
    }
    acc.product(xs, buf, k0, min(kChunk, l.dp - k0), l);
    if (k0 + kChunk < l.dp) continue;

    // expert e is complete: z -> shared memory, then the epilogue
    __syncthreads();  // every warp is done reading the W buffers
    acc.store(zs, l);
    acc.zero();
    __syncthreads();
    if (kStash) {
      // z -> th in place, and th to the stash in whole rows
      for (int i = threadIdx.x; i < kRows * vt; i += kThreads) {
        const int r = i / vt, c = i - r * vt;
        const float t = tanhf(zs[r * l.ldz + c] + b[col + c]);
        zs[r * l.ldz + c] = t;
        if (n0 + r < n) th[(size_t)(n0 + r) * ev + col + c] = t;
      }
      __syncthreads();
    }
    if (row_ok) {
      const float g = gate[(size_t)(n0 + row) * experts + e];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = lane + kPerRow * j;
        if (c < vt) {
          const float t = kStash ? zs[row * l.ldz + c] : tanhf(zs[row * l.ldz + c] + b[col + c]);
          float a = tau * t;
          if (dropout) {
            const float u = hash_uniform((uint32_t)(n0 + row), (uint32_t)(col + c), seed);
            a = u < keep_prob ? a * inv_keep : 0.0f;
          }
          mix[j] = fmaf(g, a, mix[j]);
        }
      }
    }
    __syncthreads();  // zs is free before the next chunk lands on it
  }

  if (row_ok) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + kPerRow * j;
      if (c < vt) out[(size_t)(n0 + row) * v + v0 + c] = mix[j];
    }
  }
}

template <bool kStash>
int launch_f32(int device, const void* x, const void* w, const void* b, const void* gate, int n,
               int d, int experts, int v, float tau, float keep_prob, uint32_t seed,
               const void* seed_dev, void* out, void* th, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  if (v <= 0 || v > kMaxTargets || d <= 0 || experts <= 0) return cudaErrorInvalidValue;
  if (kStash && keep_prob < 1.0f && seed_dev == nullptr) return cudaErrorInvalidValue;
  const FwdLayout f = fwd_layout(d, min(v, kMaxV));  // the widest V-tile
  const size_t smem = f.x_bytes + f.wz_bytes;
  err = set_smem(moe_fwd_kernel<kStash>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(n, kRows), cdiv(v, kMaxV));
  moe_fwd_kernel<kStash><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)b, (const float*)gate, n, d, experts, v,
      tau, keep_prob, seed, (const int32_t*)seed_dev, (float*)out, (float*)th);
  return cudaGetLastError();
}


// ---- bf16: warpgroup products fed by bulk copies ----

constexpr int kWgRows = 64;                 // rows of a block (wgmma's M)
// consumer warpgroups a block: three for NP <= 72 (more warps to hide the
// epilogue's latency; z, mix and the bias fit 128 registers a thread), two
// for NP = 128 (168 registers a thread)
__host__ __device__ constexpr int fwd_groups(int np) { return np <= 72 ? 3 : 2; }
__host__ __device__ constexpr int fwd_threads(int np) { return 128 * fwd_groups(np) + 32; }
constexpr int kFwdMaxStages = 16;
constexpr int kVTile = 128;                 // the widest V-tile (wgmma N) a block takes
constexpr int kXChunk = kWgRows * kSwRow;   // 64 rows x 64 columns of x

// the padded expert width: wgmma's N (a multiple of 8) among the compiled
// widths; ops/moe_kernels.py fwd_pack_width gives the same
__host__ __device__ constexpr int fwd_np(int v) {
  return v <= 16 ? 16 : v <= 32 ? 32 : v <= 64 ? 64 : v <= 72 ? 72 : 128;
}

struct FwdPlan {
  int stages;
  bool stream_x;
  size_t smem;
};

// The x tile (chunks of 64 columns), then the W ring (as many stages, up to
// 16, as shared memory holds), then the barriers; 1 KB of slack for
// alignment.  Where the x tile leaves room for fewer than two stages (D
// above 1280-1664, by NP), x is streamed instead: each stage also holds
// the x chunk of its W tiles, which the consumers cast into it from global
// memory.
inline FwdPlan fwd_plan(int d, int np) {
  const size_t w_bytes = (size_t)fwd_groups(np) * np * kSwRow;  // a group of experts' tiles
  const size_t fixed = 1024 + 2 * kFwdMaxStages * sizeof(uint64_t);
  auto fit = [&](size_t x_bytes, size_t stage_bytes) {
    FwdPlan p;
    const size_t room = kMaxSmemPerBlock - fixed - x_bytes;
    p.stages = (int)(room / stage_bytes < (size_t)kFwdMaxStages ? room / stage_bytes
                                                                 : (size_t)kFwdMaxStages);
    p.smem = fixed + x_bytes + p.stages * stage_bytes;
    return p;
  };
  const size_t x_bytes = (size_t)cdiv(d, 64) * kXChunk;
  FwdPlan p;
  if (fixed + x_bytes + 2 * w_bytes <= kMaxSmemPerBlock) {
    p = fit(x_bytes, w_bytes);
    p.stream_x = false;
  } else {
    p = fit(0, kXChunk + w_bytes);
    p.stream_x = true;
  }
  return p;
}

// chunks c0 .. c0 + count - 1 of the x tile (64 rows from n0, 64 columns
// a chunk), cast to bf16 and written at xs in the swizzled image, zero past
// N and D; 8 columns (one 16-byte unit) a thread at a time
__device__ __forceinline__ void stage_x(unsigned char* xs, const float* __restrict__ x, int n0,
                                        int n, int d, int c0, int count, int tid, int threads) {
  const int units = count * 8;  // 16-byte units a row
  const bool vec = (d & 3) == 0;
  for (int u = tid; u < kWgRows * units; u += threads) {
    const int r = u / units, cu = u - r * units, col = (c0 * 8 + cu) * 8, nn = n0 + r;
    float f[8];
    if (nn < n && vec && col + 8 <= d) {
      const float4 lo = __ldg(reinterpret_cast<const float4*>(x + (size_t)nn * d + col));
      const float4 hi = __ldg(reinterpret_cast<const float4*>(x + (size_t)nn * d + col + 4));
      f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
      f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        f[i] = (nn < n && col + i < d) ? x[(size_t)nn * d + col + i] : 0.0f;
    }
    uint4 q;
    uint32_t* w = &q.x;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(xs + (cu >> 3) * kXChunk + sw128_offset(r, cu & 7)) = q;
  }
}

// The epilogue of one expert from the accumulator registers, rows r0 and
// r0 + 8 and columns 8j + cb and + 1 of the block's V-tile of vt columns:
// t = tanh(z + b) (K5 stashes it in bf16 at th0 / th1, the rows' pointers
// at the tile's first column of the expert, null past N), then mix +=
// gate · drop(tau · t) from the unrounded t.  h0, h1: the hash's row, seed
// and column terms of column cb.  even: V is even, so th's pairs are
// 4-byte aligned.  With kFull (vt = NP and V even) and kDrop fixed at
// compile time the full-width path has no per-column branch, so that its
// tanh chains can interleave.
template <int NP, bool kStash, bool kFull, bool kDrop>
__device__ __forceinline__ void expert_epilogue(const float (&z)[NP / 2], float (&mix)[NP / 2],
                                                const float (&bias)[NP / 4], float g0, float g1,
                                                int v, bool even, int cb, float tau, uint32_t h0,
                                                uint32_t h1, uint32_t thr, float inv_keep,
                                                __nv_bfloat16* th0, __nv_bfloat16* th1) {
  const bool even_v = kFull || even;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j) {
    const int c = 8 * j + cb;
    if (!kFull && c >= v) continue;
    const bool two = kFull || c + 1 < v;
    float t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) t[i] = tanhf(z[4 * j + i] + bias[2 * j + (i & 1)]);
    if (kStash) {
      // th in the compute dtype; the mix below uses it unrounded
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat16* row = h == 0 ? th0 : th1;
        if (row == nullptr) continue;
        if (even_v) {
          *reinterpret_cast<__nv_bfloat162*>(row + c) =
              __floats2bfloat162_rn(t[2 * h], t[2 * h + 1]);
        } else {
          row[c] = __float2bfloat16(t[2 * h]);
          if (two) row[c + 1] = __float2bfloat16(t[2 * h + 1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!kFull && (i & 1) && !two) continue;
      float a = tau * t[i];
      if (kDrop) {
        const uint32_t hx = (i < 2 ? h0 : h1) + (uint32_t)(8 * j + (i & 1)) * kHashCol;
        a = hash_keeps(hx, thr) ? a * inv_keep : 0.0f;
      }
      mix[4 * j + i] = fmaf(i < 2 ? g0 : g1, a, mix[4 * j + i]);
    }
  }
}

// The last warp keeps the W ring full: stage q = (group p, chunk c) takes
// the packed tiles (Gp + h, c), h < G, once the consumers released its
// previous group (with stream_x, after the stage's x chunk).  The G =
// fwd_groups(NP) consumer warpgroups before it take expert Gp + g of every
// group, run the m64nNPk16 products over the chunks, then the epilogue from
// their accumulator registers.  Every warpgroup consumes every stage in
// order, so a stage's barrier phase is never more than one ahead of its
// waiter.
//
// V-tiles: block (i, t) owns rows 64 i .. and the V-tile of columns col_base
// = v0 + NP t .. (at most NP) of every expert; out[n, v] needs only W's
// columns v of each expert, so no block needs another's mix.  wp points at
// the launch's first tile of expert 0; an expert's image is expert_bytes
// apart (ops/moe_kernels.py fwd_pack: [chunks][NP][64] a tile, the tiles of
// an expert in column order).
template <int NP, bool kStash>
__global__ void __launch_bounds__(fwd_threads(NP), 1) moe_fwd_wgmma(
    const float* __restrict__ x,            // [N, D] float32
    const __nv_bfloat16* __restrict__ wp,   // [E][tiles][chunks][NP][64], swizzled
    size_t expert_bytes,
    const float* __restrict__ b,            // [E·V]
    const float* __restrict__ gate,         // [N, E]
    int n, int d, int experts, int v, int v0, float tau, float keep_prob, uint32_t seed_arg,
    const int32_t* __restrict__ seed_dev,   // K5's seed [1] (read if dropout)
    float* __restrict__ out,                // [N, V]
    __nv_bfloat16* __restrict__ th,         // [N, E·V] (K5)
    int stages, bool stream_x) {
  constexpr int kGroups = fwd_groups(NP), kConsumers = 128 * kGroups;
  constexpr uint32_t kTile = NP * kSwRow;    // one expert's chunk
  constexpr int kRegs = NP / 2;
  // a stage: [the x chunk, with stream_x] the tiles of a group of experts
  const uint32_t w_at = stream_x ? kXChunk : 0, stage = w_at + kGroups * kTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* xs = align1024(smem_raw);
  const int chunks = cdiv(d, 64);
  unsigned char* ring = stream_x ? xs : xs + (size_t)chunks * kXChunk;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)stages * stage);
  uint64_t* empty = full + stages;
  const int n0 = blockIdx.x * kWgRows;
  const int col_base = v0 + (int)blockIdx.y * NP, vt = min(NP, v - col_base);
  const int groups = cdiv(experts, kGroups), total = groups * chunks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kGroups);  // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup's index, made warp-uniform for the compiler
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kGroups) {
    // the copy warp, converged (lane 0 issues)
    {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(wp) +
                                 (size_t)blockIdx.y * chunks * kTile;
      for (int q = 0; q < total; ++q) {
        const int s = q % stages, p = q / chunks, c = q - p * chunks;
        const int tiles = min(kGroups, experts - kGroups * p);
        if (q >= stages) mbar_wait(&empty[s], ((q / stages) - 1) & 1);
        if (lane == 0) {
          mbar_expect(&full[s], kTile * tiles);
          for (int h = 0; h < tiles; ++h) {
            const unsigned char* from =
                src + (size_t)(kGroups * p + h) * expert_bytes + (size_t)c * kTile;
            bulk_copy(ring + (size_t)s * stage + w_at + h * kTile, from, kTile, &full[s]);
          }
        }
        __syncwarp();
      }
    }
  } else {
    const int tid = threadIdx.x, g = wg, wq = warp & 3;
    if (!stream_x) {
      stage_x(xs, x, n0, n, d, 0, chunks, tid, kConsumers);
      fence_async_smem();
      named_sync(1, kConsumers);
    }

    const int r0 = 16 * wq + (lane >> 2), cb = 2 * (lane & 3);
    const int ev = experts * v;
    const bool ok0 = n0 + r0 < n, ok1 = n0 + r0 + 8 < n;
    const bool dropout = keep_prob < 1.0f;
    const uint32_t seed = kStash ? (dropout ? (uint32_t)seed_dev[0] : 0u) : seed_arg;
    const uint32_t thr = keep_threshold(keep_prob);
    const float inv_keep = 1.0f / keep_prob;
    const uint32_t h0 = (uint32_t)(n0 + r0) * kHashRow + seed * kHashSeed;
    const uint32_t h1 = h0 + 8u * kHashRow;
    const bool even_v = (v & 1) == 0;
    const uint32_t xs_a = smem_addr(xs), ring_a = smem_addr(ring);
    float z[kRegs], mix[kRegs];
#pragma unroll
    for (int i = 0; i < kRegs; ++i) z[i] = mix[i] = 0.0f;

    for (int p = 0; p < groups; ++p) {
      const int e = kGroups * p + g;
      const bool mine = e < experts;  // the last group may have fewer experts
      // expert e's bias and gates, loaded while its products run
      const int col0 = e * v + col_base;  // the tile's first column of expert e
      float bias[NP / 4], g0 = 0.0f, g1 = 0.0f;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const int c = 8 * j + cb;
        bias[2 * j] = mine && c < vt ? __ldg(b + col0 + c) : 0.0f;
        bias[2 * j + 1] = mine && c + 1 < vt ? __ldg(b + col0 + c + 1) : 0.0f;
      }
      if (mine && ok0) g0 = __ldg(gate + (size_t)(n0 + r0) * experts + e);
      if (mine && ok1) g1 = __ldg(gate + (size_t)(n0 + r0 + 8) * experts + e);

      // (in the last group a warpgroup without an expert runs its products
      // on the stage's stale part and does not use them)
      for (int c = 0; c < chunks; ++c) {
        const int q = p * chunks + c, s = q % stages;
        mbar_wait(&full[s], (q / stages) & 1);
        if (stream_x) {
          // every consumer is past the stage's previous products, as the
          // copy warp waited for them: its x chunk can be written
          stage_x(ring + (size_t)s * stage, x, n0, n, d, c, 1, tid, kConsumers);
          fence_async_smem();
          named_sync(1, kConsumers);
        }
        __syncwarp();
        if (c == 0) wg_hold(z);  // the epilogue's reads of z stay before
        wg_fence();
        const uint32_t a = stream_x ? ring_a + s * stage : xs_a + c * kXChunk;
        const uint32_t bw = ring_a + s * stage + w_at + g * kTile;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Wgmma<NP>::mma(z, sw128_desc(a + ks * 32), sw128_desc(bw + ks * 32), (c | ks) != 0);
        wg_commit();
        if (c > 0) {
          wg_wait<1>();  // chunk c - 1 is read: release its stage
          if (lane == 0) mbar_arrive(&empty[(q - 1) % stages]);
        }
      }
      wg_wait<0>();
      wg_hold(z);
      if (lane == 0) mbar_arrive(&empty[(p * chunks + chunks - 1) % stages]);
      if (!mine) continue;

      // the epilogue, from the accumulator registers
      __nv_bfloat16* th0 = kStash && ok0 ? th + (size_t)(n0 + r0) * ev + col0 : nullptr;
      __nv_bfloat16* th1 = kStash && ok1 ? th + (size_t)(n0 + r0 + 8) * ev + col0 : nullptr;
      const uint32_t hc = (uint32_t)(col0 + cb) * kHashCol;
      if (vt == NP && even_v) {
        if (dropout)
          expert_epilogue<NP, kStash, true, true>(z, mix, bias, g0, g1, vt, even_v, cb, tau,
                                                  h0 + hc, h1 + hc, thr, inv_keep, th0, th1);
        else
          expert_epilogue<NP, kStash, true, false>(z, mix, bias, g0, g1, vt, even_v, cb, tau,
                                                   h0 + hc, h1 + hc, thr, inv_keep, th0, th1);
      } else {
        if (dropout)
          expert_epilogue<NP, kStash, false, true>(z, mix, bias, g0, g1, vt, even_v, cb, tau,
                                                   h0 + hc, h1 + hc, thr, inv_keep, th0, th1);
        else
          expert_epilogue<NP, kStash, false, false>(z, mix, bias, g0, g1, vt, even_v, cb, tau,
                                                    h0 + hc, h1 + hc, thr, inv_keep, th0, th1);
      }
    }

    // out = the warpgroups' mixes summed in warpgroup order, the others'
    // handed over in register order through the (drained) ring
    named_sync(1, kConsumers);
    float* xch = reinterpret_cast<float*>(ring);
    const int t = tid & 127;
    if (g > 0) {
#pragma unroll
      for (int i = 0; i < kRegs; ++i) xch[((g - 1) * kRegs + i) * 128 + t] = mix[i];
    }
    named_sync(1, kConsumers);
    if (g == 0) {
#pragma unroll
      for (int h = 1; h < kGroups; ++h)
#pragma unroll
        for (int i = 0; i < kRegs; ++i) mix[i] += xch[((h - 1) * kRegs + i) * 128 + t];
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const int c = 8 * j + cb;
        if (c >= vt) continue;
        const bool two = c + 1 < vt;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!(h == 0 ? ok0 : ok1)) continue;
          const float m0 = mix[4 * j + 2 * h], m1 = mix[4 * j + 2 * h + 1];
          float* dst = out + (size_t)(n0 + r0 + 8 * h) * v + col_base + c;
          if (even_v) {
            *reinterpret_cast<float2*>(dst) = make_float2(m0, m1);
          } else {
            dst[0] = m0;
            if (two) dst[1] = m1;
          }
        }
      }
    }
  }
}

// `tiles` V-tiles of NP columns from column v0, their packed image at wp
template <int NP, bool kStash>
cudaError_t launch_wgmma(const void* x, const unsigned char* wp, size_t expert_bytes, int v0,
                         int tiles, const void* b, const void* gate, int n, int d, int experts,
                         int v, float tau, float keep_prob, uint32_t seed, const void* seed_dev,
                         void* out, void* th, cudaStream_t stream) {
  const FwdPlan p = fwd_plan(d, NP);
  auto kernel = moe_fwd_wgmma<NP, kStash>;
  const cudaError_t err = set_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(n, kWgRows), tiles);
  kernel<<<grid, fwd_threads(NP), p.smem, stream>>>(
      (const float*)x, (const __nv_bfloat16*)wp, expert_bytes, (const float*)b,
      (const float*)gate, n, d, experts, v, v0, tau, keep_prob, seed, (const int32_t*)seed_dev,
      (float*)out, (__nv_bfloat16*)th, p.stages, p.stream_x);
  return cudaGetLastError();
}

// The V-tiles of an expert's V columns (ops/moe_kernels.py fwd_tiles gives
// the same): past V = 128, tiles of 128 columns, then the rest padded to
// the first compiled width that holds it; one launch for the tiles of 128
// and one for the rest, each a V-tile a grid row (a runtime count, not a
// template axis).
template <bool kStash>
int launch_bf16(int device, const void* x, const void* wp, const void* b, const void* gate, int n,
                int d, int experts, int v, float tau, float keep_prob, uint32_t seed,
                const void* seed_dev, void* out, void* th, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  if (v <= 0 || v > kMaxTargets || d <= 0 || experts <= 0) return cudaErrorInvalidValue;
  if (kStash && keep_prob < 1.0f && seed_dev == nullptr) return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int chunks = cdiv(d, 64);
  const int full = v > kVTile ? v / kVTile : 0, rest = v - full * kVTile;
  const int rest_np = rest > 0 ? fwd_np(rest) : 0;
  const size_t tile_row_bytes = (size_t)chunks * kSwRow;  // a tile's bytes per column of NP
  const size_t expert_bytes = tile_row_bytes * (full * kVTile + rest_np);
  const unsigned char* base = reinterpret_cast<const unsigned char*>(wp);
  if (full > 0) {
    err = launch_wgmma<kVTile, kStash>(x, base, expert_bytes, 0, full, b, gate, n, d, experts, v,
                                       tau, keep_prob, seed, seed_dev, out, th, s);
    if (err != cudaSuccess || rest == 0) return err;
  }
  const unsigned char* wr = base + tile_row_bytes * full * kVTile;
  const int v0 = full * kVTile;
  switch (rest_np) {
    case 16:
      return launch_wgmma<16, kStash>(x, wr, expert_bytes, v0, 1, b, gate, n, d, experts, v, tau,
                                      keep_prob, seed, seed_dev, out, th, s);
    case 32:
      return launch_wgmma<32, kStash>(x, wr, expert_bytes, v0, 1, b, gate, n, d, experts, v, tau,
                                      keep_prob, seed, seed_dev, out, th, s);
    case 64:
      return launch_wgmma<64, kStash>(x, wr, expert_bytes, v0, 1, b, gate, n, d, experts, v, tau,
                                      keep_prob, seed, seed_dev, out, th, s);
    case 72:
      return launch_wgmma<72, kStash>(x, wr, expert_bytes, v0, 1, b, gate, n, d, experts, v, tau,
                                      keep_prob, seed, seed_dev, out, th, s);
    default:
      return launch_wgmma<128, kStash>(x, wr, expert_bytes, v0, 1, b, gate, n, d, experts, v,
                                       tau, keep_prob, seed, seed_dev, out, th, s);
  }
}

}  // namespace

// bf16: w is the packed image of ops/moe_kernels.py fwd_pack
#define MOE_FWD_ARGS                                                          \
  int device, const void *x, const void *w, const void *b, const void *gate, \
      int n, int d, int experts, int v, float tau, float keep_prob,          \
      uint32_t seed, void *out, void *stream

extern "C" int moe_fwd_f32(MOE_FWD_ARGS) {
  return launch_f32<false>(device, x, w, b, gate, n, d, experts, v, tau, keep_prob, seed, nullptr,
                           out, nullptr, stream);
}

extern "C" int moe_fwd_bf16(MOE_FWD_ARGS) {
  return launch_bf16<false>(device, x, w, b, gate, n, d, experts, v, tau, keep_prob, seed,
                            nullptr, out, nullptr, stream);
}

#define MOE_STASH_ARGS                                                        \
  int device, const void *x, const void *w, const void *b, const void *gate, \
      const void *seed, int n, int d, int experts, int v, float tau,         \
      float keep_prob, void *out, void *th, void *stream

extern "C" int moe_fwd_stash_f32(MOE_STASH_ARGS) {
  return launch_f32<true>(device, x, w, b, gate, n, d, experts, v, tau, keep_prob, 0u, seed, out,
                          th, stream);
}

extern "C" int moe_fwd_stash_bf16(MOE_STASH_ARGS) {
  return launch_bf16<true>(device, x, w, b, gate, n, d, experts, v, tau, keep_prob, 0u, seed,
                           out, th, stream);
}
