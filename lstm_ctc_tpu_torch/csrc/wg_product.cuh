// One tensor-core product engine for the bf16 weight-side products of the
// folds: K3's dx = dg·wxᵀ and dwx = xᵀ·dg (lstm_bwd_fold.cu) and K7's dw =
// xᵀ·dz (moe_bwd_wgrad.cu).
//
// A block computes a 128 x 128 float32 tile C over a range of the depth:
// two consumer warpgroups (threads 0-255) each own 64 rows of the tile as
// one m64n128k16 accumulator (64 registers a thread), and one copy warp
// (warp 8) keeps a ring of three operand stages in flight with TMA tensor
// copies (cp.async.bulk.tensor) that complete on the stage's mbarrier.
// Two blocks share an SM (~97 KB of shared memory and 90 registers a
// thread each), so that one block's first loads and epilogue overlap the
// other's products: measured ~20% faster than one block an SM with five
// stages, bit for bit the same sums (PERF.md, PR 10).
//
// A stage is one 64-deep chunk: A as two 64 x 64 boxes (one a warpgroup),
// B as two 64 x 64 boxes (the tile's 128 columns).  Every box is 64 rows
// of 64 bf16 (128 bytes) written by the copy engine with the 128-byte
// swizzle (unit j of row r at unit j ^ (r % 8)), the image the wgmma
// descriptors read; rows past a tensor's end read as zero.
//
// Two forms:
//   * K-major (C = A·Bᵀ, both operands with the depth contiguous): a box
//     is [64 rows of M or N][64 deep]; a k-step of 16 moves the descriptor
//     32 bytes inside the swizzled row (as wgmma.cuh's sw128_desc);
//   * MN-major (C = Aᵀ·B, contracted over the shared leading row
//     dimension: each operand's row is the depth, M or N contiguous): a
//     box is [64 deep][64 of M or N]; wgmma reads it through its transpose
//     immediates, with the leading offset the 8192 bytes between the two
//     64-column boxes of B and the stride offset the 1024 bytes between
//     8-deep row groups; a k-step of 16 moves the descriptor 2048 bytes.
//
// The ring: full[s] completes by the stage's bytes, empty[s] by one arrival
// of each of the eight consumer warps once the products reading stage s
// have completed (wgmma.wait_group 1 once the next chunk's products are
// under way).  Every consumer waits on every stage in order, so no warpgroup
// meets a barrier a phase ahead of the one it needs.
//
// What each product reads where is the `Op` of its kernel: the tensor
// maps' coordinates of each box, the chunks of a block's depth, and the
// epilogue, which writes the accumulators from registers (the split-K
// partials, or the output itself).  tests/test_torch_wg_product_layout.py
// emulates the images, the descriptors' element positions and the ops'
// row maps on the CPU.
#pragma once

#include <cuda.h>

#include "tile_product.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kEngThreads = 288;           // two consumer warpgroups and the copy warp
constexpr int kEngStages = 3;              // chunks in flight a block
constexpr int kEngBlocks = 2;              // blocks an SM
constexpr int kBox = 64 * kSwRow;          // one 64 x 64 bf16 box, 8 KB
constexpr int kEngStage = 4 * kBox;        // A (two boxes) and B (two boxes)
constexpr int kEngTile = 128;              // rows and columns of a block's tile

// dynamic shared memory of an engine block: the ring, its barriers, and
// 1 KB of slack to align the ring to 1024 bytes
constexpr size_t kEngSmem = 1024 + (size_t)kEngStages * kEngStage + 2 * kEngStages * 8;

// descriptor of an MN-major operand with the 128-byte swizzle at `addr`:
// 64-wide column blocks `lbo` bytes apart, 8-deep row groups 1024 bytes
// apart (wgmma reads it transposed)
__device__ __forceinline__ uint64_t sw128_desc_mn(uint32_t addr, uint32_t lbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;  // between 64-wide blocks of M or N
  d |= (uint64_t)(kSwAtom >> 4) << 32;         // between 8-deep row groups
  d |= (uint64_t)1 << 62;                      // 128-byte swizzle
  return d;
}

// d (+)= A · B, m64n128k16, bf16 operands from shared-memory descriptors,
// A and B transposed (MN-major) when kTrans; scale_d = 0 overwrites d
template <int kTrans>
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTrans));
}

// one box of `map` at coordinates c (innermost first) into shared memory,
// completing its bytes on `bar`; coordinates past the tensor read zero
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int c0, int c1,
                                        int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// box coordinates, innermost first
struct Coord {
  int c[4];
};

// The accumulator of a consumer thread: warpgroup `wg` (0 or 1) holds rows
// 64 wg .. 64 wg + 63 of the tile; thread (warp w of its warpgroup, lane
// l) holds, in registers 4j .. 4j + 3, rows r = 16 w + l / 4 and r + 8,
// columns 8j + 2 (l % 4) and + 1 (wgmma.cuh)
struct Frag {
  int wg, row, col;  // row and col of register 0 inside the warpgroup's 64 x 128
};

// The engine's kernel.  Op provides:
//   static constexpr int kTrans        0: K-major, 1: MN-major
//   range(tile, split, &k0, &k1)       the block's chunks [k0, k1)
//   a_box(tile, wg, k) / b_box(tile, j, k)   Coord of A box wg, B box j
//   store(tile, split, acc, frag)      the epilogue of one consumer thread
// The grid: blockIdx.x the tile (Op decodes it), blockIdx.y the split.
template <class Op>
__global__ void __launch_bounds__(kEngThreads, kEngBlocks)
    wg_product_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b, const Op op) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kEngStages * kEngStage);
  uint64_t* empty = full + kEngStages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int tile = blockIdx.x, split = blockIdx.y;
  int k0, k1;
  op.range(tile, split, k0, k1);

  if (tid == 0) {
    for (int s = 0; s < kEngStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {  // the copy warp: one thread starts the copies, the warp stays converged
    if (lane == 0) {
      for (int k = k0, i = 0; k < k1; ++k, ++i) {
        const int s = i % kEngStages;
        if (i >= kEngStages) mbar_wait(&empty[s], (i / kEngStages - 1) & 1);
        unsigned char* st = ring + (size_t)s * kEngStage;
        mbar_expect(&full[s], kEngStage);
        for (int h = 0; h < 2; ++h) {
          const Coord a = op.a_box(tile, h, k);
          tma_box(st + h * kBox, &map_a, a.c[0], a.c[1], a.c[2], a.c[3], &full[s]);
          const Coord b = op.b_box(tile, h, k);
          tma_box(st + (2 + h) * kBox, &map_b, b.c[0], b.c[1], b.c[2], b.c[3], &full[s]);
        }
      }
    }
    __syncwarp();
    return;
  }

  const int wg = tid / 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  const uint32_t base = smem_addr(ring);
  for (int k = k0, i = 0; k < k1; ++k, ++i) {
    const int s = i % kEngStages;
    mbar_wait(&full[s], (i / kEngStages) & 1);
    const uint32_t a = base + s * kEngStage + wg * kBox, b = base + s * kEngStage + 2 * kBox;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (Op::kTrans)
        wgmma_128<1>(acc, sw128_desc_mn(a + ks * 2048, kBox), sw128_desc_mn(b + ks * 2048, kBox),
                     1);
      else
        wgmma_128<0>(acc, sw128_desc(a + ks * 32), sw128_desc(b + ks * 32), 1);
    }
    wg_commit();
    // the products of the chunk before have completed: release its stage
    wg_wait<1>();
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % kEngStages]);
  }
  wg_wait<0>();
  wg_hold(acc);
  const Frag f{wg, 16 * (warp & 3) + (lane >> 2), 2 * (lane & 3)};
  op.store(tile, split, acc, f);
}

// ---- host ----

typedef CUresult (*TensorMapEncode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                    const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                    const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                    CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime's entry-point
// query (nothing new is linked); null where it is missing
inline TensorMapEncode tensor_map_encode() {
  static TensorMapEncode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
        cudaSuccess)
#endif
      return (TensorMapEncode) nullptr;
    return found == cudaDriverEntryPointSuccess ? (TensorMapEncode)p : (TensorMapEncode) nullptr;
  }();
  return fn;
}

// A bf16 tensor as 4 dims (innermost first, dims[0] contiguous) with the
// byte strides of dims 1-3 (multiples of 16), read in boxes of 64 x box1 x
// 1 x box3 elements (box1 · box3 = 64: 64 rows of 128 bytes), swizzled
inline cudaError_t bf16_map(CUtensorMap* map, const void* base, const uint64_t (&dims)[4],
                            const uint64_t (&strides)[3], int box1, int box3) {
  const TensorMapEncode encode = tensor_map_encode();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (((uintptr_t)base & 15) != 0) return cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 16 != 0) return cudaErrorInvalidValue;
  cuuint64_t gd[4], gs[3];
  for (int i = 0; i < 4; ++i) gd[i] = dims[i] > 0 ? dims[i] : 1;
  for (int i = 0; i < 3; ++i) gs[i] = strides[i];
  const cuuint32_t box[4] = {64, (cuuint32_t)box1, 1, (cuuint32_t)box3};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), gd,
                            gs, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a row of v bf16 padded to a multiple of 8 (16 bytes, as the copy engine
// wants rows), and a count of floats rounded up to 256 bytes
__host__ __device__ constexpr int round8(int v) { return (v + 7) / 8 * 8; }
inline size_t align64(size_t floats) { return (floats + 63) / 64 * 64; }

// SMs of the device, or 0 if it cannot be asked
inline int device_sms(int device) {
  int sms = 0;
  return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) == cudaSuccess
             ? sms
             : 0;
}

// Splits of the depth for `tiles` output tiles of `chunks` chunks each on
// `sms` SMs (one block an SM): the fewest block-rounds of work, a round
// being ceil(blocks / sms) blocks of ceil(chunks / splits) chunks, where
// each split past the first also costs its partial's write and read (about
// three chunks of a block); at most 8, and never a split of no chunk.
inline int engine_splits(int tiles, int chunks, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= 8 && s <= chunks; ++s) {
    const long long rounds = cdiv(tiles * s, sms);
    const long long cost = rounds * (cdiv(chunks, s) + (s > 1 ? 3 : 0));
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// chunks [k0, k1) of split `split` of `splits` over `chunks`
__host__ __device__ __forceinline__ void split_range(int chunks, int splits, int split, int& k0,
                                                     int& k1) {
  const int per = cdiv(chunks, splits);
  k0 = split * per;
  k1 = k0 + per < chunks ? k0 + per : chunks;
}

template <class Op>
cudaError_t run_engine(const CUtensorMap& a, const CUtensorMap& b, const Op& op, int tiles,
                       int splits, cudaStream_t stream) {
  if (tiles <= 0) return cudaSuccess;
  cudaError_t err = set_smem(wg_product_kernel<Op>, kEngSmem);
  if (err != cudaSuccess) return err;
  wg_product_kernel<Op><<<dim3(tiles, splits), kEngThreads, kEngSmem, stream>>>(a, b, op);
  return cudaGetLastError();
}

// out[i] = Σ over splits of part[split][i], in split order (common.cuh's
// split_sum_kernel), four elements a thread: the engine's split-K partials
__global__ void split_sum4_kernel(const float4* __restrict__ part, int splits, size_t count4,
                                  float4* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = 0; s < splits; ++s) {
      const float4 p = part[s * count4 + i];
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    out[i] = v;
  }
}

inline cudaError_t sum_splits(const float* part, int splits, size_t count, float* out,
                              int sms, cudaStream_t stream) {
  if (count % 4 == 0)
    split_sum4_kernel<<<8 * sms, 256, 0, stream>>>((const float4*)part, splits, count / 4,
                                                   (float4*)out);
  else
    split_sum_kernel<<<8 * sms, 256, 0, stream>>>(part, splits, count, out);
  return cudaGetLastError();
}

// out[c] = Σ over row groups q of part[q][c] for many groups (K3's dbias,
// K7's db): a block takes 32 columns, one a lane; warp w sums the groups
// [w·per, (w + 1)·per) in order (per = ceil(groups / 8)), and the eight
// warps' sums are added in warp order
__global__ void group_sum_kernel(const float* __restrict__ part, int groups, int cols,
                                 float* __restrict__ out) {
  __shared__ float sums[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x / 32, c = blockIdx.x * 32 + lane;
  const int per = cdiv(groups, 8), q1 = min(groups, (w + 1) * per);
  float v = 0.0f;
  if (c < cols) {
#pragma unroll 8
    for (int q = w * per; q < q1; ++q) v += part[(size_t)q * cols + c];
  }
  sums[w][lane] = v;
  __syncthreads();
  if (w == 0 && c < cols) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += sums[i][lane];
    out[c] = t;
  }
}

inline cudaError_t sum_groups(const float* part, int groups, int cols, float* out,
                              cudaStream_t stream) {
  group_sum_kernel<<<cdiv(cols, 32), 256, 0, stream>>>(part, groups, cols, out);
  return cudaGetLastError();
}

// dst[r · ld + c] = src[r · cols + c] in bf16 (round to nearest even), for
// r < rows, c < cols: the float32 activations cast to the products' operand
// dtype, rows padded to ld (a multiple of 8) so that they are 16-byte
// aligned for the copy engine.  A thread casts 4 neighbouring columns of a
// row (one 16-byte load where cols is a multiple of 4); blockIdx.y walks
// the rows.
__global__ void cast_rows_bf16(const float* __restrict__ src, int rows, int cols, int ld,
                               __nv_bfloat16* __restrict__ dst) {
  const int c = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (c >= cols) return;
  const bool vec = (cols & 3) == 0;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* in = src + (size_t)r * cols + c;
    __nv_bfloat16* out = dst + (size_t)r * ld + c;
    if (vec) {
      const float4 v = *reinterpret_cast<const float4*>(in);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(out) = packed;
    } else {
      for (int i = 0; i < 4 && c + i < cols; ++i) out[i] = __float2bfloat16(in[i]);
    }
  }
}

inline cudaError_t cast_rows(const float* src, int rows, int cols, int ld, __nv_bfloat16* dst,
                             cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return cudaSuccess;
  const dim3 grid(cdiv(cols, 4 * 128), rows < 8192 ? rows : 8192);
  cast_rows_bf16<<<grid, 128, 0, stream>>>(src, rows, cols, ld, dst);
  return cudaGetLastError();
}

}  // namespace
