// Hopper's product and copy engines for the MoE head's bf16 kernels (K4/K5
// in moe_fwd.cu, K6/K8 in moe_bwd.cu): warpgroup products (wgmma) with both
// operands in shared memory, their shared-memory descriptors, bulk copies
// (cp.async.bulk) that complete on an mbarrier (common.cuh), and the fences
// and barriers around them.
//
// Every operand tile is K-major with the 128-byte swizzle: rows of 64 bf16
// (128 bytes), 8-row groups of 1024 bytes at 1024-byte aligned addresses,
// the 16-byte unit j of row r stored at unit j ^ (r % 8).  The packing
// functions of ops/moe_kernels.py write W in exactly this image, so that a
// bulk copy of bytes lands a ready operand; the kernels write their x and
// dz tiles in it with 16-byte stores.  A k-step of 16 moves a descriptor by
// 32 bytes inside the swizzled row.
//
// The accumulator of m64nNk16 (N / 2 float registers a thread): thread t of
// the warpgroup (warp w = t / 32, lane l) holds, in registers 4j .. 4j + 3,
// rows 16w + l / 4 and + 8, columns 8j + 2 (l % 4) and + 1: (row, col),
// (row, col + 1), (row + 8, col), (row + 8, col + 1).
#pragma once

#include "common.cuh"

namespace {

constexpr int kSwRow = 128;        // bytes of a swizzled row (64 bf16)
constexpr int kSwAtom = 8 * kSwRow;  // an 8-row group

// descriptor of a K-major tile with the 128-byte swizzle at shared address
// `addr` (1024-aligned, or moved inside a row by a k-step): rows of the
// tile 128 bytes apart, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;                 // leading offset (unused when swizzled)
  d |= (uint64_t)(kSwAtom >> 4) << 32;    // stride between 8-row groups
  d |= (uint64_t)1 << 62;                 // 128-byte swizzle
  return d;
}

// the byte offset of the 16-byte unit j (0-7) of row r in a swizzled tile
__host__ __device__ __forceinline__ uint32_t sw128_offset(int r, int j) {
  return (uint32_t)(r * kSwRow + ((j ^ (r & 7)) << 4));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's committed product groups are
// still running
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the product instructions that own it
template <int M>
__device__ __forceinline__ void wg_hold(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// generic-proxy stores to shared memory made visible to the products and
// bulk copies (async proxy) that follow a barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1-15) among `count` threads (whole warps)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// `bytes` (a multiple of 16) from global into this block's shared memory,
// completing them on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// one arrival on a barrier of this block (a consumer warp releasing a
// stage: the products' wait has completed its reads of it)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// dynamic shared memory rounded up to the next 1024-byte boundary (the
// swizzle is computed from address bits)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// (x >> 9) < keep_threshold(keep) exactly when the hash's uniform
// (x >> 9) · 2^-23 < keep (common.cuh hash_uniform): both sides are exact
// in float32
__device__ __forceinline__ uint32_t keep_threshold(float keep_prob) {
  return (uint32_t)ceilf(keep_prob * 8388608.0f);
}

// the murmur3 finalizer of hash_uniform, from the summed row, column and
// seed terms; kept where the result's top 23 bits are below `threshold`
__device__ __forceinline__ bool hash_keeps(uint32_t x, uint32_t threshold) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (x >> 9) < threshold;
}

constexpr uint32_t kHashRow = 0x9E3779B1u, kHashCol = 0x85EBCA77u, kHashSeed = 0xC2B2AE3Du;

// d (+)= A · B for a 64-row A and an N-row (K-major) B, 16 deep, both from
// shared-memory descriptors; scale_d = 0 overwrites d
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<72> {
  __device__ __forceinline__ static void mma(float (&d)[36], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35"
        "}, %36, %37, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<160> {
  __device__ __forceinline__ static void mma(float (&d)[80], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79"
        "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

}  // namespace
