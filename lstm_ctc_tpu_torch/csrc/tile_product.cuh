// The tile products shared by the MoE head's kernels (moe_fwd.cu,
// moe_bwd.cu, moe_wgrad.cu, moe_bwd_wgrad.cu) and K3's input-side products
// (lstm_bwd_fold.cu): the shared-memory tile layout and the two tile
// products (bf16 mma.sync, float32 FMA) over it.  The dropout hash is in
// common.cuh.
//
// A tile product computes acc[M, N] += A[M, K] · B[K, N] with A held in
// shared memory row-major ([M][ldx], K contiguous) and B row-major
// ([K][ldw], N contiguous): M is Tile<T>::kRows, N at most kMaxV (padded
// to 16), K a multiple of 16.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxV = 128;     // widest N of a tile product
// an expert's targets, at most, of the MoE head's K4-K6 (V-tiled or
// K-chunked past kMaxV; ops/moe_kernels.py targets_eligible picks the set)
constexpr int kMaxTargets = 4096;

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

template <typename T>
struct Tile;  // rows per block (M), shared-memory row padding (elements)

template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kRows = 64;
  static constexpr int kPad = 8;  // 16 bytes: rows fall on other banks
};

template <>
struct Tile<float> {
  static constexpr int kRows = 32;
  static constexpr int kPad = 4;
};

// Shared-memory layout of a product with depth K = d and width N = v:
// dp and vp are K and N padded to 16; A rows are ldx elements apart, B
// rows ldw, and the float32 result rows ldz.
struct Layout {
  int dp, vp, ldx, ldw, ldz;
};

template <typename T>
__host__ __device__ Layout layout(int d, int v) {
  Layout l;
  l.dp = round16(d);
  l.vp = round16(v);
  l.ldx = l.dp + Tile<T>::kPad;
  l.ldw = l.vp + Tile<T>::kPad;
  l.ldz = l.vp + 4;
  return l;
}

// Tile product in bf16 on the tensor cores (ldmatrix, mma.sync m16n8k16).
// Warp w owns row tile w % 4 and column tiles w / 4, w / 4 + 2, ... of 16
// columns each.
struct MmaAcc {
  static constexpr int kTiles = (kMaxV / 16 + 1) / 2;
  float acc[kTiles][2][4];  // [column tile][8-column half][mma C registers]

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][h][i] = 0.0f;
  }

  // acc += A[:, k0 : k0 + kc] · B[0 : kc, :]
  __device__ void product(const __nv_bfloat16* xs, const __nv_bfloat16* ws,
                          int k0, int kc, const Layout& l) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
    const int tm = warp % 4, tn0 = warp / 4, ntn = l.vp / 16;
    // ldmatrix row addresses: A rows tm·16 + lane % 16 at k + 8·(lane / 16);
    // B rows k = lane % 16 at column 8·(lane / 16)
    const __nv_bfloat16* x_lane = xs + (tm * 16 + (lane & 15)) * l.ldx + (lane >> 4) * 8;
    const __nv_bfloat16* w_lane = ws + (lane & 15) * l.ldw + (lane >> 4) * 8;
    for (int kk = 0; kk < kc; kk += 16) {
      uint32_t fa[4];
      ldsm_x4(fa, x_lane + k0 + kk);
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const int tn = tn0 + 2 * j;
        if (tn < ntn) {
          uint32_t fb[4];
          ldsm_x4_trans(fb, w_lane + kk * l.ldw + tn * 16);
          mma_16816(acc[j][0], fa, fb[0], fb[1]);
          mma_16816(acc[j][1], fa, fb[2], fb[3]);
        }
      }
    }
  }

  // lane holds rows lane / 4 and + 8, columns 2·(lane % 4) and + 1 of each
  // 8-column half
  __device__ void store(float* zs, const Layout& l) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
    const int tm = warp % 4, tn0 = warp / 4;
    float* row = zs + (tm * 16 + (lane >> 2)) * l.ldz + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int tn = tn0 + 2 * j;
      if (tn < l.vp / 16) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* dst = row + tn * 16 + h * 8;
          *reinterpret_cast<float2*>(dst) = make_float2(acc[j][h][0], acc[j][h][1]);
          *reinterpret_cast<float2*>(dst + 8 * l.ldz) =
              make_float2(acc[j][h][2], acc[j][h][3]);
        }
      }
    }
  }

  // zs += acc, each element by the thread that holds it (store's places)
  __device__ void accumulate(float* zs, const Layout& l) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
    const int tm = warp % 4, tn0 = warp / 4;
    float* row = zs + (tm * 16 + (lane >> 2)) * l.ldz + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int tn = tn0 + 2 * j;
      if (tn < l.vp / 16) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* dst = row + tn * 16 + h * 8;
          dst[0] += acc[j][h][0];
          dst[1] += acc[j][h][1];
          dst[8 * l.ldz] += acc[j][h][2];
          dst[8 * l.ldz + 1] += acc[j][h][3];
        }
      }
    }
  }
};

// Tile product in float32 FMA (no TF32 rounding).  Thread (rg, cg) owns
// rows 2·rg, 2·rg + 1 and columns cg + 16·j.
struct FmaAcc {
  static constexpr int kRowsPer = Tile<float>::kRows / 16;
  static constexpr int kColsPer = kMaxV / 16;
  float acc[kRowsPer][kColsPer];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) acc[i][j] = 0.0f;
  }

  __device__ void product(const float* xs, const float* ws, int k0, int kc,
                          const Layout& l) {
    const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
    for (int kk = 0; kk < kc; ++kk) {
      float a[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) a[i] = xs[(rg * kRowsPer + i) * l.ldx + k0 + kk];
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) {
        if (j * 16 < l.vp) {
          const float b = ws[kk * l.ldw + cg + 16 * j];
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
        }
      }
    }
  }

  __device__ void store(float* zs, const Layout& l) const {
    const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < kColsPer; ++j)
        if (j * 16 < l.vp) zs[(rg * kRowsPer + i) * l.ldz + cg + 16 * j] = acc[i][j];
  }

  __device__ void accumulate(float* zs, const Layout& l) const {
    const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < kColsPer; ++j)
        if (j * 16 < l.vp) zs[(rg * kRowsPer + i) * l.ldz + cg + 16 * j] += acc[i][j];
  }
};

template <typename T>
struct Product;
template <>
struct Product<__nv_bfloat16> { using Acc = MmaAcc; };
template <>
struct Product<float> { using Acc = FmaAcc; };

// Sets a kernel's dynamic shared memory and asks for all of the SM's
// unified L1/shared storage as shared memory.
template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem > kMaxSmemPerBlock) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
}

}  // namespace
