// The second stage of the MoE head's bf16 weight gradient, shared by K7
// (moe_bwd_wgrad.cu, after K6's body) and K9 (moe_wgrad.cu, after its dz
// stage): both first write dz in bf16 to a scratch whose rows are E·V
// rounded up to 8 (16-byte aligned rows for the copy engine) and db's
// float32 partials, one row per 64-row tile of N, of the unrounded dz.
// Then:
//   * db = the partials added over the tiles (wg_product.cuh's group_sum
//     order);
//   * x is cast to bf16 rows padded to 8 (cast_rows);
//   * dw = x(bf16)ᵀ · dz(bf16) on wg_product.cuh's engine, MN-major (both
//     operands' rows are the depth), the depth split over blocks where the
//     (D/128)·(E·V/128) tiles cannot fill the card, the partials added in
//     split order.
// No atomics: the results do not depend on the schedule, and equal dz bits
// and partials give equal (dw, db) bits.
#pragma once

#include "wg_product.cuh"

namespace {

// dw = x(bf16)ᵀ · dz(bf16), MN-major: tile = tm·tiles_n + tn, chunk k the
// rows 64 k .. 64 k + 63; split `split` writes its partial to out +
// split·D·E·V
struct DwOp {
  static constexpr int kTrans = 1;
  int tiles_n, chunks, splits, d, kk;
  float* out;  // [splits, D, E·V]

  __device__ void range(int, int split, int& k0, int& k1) const {
    split_range(chunks, splits, split, k0, k1);
  }
  // x(bf16) [N, Dp] as (D, N, 1, 1): 64 columns of D, 64 rows
  __device__ Coord a_box(int tile, int wg, int k) const {
    return Coord{{kEngTile * (tile / tiles_n) + 64 * wg, 64 * k, 0, 0}};
  }
  // dz(bf16) [N, ldz] as (E·V, N, 1, 1): 64 columns of E·V, 64 rows
  __device__ Coord b_box(int tile, int j, int k) const {
    return Coord{{kEngTile * (tile % tiles_n) + 64 * j, 64 * k, 0, 0}};
  }
  __device__ void store(int tile, int split, const float (&acc)[64], const Frag& f) const {
    const int tm = tile / tiles_n, tn = tile % tiles_n;
    float* part = out + (size_t)split * d * kk;
    const bool pairs = (kk & 1) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = kEngTile * tm + 64 * f.wg + f.row + 8 * h;
      if (m >= d) continue;
      float* row = part + (size_t)m * kk;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = kEngTile * tn + 8 * j + f.col;
        if (c >= kk) continue;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
        } else {
          row[c] = v0;
          if (c + 1 < kk) row[c + 1] = v1;
        }
      }
    }
  }
};

// The bf16 path's scratch, in floats from a 256-byte aligned start: dz in
// bf16 [N, ldz], x in bf16 [N, Dp], db's partials [ceil(N / 64), E·V],
// dw's partials (more than one split only)
struct Bf16Plan {
  int ldz, dp, tiles, chunks, splits;
  size_t dz, xb, db_part, dw_part, floats;
};

inline Bf16Plan bf16_plan(int n, int d, int experts, int v, int sms) {
  Bf16Plan p;
  const int kk = experts * v;
  p.ldz = round8(kk);
  p.dp = round8(d);
  p.chunks = cdiv(n, 64);
  p.tiles = cdiv(d, kEngTile) * cdiv(kk, kEngTile);
  p.splits = engine_splits(p.tiles, p.chunks, sms);
  size_t o = 0;
  p.dz = o;
  o += align64((size_t)n * p.ldz / 2);
  p.xb = o;
  o += align64((size_t)n * p.dp / 2);
  p.db_part = o;
  o += align64((size_t)p.chunks * kk);
  p.dw_part = o;
  if (p.splits > 1) o += align64((size_t)p.splits * d * kk);
  p.floats = o + 64;  // slack for the alignment of the start
  return p;
}

// the scratch's start, aligned to 256 bytes (bf16_plan counts the slack)
inline float* scratch_base(void* scratch) {
  return (float*)(((uintptr_t)scratch + 255) & ~(uintptr_t)255);
}

// db, the x cast and dw from the dz and db partials that the first stage
// wrote at `base` (bf16_plan's offsets); N > 0
inline cudaError_t dw_db_from_dz(const void* x, int n, int d, int kk, const Bf16Plan& p,
                                 float* base, void* dw, void* db, int sms, cudaStream_t s) {
  const __nv_bfloat16* dz = (const __nv_bfloat16*)(base + p.dz);
  __nv_bfloat16* xb = (__nv_bfloat16*)(base + p.xb);
  const float* db_part = base + p.db_part;
  float* dw_part = p.splits > 1 ? base + p.dw_part : (float*)dw;
  cudaError_t err;
  if ((err = sum_groups(db_part, p.chunks, kk, (float*)db, s)) != cudaSuccess) return err;
  if ((err = cast_rows((const float*)x, n, d, p.dp, xb, s)) != cudaSuccess) return err;

  CUtensorMap x_map, dz_map;
  const uint64_t xrow = (uint64_t)p.dp * 2, zrow = (uint64_t)p.ldz * 2;
  if ((err = bf16_map(&x_map, xb, {(uint64_t)d, (uint64_t)n, 1, 1},
                      {xrow, xrow * n, xrow * n}, 64, 1)) != cudaSuccess)
    return err;
  if ((err = bf16_map(&dz_map, dz, {(uint64_t)kk, (uint64_t)n, 1, 1},
                      {zrow, zrow * n, zrow * n}, 64, 1)) != cudaSuccess)
    return err;
  const DwOp op{cdiv(kk, kEngTile), p.chunks, p.splits, d, kk, dw_part};
  err = run_engine(x_map, dz_map, op, p.tiles, p.splits, s);
  if (err != cudaSuccess || p.splits == 1) return err;
  return sum_splits(dw_part, p.splits, (size_t)d * kk, (float*)dw, sms, s);
}

}  // namespace
