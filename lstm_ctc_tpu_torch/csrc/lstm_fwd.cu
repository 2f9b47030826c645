// Kernel K1: one BLSTM layer's whole-sequence forward, both directions.
//
// Replaces the TPU kernel lstm_ctc_tpu/ops/lstm_pallas.py _make_fwd_kernel
// (:57-131), launched by pallas_fwd (:474) from bilstm_dual_scan_fused
// (:694).  Per step and direction: gates = gx[t] + h·wh, TF gate order
// (i, j, f, o) with peepholes on i, f from c_prev and on o from c_new,
// sigmoid(f + forget_bias), out = sigmoid(o)·tanh(c_new), the projection,
// then dynamic_rnn masking (c and h freeze past the length, out is zero
// there) and the packed-row reset (keep = 0 zeroes the carry first).
//
// What bounds it on the H100: the recurrence is sequential, so a step's
// latency is what counts; the bytes (gx read once, out written once: 0.047
// ms at B = 32, T = 384, H = P = 320) and the operations are far below it.
// A step needs the direction's recurrent and projection weights (320x1280
// + 320x320: 1.0 MB in bf16), which one block's 227 KB cannot hold; a
// block that re-reads them from L2 every step spends ~30 us a step.  Split
// over a cluster, a block still reads its slices (100 KB of wh, 30 KB of
// proj at the flagship width) from shared memory at every step: ~1,000
// cycles at the SM's 128 bytes a cycle, the floor of this design's
// products; the rest of a step is the chain of hand-offs, block barriers
// and the cell's transcendentals.
//
// Design: a thread-block cluster of 8 blocks (or 16, below) per (direction, tile of R
// batch rows) owns the whole time loop.  Block q owns hidden units [q·US,
// (q+1)·US) (all four gates of them) and projection columns [q·PS,
// (q+1)·PS); its slices of wh and proj are copied into its shared memory
// once and stay there (bf16; in f32, which must not round to TF32, they
// are read from L2 and the products are FMA split over all threads).  A
// step with a projection:
//   a. wait for h(t-1) on this block's own mbarrier; the gate sums of the
//      owned units from the full rounded h [R, P] times the wh slice, on
//      the tensor cores with the roles turned (mma_product_t: the slice as
//      mma.sync's A, the R <= 8 rows as its n, so no padding rows are
//      multiplied; at H = P = 320 5 k-slices of 4 steps x 2 groups of 5
//      tiles, each warp's loads issued ahead of its mma); one block barrier
//      for the partial sums, whose rows are padded against bank conflicts.
//      wh's columns are interleaved in shared memory (unit-major), so a
//      cell thread reads the four gates of its unit in a slice as one
//      16-byte load;
//   b. the cell update of the owned units; the rounded cell output is
//      handed to every block of the cluster (below);
//   c. wait for the cell-output slices of all the cluster's blocks;
//   d. the owned projection columns from the full cell output; one block
//      barrier;
//   e. masking; the new rounded h slice is handed to every block.
// Without a projection (P == H) the cell output is h, and a step is a, b.
//
// The hand-offs.  The threads of a slice gather 16 bytes by shuffles and
// write them into every block with st.async, each store completing its
// bytes on the receiver's mbarrier; a receiver arms its own barrier with
// the bytes of the next phase (count 1, arrive.expect_tx) and waits only on
// that phase's parity.  So nothing waits for all the blocks at once, and
// no store but these is released: the global stores of out, c_all and h_all
// are issued after the hand-off and nothing ever waits for them (a
// cluster barrier in its place would release them too).  Why each buffer
// is safe:
//   - the cell-output buffer (one): a peer writes cell(t+1) into it only
//     after it has all of h(t), and this block hands off its h(t) after the
//     block barrier of d, i.e. after it is done reading cell(t);
//   - h with a projection (one buffer): a peer writes h(t) only after it
//     has all of cell(t), which this block hands off after the block
//     barrier of a, i.e. after it is done reading h(t-1);
//   - h without a projection: a peer writes h(t) right after its own gate
//     product, which needs only h(t-1), so it may run a step ahead of a
//     block still reading h(t-1): h(t) goes to buffer t & 1 (a peer writes
//     h(t+1) into the buffer of h(t-1) only after it has this block's
//     h(t), handed off after this block's barrier of a at step t);
//   - the barriers: a receiver arms a barrier's next phase right after its
//     wait on the current one, before it hands off the slice that a peer
//     needs before it can send that next phase (the same chains), so every
//     phase is armed before its first byte lands and is waited on before
//     the next one can start;
//   - the partial sums: the cell (or h) threads read them before they hand
//     their values off, and the product that overwrites them waits for the
//     hand-off that includes this block's own slice.
// A last cluster barrier keeps every block resident until all hand-offs
// have landed.
//
// The packed-row reset is part of the step: keep(t+1) is applied where
// c and h are kept for the next step (c in a register, h as staged for the
// hand-off, in float32 before the rounding, as the plain version does:
// exact for any keep, and the wrapper's keep, cells.step_masks, is 0 or
// 1), while out, c_all, h_all, cfin and hfin take the values before it.
// gx of each step (R rows x 4 x US floats) and keep reach a ring of 3 to 6
// steps (as shared memory allows) by cp.async, issued by the block's last
// threads (off the cell threads) a ring's depth less one ahead; lengths,
// the peepholes and the
// carried c and h stay in registers.  Operands of both products are
// rounded to the compute dtype; sums, the carry and every output stay
// float32, and the partial sums of the k-slices are added in slice order.
//
// One bf16 block fills an SM, and only so many 8-block clusters are
// resident at once (14 on an H100 SXM): the launcher asks the occupancy API
// and takes the smallest R of {4, 6, 8} whose 2·ceil(B/R) clusters all fit,
// so the grid runs in one wave (B = 32: R = 6, 12 clusters).  The slices
// (~140 KB at H = P = 320, the recipes' widest) and the ring must fit in
// shared memory.
//
// Wider layers take 16-block clusters (C = 16, the H100's non-portable
// most), where no 8-block plan fits: a block owns US = H/16 units, at most
// 64, so H <= 1024 (Kaldi's BLSTMP widths, H = 1024 with P = 256: wh's
// slice [256, 256] is 128 KB, proj's [1024, 16] 32 KB).  To fit beside
// them in 227 KB the gate product runs fewer, deeper k-slices (at most 8
// steps of 16 a slice, 2 tiles a warp: 16 warps at H = 1024, P = 256, half
// the partial sums of 8-block's 4-step slices), and proj's slice, 16 or 32
// columns wide, is not padded (its loads' bank conflicts cost less than a
// third more of its bytes).  Each hand-off goes to 16 blocks, two stores a
// lane in bf16, and each barrier waits for 16 slices.  Fewer 16-block
// clusters are resident at once (7-8 on an H100 SXM), so the grid may run
// in waves.  8 blocks stay wherever their plan fits: the flagship's layers
// (H = P = 320) are unchanged.  A block owns at most 128 units (H <= 2048):
// in float32 the slices are read from L2 whatever their size.
//
// The streamed plan: a bf16 layer whose slices fit no resident plan (H = P
// = 1024 without a projection: 8 MB of wh a direction, a block's slice 528
// KB; H = 2048 with P = 512) still runs on 16-block clusters, but a block
// keeps only the first k-rows of its wh slice in shared memory and streams
// the rest of wh, and all of proj, from L2 at every step through a ring
// of chunks (lstm_cluster.cuh: a bulk copy a chunk, completing on its
// slot's barrier, a slot refilled after the block barrier that ends its
// reads).  The weights do not depend on the step, so the next step's first
// chunks are in flight while the block hands off and waits for h.  A
// step's bytes are then the streamed part of the slices (~528 KB a block
// at H = P = 1024, which 7 resident clusters read from L2 together):
// L2's bandwidth, not the latency chain, bounds this plan.  The products
// stay on the tensor cores with the resident plan's roles and k-slices
// (streamed_product_t: each warp owns whole column tiles over the whole
// depth and adds its slices in order onto gx, as the cell thread adds the
// resident plan's partial sums), so a shape that fits both plans gives the
// same bits on both (chip_smoke.py forces this plan at the flagship width
// and at H = P = 512).  wh rows are copied one by one into rows padded by
// 16 bytes (the ldmatrix banks), proj's unpadded rows a chunk at a time.
// Every cluster streams its direction's whole slices every step whatever
// its rows, so a cluster takes as many rows as shared memory holds: a
// thread of the cell phase owns unit tid % US of rows tid / US, + 512 /
// US, .. (cell_rows at most; the masking phase likewise its column of rows
// tid / PS, ..), their carries in registers, and past 8 rows the products
// take the rows as two n8 tiles that share each A fragment of the weights,
// so one pass over the ring serves 16 rows; gx is read from L2 into the
// gate sums' init as the product starts, and keep(t+1) into registers as
// the step starts (no ring of them).  The launcher tries R of {16, 8, 6,
// 4, 2} (16 on 16 blocks only) and takes the fewest waves, then the fewest
// clusters, then the smallest R: at B = 32, R = 16 in one wave at every
// streamed width, 768 to 2048 units.  A row's sums do not depend on the
// rows beside it, so every R gives the same bits.  Safety, beside the
// buffers above:
//   - the ring is the block's own; a slot is refilled only after the
//     block barrier that ends every thread's reads of its chunk, and read
//     only after its barrier's phase for that chunk has completed;
//   - the partial sums (one "slice" per product here, the sums complete)
//     are written at the end of a product, after a block barrier that
//     every thread reaches only after it has read the last product's sums:
//     the one before the gate product, and for proj's product (which
//     always streams at least one chunk) the barrier of its chunks.
//
// Past 2048 units, the layer is refused.
//
// The wrapper lays the weights out per slice ([2, C, P16, 4, US] and
// [2, C, H16, PS]: US a multiple of 8, PS of 16, the depths P16 and H16
// rounded up to 16, zero-padded; for the streamed plan each row of wh
// padded by 16 bytes, [2, C, P16, 4·US + 8]).  The kernel allocates nothing and
// launches on the caller's stream.  c_all and h_all (the per-step states a
// backward pass needs) are written only when non-null, in float32 or, with
// states_bf16, in bfloat16 (the store dtype of lstm_pallas.py:483-484).

#include "lstm_cluster.cuh"

namespace {

constexpr int kMaxRing = 6;  // steps of gx the ring holds, at most
constexpr int kMinRing = 3;  // gx(t) and keep(t+1) in, t+2 in flight
// the bf16 products' compile-time bounds (mma_product_t): 16-deep steps a
// slice and tiles a warp, for C blocks a cluster; at H = P = 320 (C = 8) the
// gate product runs 5 slices of 4 steps x 2 groups of 5 tiles, the
// projection 5 slices of 4 x 3 tiles; at H = 1024, P = 256 (C = 16) the
// gate product 2 slices of 8 steps x 8 groups of 2 tiles, the projection 16
// slices of 4 steps of its one tile
__host__ __device__ constexpr int gate_k(int C) { return C == kCluster ? 4 : 8; }
__host__ __device__ constexpr int gate_t(int C) { return C == kCluster ? 5 : 2; }
constexpr int kProjK = 4, kProjT = 1;


// K1's shared memory with C blocks a cluster, common to host and device.
// US, PS: units and projection columns a block; QS, HS: row strides of the
// full h and of the full cell output (C·PS, C·US, plus 16 bytes so that
// rows fall on other banks); arow: their rows (8 in bf16, whose products
// take the rows as mma's n; else R); LWA, LWD: row strides of the bf16
// weight slices (also padded by 16 bytes, but LWD not with 16 blocks).
// part holds the partial sums of the larger product,
// [slices][arow][ld], split as tsplit says in bf16 (ld = cols + 4, which
// puts the rows a lane stores on other banks) and as fma_split says in f32
// (ld = cols).  Then the three hand-off barriers (h in buffer 0, h in
// buffer 1, the cell output), the gx ring [depth][R][4][US] and the keep
// ring [depth][R].
struct FwdPlan {
  int us, ps, qs, hs, arow, lwa, lwd, ldg, ldp;
  TSplit tg, tp;  // bf16
  Split fg, fp;   // f32
  int gslices, pslices;
  size_t off_cell, off_part, off_w, off_bar, off_ring, off_keep, bytes;
};

template <typename T>
__host__ __device__ FwdPlan fwd_plan(int units, int out_dim, bool has_proj, int rows,
                                     int depth, int C) {
  FwdPlan p;
  p.us = round_up(cdiv(units, C), 8);
  p.ps = has_proj ? round_up(cdiv(out_dim, C), 16) : p.us;
  const int pad = 16 / (int)sizeof(T);
  p.hs = C * p.us + pad;
  p.qs = C * p.ps + pad;
  p.arow = kMma<T> ? 8 : rows;
  p.lwa = 4 * p.us + pad;
  p.lwd = p.ps + (C == kCluster ? pad : 0);
  const int g = 4 * p.us;
  p.ldg = kMma<T> ? g + 4 : g;
  p.ldp = kMma<T> ? p.ps + 4 : p.ps;
  p.tg = tsplit(g, out_dim, gate_k(C), gate_t(C));
  p.tp = has_proj ? tsplit(p.ps, units, kProjK, kProjT) : TSplit{1, 0, 0, 0};
  p.fg = fma_split(g, out_dim);
  p.fp = fma_split(p.ps, units);
  p.gslices = kMma<T> ? p.tg.slices : p.fg.slices;
  p.pslices = kMma<T> ? p.tp.slices : p.fp.slices;
  const size_t part_g = (size_t)p.gslices * p.arow * p.ldg;
  const size_t part_p = has_proj ? (size_t)p.pslices * p.arow * p.ldp : 0;
  p.off_cell = align128(sizeof(T) * (size_t)p.arow * p.qs);
  p.off_part = p.off_cell + align128(sizeof(T) * (size_t)p.arow * p.hs);
  p.off_w = p.off_part + align128(sizeof(float) * (part_g > part_p ? part_g : part_p));
  const size_t wbytes = !kMma<T> ? 0 : sizeof(T) *
      ((size_t)round_up(out_dim, 16) * p.lwa
       + (has_proj ? (size_t)round_up(units, 16) * p.lwd : 0));
  p.off_bar = p.off_w + align128(wbytes);
  p.off_ring = p.off_bar + 128;
  p.off_keep = p.off_ring + align128(sizeof(float) * (size_t)depth * rows * 4 * p.us);
  p.bytes = p.off_keep + align128(sizeof(float) * (size_t)depth * rows);
  return p;
}

template <typename T, int R, int C>
__global__ void __launch_bounds__(kThreads) lstm_fwd_kernel(
    const float* __restrict__ gx,      // [T, 2B, 4H], forward rows first
    const int* __restrict__ lengths,   // [B]
    const float* __restrict__ keep,    // [T, B] or null
    const T* __restrict__ wh_sl,       // [2, C, P16, 4, US]
    const T* __restrict__ proj_sl,     // [2, C, H16, PS] or null (P == H)
    const float* __restrict__ peep,    // [2, 3, H] or null
    float forget_bias, int steps, int batch, int units, int out_dim,
    float* __restrict__ out,           // [T, 2B, P]
    void* __restrict__ c_all,          // [T, 2B, H] or null
    void* __restrict__ h_all,          // [T, 2B, P] or null
    bool states_bf16,                  // c_all, h_all in bfloat16
    float* __restrict__ cfin,          // [2B, H]
    float* __restrict__ hfin,          // [2B, P]
    int depth) {                       // steps in the ring
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int dir = blockIdx.y;
  const int b0 = (blockIdx.x / C) * R;
  const int nr = min(R, batch - b0);
  const int H = units, P = out_dim;
  const bool has_proj = proj_sl != nullptr;
  const FwdPlan pl = fwd_plan<T>(H, P, has_proj, R, depth, C);
  const int US = pl.us, PS = pl.ps, G = 4 * US, arow = pl.arow;
  const int u0 = q * US, nu = max(0, min(US, H - u0));
  const int p0 = q * PS, np = max(0, min(PS, P - p0));
  const int tid = threadIdx.x;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  // h(t) lands in hq[0] with a projection; without one in hq[t & 1], the
  // second being the cell-output buffer, which is then unused (HS == QS)
  T* hq0 = reinterpret_cast<T*>(smem_raw);                   // [arow][QS]
  T* cellf = reinterpret_cast<T*>(smem_raw + pl.off_cell);   // [arow][HS]
  T* hq1 = has_proj ? hq0 : cellf;
  float* part = reinterpret_cast<float*>(smem_raw + pl.off_part);
  T* wres = reinterpret_cast<T*>(smem_raw + pl.off_w);       // bf16 slices
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + pl.off_bar);
  float* ring = reinterpret_cast<float*>(smem_raw + pl.off_ring);
  float* ring_keep = reinterpret_cast<float*>(smem_raw + pl.off_keep);

  const size_t slot_q = (size_t)dir * C + q;
  const size_t wh_elems = (size_t)round_up(P, 16) * G;
  const size_t pj_elems = has_proj ? (size_t)round_up(H, 16) * PS : 0;
  const T* wh_g = wh_sl + slot_q * wh_elems;
  const T* pj_g = has_proj ? proj_sl + slot_q * pj_elems : nullptr;
  T* wh_s = wres;  // the shared-memory copies (bf16 only)
  T* pj_s = wres + (size_t)round_up(P, 16) * pl.lwa;
  if constexpr (kMma<T>) {
    // wh's columns interleaved, unit-major (column 4·u + gate), so that the
    // four gates of a unit's partial sums lie side by side: one 16-byte
    // load a slice in the cell update
    for (int i = tid; i < round_up(P, 16) * G; i += kThreads) {
      const int k = i / G, c = i - k * G, gate = c / US, u = c - gate * US;
      wh_s[(size_t)k * pl.lwa + 4 * u + gate] = wh_g[i];
    }
    if (has_proj) copy_rows(pj_s, pl.lwd, pj_g, PS, round_up(H, 16));
  }
  const T zero = Dtype<T>::from_float(0.0f);
  for (int i = tid; i < arow * pl.qs; i += kThreads) hq0[i] = zero;
  for (int i = tid; i < arow * pl.hs; i += kThreads) cellf[i] = zero;

  // h(s) is handed off when a step s + 1 follows, the cell output at every
  // step; each barrier is armed for its first phase here
  const uint32_t bytes_c = C * nr * US * (uint32_t)sizeof(T);
  const uint32_t bytes_h = C * nr * PS * (uint32_t)sizeof(T);
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + i, 1);
    mbar_init_fence();
    if (steps > 1) mbar_expect(bar, bytes_h);                      // h(0)
    if (!has_proj && steps > 2) mbar_expect(bar + 1, bytes_h);     // h(1)
    if (has_proj && steps > 0) mbar_expect(bar + 2, bytes_c);      // cell(0)
  }

  // phase b: thread (rb, jb) owns one unit of one row; phase e: thread
  // (rh, jh) one projection column of one row; each keeps its carry (c, or
  // h) in a register
  const int rb = tid / US, jb = tid - rb * US;
  const bool in_b = tid < nr * US;
  const bool own_b = in_b && jb < nu;
  const int ub = u0 + jb;
  const int len_b = in_b ? lengths[b0 + rb] : 0;
  const int rh = tid / PS, jh = tid - rh * PS;
  const bool in_h = has_proj && tid < nr * PS;
  const bool own_h = in_h && jh < np;
  const int len_h = in_h ? lengths[b0 + rh] : 0;
  const float* pd = peep ? peep + (size_t)dir * 3 * H : nullptr;
  float pi = 0.0f, pf = 0.0f, po = 0.0f;
  if (pd && own_b) {
    pi = pd[ub];
    pf = pd[H + ub];
    po = pd[2 * H + ub];
  }
  float c_reg = 0.0f, h_reg = 0.0f;
  // the partial sums this thread adds: gate k of its unit in slice s at
  // pg[s·sg + 4·jb + k] in bf16 (the columns interleaved), at pg[s·sg +
  // k·US + jb] in f32; its projection column at ph[s·sp]
  const int sg = arow * pl.ldg, sp = arow * pl.ldp;
  const float* pg = part + rb * pl.ldg + (kMma<T> ? 4 * jb : jb);
  const float* ph = part + rh * pl.ldp + jh;

  // the ring: gx(s) of this block's rows and units as 16-byte chunks (4
  // gates x US / 4 a row), then keep(s) of its rows; the block's last
  // threads copy, at most two each, their offsets worked out once
  const int nchunk = nr * US, ncopy = nchunk + (keep ? nr : 0);
  const size_t row_elems = (size_t)2 * batch * 4 * H;  // gx a step
  const bool vec = H % 4 == 0;
  int cp_n = 0, cp_dst[2] = {0, 0}, cp_have[2] = {0, 0};
  long long cp_src[2] = {0, 0};  // gx elements past step 0, or keep's
  for (int i = kThreads - 1 - tid; i < ncopy; i += kThreads, ++cp_n) {
    if (i < nchunk) {
      const int r = i / US, e = i - r * US, k = e / (US / 4), c = 4 * (e - k * (US / 4));
      cp_dst[cp_n] = ((r * 4 + k) * US + c);
      cp_src[cp_n] = ((long long)dir * batch + b0 + r) * 4 * H + (long long)k * H + u0 + c;
      cp_have[cp_n] = max(0, min(4, H - u0 - c));  // of the chunk's units, those < H
    } else {
      cp_dst[cp_n] = -1 - (i - nchunk);  // keep of row i - nchunk
      cp_src[cp_n] = b0 + (i - nchunk);
    }
  }
  auto fetch = [&](int s, int slot) {
    if (s < steps) {
      for (int m = 0; m < cp_n; ++m) {
        if (cp_dst[m] >= 0) {
          float* dst = ring + (size_t)slot * R * 4 * US + cp_dst[m];
          const float* src = gx + (size_t)s * row_elems + cp_src[m];
          const int have = cp_have[m];
          if (vec) {
            cp_async16_fill(dst, have > 0 ? src : gx, 4 * have);
          } else {
            for (int e = 0; e < 4; ++e)
              cp_async4_fill(dst + e, e < have ? src + e : gx, e < have ? 4 : 0);
          }
        } else {
          cp_async4_fill(ring_keep + (size_t)slot * R - 1 - cp_dst[m],
                         keep + (size_t)s * batch + cp_src[m], 4);
        }
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s + 1 < depth; ++s) fetch(s, s);
  cluster.sync();  // every block is resident, its barriers initialised

  uint32_t parity = 0;  // bit i: the parity of barrier i's next phase
  int slot = 0;         // the ring's slot of step t
  for (int t = 0; t < steps; ++t) {
    const size_t row0 = (size_t)t * 2 * batch + (size_t)dir * batch + b0;
    const bool next = t + 1 < steps;
    const int slot1 = slot + 1 == depth ? 0 : slot + 1;   // step t+1's
    const int slot_prev = slot == 0 ? depth - 1 : slot - 1;  // step t-1's

    // a. h(t-1) (zero before the first step), then the gate sums
    const int hb = has_proj ? 0 : (t + 1) & 1;
    const T* hq = hb ? hq1 : hq0;
    if (t > 0) {
      mbar_wait(bar + hb, (parity >> hb) & 1);
      parity ^= 1u << hb;
      // the barrier's next phase: h(t) with a projection, h(t+1) without
      const int s_next = has_proj ? t : t + 1;
      if (tid == 0 && s_next + 1 < steps) mbar_expect(bar + hb, bytes_h);
    }
    if constexpr (kMma<T>)
      mma_product_t<gate_k(C), gate_t(C)>(hq, pl.qs, P, wh_s, pl.lwa, G, pl.tg, part, pl.ldg);
    else
      fma_product<R>(hq, pl.qs, P, wh_g, G, G, pl.fg, part);
    cp_async_wait_pending(depth - kMinRing);  // gx(t) and keep(t+1) are in
    __syncthreads();
    fetch(t + depth - 1, slot_prev);  // step t-1's slot: every thread is done with it

    // b. cell update of the owned units; hand off the cell output (or h)
    float share = 0.0f, cv = 0.0f, hv = 0.0f, ov = 0.0f;
    if (in_b) {
      const float kn = keep && next ? ring_keep[slot1 * R + rb] : 1.0f;
      if (own_b) {
        const float* gxs = ring + ((size_t)slot * R + rb) * 4 * US + jb;
        float gate[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) gate[k] = gxs[k * US];
        for (int s = 0; s < pl.gslices; ++s) {
          if constexpr (kMma<T>) {
            const float4 v = *reinterpret_cast<const float4*>(pg + s * sg);
            gate[0] += v.x;
            gate[1] += v.y;
            gate[2] += v.z;
            gate[3] += v.w;
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) gate[k] += pg[s * sg + k * US];
          }
        }
        const float cp = c_reg;
        if (pd) {
          gate[0] += pi * cp;
          gate[2] += pf * cp;
        }
        const float cn = sigmoidf(gate[2] + forget_bias) * cp
                         + sigmoidf(gate[0]) * tanhf(gate[1]);
        if (pd) gate[3] += po * cn;
        const float o = sigmoidf(gate[3]) * tanhf(cn);
        const float m = t < len_b ? 1.0f : 0.0f;
        cv = m * cn + (1.0f - m) * cp;
        c_reg = kn * cv;
        if (has_proj) {
          share = o;
        } else {
          hv = m * o + (1.0f - m) * h_reg;
          ov = m * o;
          h_reg = kn * hv;
          share = h_reg;
        }
      }
    }
    if (has_proj)
      send_slice<T, C>(share, in_b, cellf, rb * pl.hs + u0 + jb, bar + 2);
    else if (next)
      send_slice<T, C>(share, in_b, t & 1 ? hq1 : hq0, rb * pl.qs + u0 + jb, bar + (t & 1));
    if (own_b) {
      if (c_all) put_state(c_all, (row0 + rb) * H + ub, cv, states_bf16);
      if (!has_proj) {
        out[(row0 + rb) * P + ub] = ov;
        if (h_all) put_state(h_all, (row0 + rb) * P + ub, hv, states_bf16);
      }
    }
    slot = slot1;
    if (!has_proj) continue;

    // c. the full cell output; d. the owned projection columns
    mbar_wait(bar + 2, (parity >> 2) & 1);
    parity ^= 4u;
    if (tid == 0 && next) mbar_expect(bar + 2, bytes_c);
    if constexpr (kMma<T>)
      mma_product_t<kProjK, kProjT>(cellf, pl.hs, H, pj_s, pl.lwd, PS, pl.tp, part, pl.ldp);
    else
      fma_product<R>(cellf, pl.hs, H, pj_g, PS, PS, pl.fp, part);
    __syncthreads();

    // e. masking; hand off h(t)
    share = hv = ov = 0.0f;
    if (in_h) {
      const float kn = keep && next ? ring_keep[slot1 * R + rh] : 1.0f;
      if (own_h) {
        float o = 0.0f;
        for (int s = 0; s < pl.pslices; ++s) o += ph[s * sp];
        const float m = t < len_h ? 1.0f : 0.0f;
        hv = m * o + (1.0f - m) * h_reg;
        ov = m * o;
        h_reg = kn * hv;
        share = h_reg;
      }
    }
    if (next) send_slice<T, C>(share, in_h, hq0, rh * pl.qs + p0 + jh, bar);
    if (own_h) {
      out[(row0 + rh) * P + p0 + jh] = ov;
      if (h_all) put_state(h_all, (row0 + rh) * P + p0 + jh, hv, states_bf16);
    }
  }

  const size_t frow = (size_t)dir * batch + b0;
  if (own_b) cfin[(frow + rb) * H + ub] = c_reg;
  if (has_proj ? own_h : own_b)
    hfin[(frow + (has_proj ? rh : rb)) * P + (has_proj ? p0 + jh : ub)] = h_reg;
  cp_async_wait_pending(0);
  cluster.sync();  // every hand-off has landed before any block leaves
}

// K1's streamed plan with C blocks a cluster and R rows (bf16), common to
// host and device.  US, PS, QS, HS as FwdPlan's; arow: the rows of the full
// h, the cell output and the sums (8, or 16 past 8 rows: the products take
// them as one or two n8 tiles); LWS: the row stride of wh's rows in shared
// memory (4·US + 16 bytes); ldg, ldp: of the two products' sums; per_g,
// per_p: their k-slices in 16-deep steps (the resident plan's at C blocks,
// where it has a split); wsteps, psteps: the 16-deep steps of wh (P) and
// proj (H); res: wh's resident steps (at most `cap`, where cap >= 0); cw,
// cp: the steps a chunk of wh and of proj; nw, np: chunks a step; slots and
// slot: the ring.  gx and keep are read from L2 (no ring of them).
// res_bytes, stream_bytes: a block's weight bytes held, and streamed a
// step.
struct StreamPlan {
  int us, ps, qs, hs, arow, lws, ldg, ldp, per_g, per_p, wsteps, psteps, res, cw, cp, nw, np,
      slots;
  size_t slot, off_cell, off_part, off_bar, off_ring, off_res, bytes;
  long long res_bytes, stream_bytes;
};

template <int C>
__host__ __device__ StreamPlan stream_plan(int units, int out_dim, bool has_proj, int rows,
                                           int cap) {
  typedef __nv_bfloat16 T;
  StreamPlan p;
  p.us = round_up(cdiv(units, C), 8);
  p.ps = has_proj ? round_up(cdiv(out_dim, C), 16) : p.us;
  const int pad = 8, g = 4 * p.us;
  p.hs = C * p.us + pad;
  p.qs = C * p.ps + pad;
  p.arow = rows > 8 ? 16 : 8;
  p.lws = g + pad;
  p.ldg = g + 4;
  p.ldp = p.ps + 4;
  const TSplit tg = tsplit(g, out_dim, gate_k(C), gate_t(C));
  const TSplit tp = tsplit(p.ps, units, kProjK, kProjT);
  p.per_g = tg.per > 0 ? tg.per : gate_k(C);
  p.per_p = tp.per > 0 ? tp.per : kProjK;
  p.wsteps = cdiv(out_dim, 16);
  p.psteps = has_proj ? cdiv(units, 16) : 0;
  const size_t wrow = sizeof(T) * 16 * (size_t)p.lws, prow = sizeof(T) * 16 * (size_t)p.ps;
  p.cw = kChunkBytes / wrow > 1 ? (int)(kChunkBytes / wrow) : 1;
  p.cp = !has_proj ? 0 : kChunkBytes / prow > 1 ? (int)(kChunkBytes / prow) : 1;
  p.slot = align128(p.cw * wrow > p.cp * prow ? p.cw * wrow : p.cp * prow);
  p.off_cell = align128(sizeof(T) * p.arow * (size_t)p.qs);
  p.off_part = p.off_cell + align128(sizeof(T) * p.arow * (size_t)p.hs);
  p.off_bar = p.off_part +
              align128(sizeof(float) * p.arow * (size_t)(p.ldg > p.ldp ? p.ldg : p.ldp));
  p.off_ring = p.off_bar + 128;
  const size_t left = kMaxSmemPerBlock > p.off_ring ? kMaxSmemPerBlock - p.off_ring : 0;
  p.slots = left / p.slot < (size_t)kMaxSlots ? (int)(left / p.slot) : kMaxSlots;
  p.off_res = p.off_ring + p.slots * p.slot;
  const int fit = (int)((left - p.slots * p.slot) / wrow);
  p.res = fit < p.wsteps ? fit : p.wsteps;
  if (cap >= 0 && cap < p.res) p.res = cap;
  p.nw = cdiv(p.wsteps - p.res, p.cw);
  p.np = has_proj ? cdiv(p.psteps, p.cp) : 0;
  p.bytes = p.off_res + p.res * wrow;
  p.res_bytes = (long long)p.res * 16 * g * sizeof(T);
  p.stream_bytes = (long long)(p.wsteps - p.res) * 16 * g * sizeof(T) +
                   (long long)p.psteps * 16 * p.ps * sizeof(T);
  return p;
}

// Whether the streamed plan fits: at most kLayerUnits units a block, 16
// rows, cell_rows(R) rows a thread of the cell phase and of the masking
// phase, at least two ring slots (and with cap = kAllHeld, every step of wh
// resident).
template <int C>
bool stream_fits(int units, int out_dim, bool has_proj, int rows, int cap, StreamPlan* plan) {
  *plan = stream_plan<C>(units, out_dim, has_proj, rows, cap);
  return plan->us <= kLayerUnits && rows <= 16 &&
         thread_rows(rows, plan->us) <= cell_rows(rows) &&
         thread_rows(rows, plan->ps) <= cell_rows(rows) && plan->slots >= 2 &&
         plan->bytes <= kMaxSmemPerBlock && (cap != kAllHeld || plan->res == plan->wsteps);
}

// clock64 stamps of a step's phases (scripts/layer_stamps.py): where
// lstm_fwd_stamps has pointed this at a buffer of 1 + kStampPhases, thread 0
// of the first block of the first cluster adds each phase's cycles up in
// shared memory (beside the barriers) and writes the steps and the sums
// there at its end: a (the wait for h(t-1)), a (the gate product), b (the
// cell phase and its hand-off), c (the wait for the cell output), d (the
// projection's product), e (masking and the hand-off of h).  Null in
// every other launch.
__constant__ long long* c_fwd_stamps;

// K1 on the streamed plan (bf16): lstm_fwd_kernel's step with the products
// of streamed_product_t; wh_sl [2, C, P16, LWS] (each row of 4·US padded
// to LWS with zeros), proj_sl as lstm_fwd_kernel's; `cap` bounds wh's
// resident steps (-1: as many as fit).  A thread of the cell phase owns
// unit tid % US of rows tid / US, + 512 / US, .. (kRows at most), its
// carried c (and, without a projection, h) of each in registers; with a
// projection a thread of the masking phase likewise owns column tid % PS
// of rows tid / PS, + 512 / PS, .., its carried h of each in registers.
template <int R, int C>
__global__ void __launch_bounds__(kThreads) lstm_fwd_streamed_kernel(
    const float* __restrict__ gx, const int* __restrict__ lengths,
    const float* __restrict__ keep, const __nv_bfloat16* __restrict__ wh_sl,
    const __nv_bfloat16* __restrict__ proj_sl, const float* __restrict__ peep,
    float forget_bias, int steps, int batch, int units, int out_dim,
    float* __restrict__ out, void* __restrict__ c_all, void* __restrict__ h_all,
    bool states_bf16, float* __restrict__ cfin, float* __restrict__ hfin, int cap) {
  typedef __nv_bfloat16 T;
  constexpr int NT = R > 8 ? 2 : 1;    // the products' n8 tiles of rows
  constexpr int kRows = cell_rows(R);  // a thread's rows at most
  static_assert(R <= 16, "two n8 tiles of rows");
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int dir = blockIdx.y;
  const int b0 = (blockIdx.x / C) * R;
  const int nr = min(R, batch - b0);
  const int H = units, P = out_dim;
  const bool has_proj = proj_sl != nullptr;
  const StreamPlan pl = stream_plan<C>(H, P, has_proj, R, cap);
  const int US = pl.us, PS = pl.ps, G = 4 * US;
  const int u0 = q * US, nu = max(0, min(US, H - u0));
  const int p0 = q * PS, np = max(0, min(PS, P - p0));
  const int tid = threadIdx.x;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* hq0 = reinterpret_cast<T*>(smem_raw);                   // [arow][QS]
  T* cellf = reinterpret_cast<T*>(smem_raw + pl.off_cell);   // [arow][HS]
  T* hq1 = has_proj ? hq0 : cellf;
  float* part = reinterpret_cast<float*>(smem_raw + pl.off_part);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + pl.off_bar);
  T* wres = reinterpret_cast<T*>(smem_raw + pl.off_res);
  const Ring ring{smem_raw + pl.off_ring, bar + 3, pl.slots, pl.slot};

  // wh's rows arrive padded as they lie in shared memory ([2, C, P16,
  // LWS]: the streamed plan's layout), so that a chunk is one bulk copy
  const int P16 = 16 * pl.wsteps, H16 = round_up(H, 16);
  const size_t slot_q = (size_t)dir * C + q;
  const T* wh_g = wh_sl + slot_q * (size_t)P16 * pl.lws;
  const T* pj_g = has_proj ? proj_sl + slot_q * (size_t)H16 * PS : nullptr;
  copy_rows(wres, pl.lws, wh_g, pl.lws, 16 * pl.res);
  const T zero = Dtype<T>::from_float(0.0f);
  for (int i = tid; i < pl.arow * pl.qs; i += kThreads) hq0[i] = zero;
  for (int i = tid; i < pl.arow * pl.hs; i += kThreads) cellf[i] = zero;

  const uint32_t bytes_c = C * nr * US * (uint32_t)sizeof(T);
  const uint32_t bytes_h = C * nr * PS * (uint32_t)sizeof(T);
  if (tid == 0) {
    for (int i = 0; i < 3 + pl.slots; ++i) mbar_init(bar + i, 1);
    mbar_init_fence();
    if (steps > 1) mbar_expect(bar, bytes_h);
    if (!has_proj && steps > 2) mbar_expect(bar + 1, bytes_h);
    if (has_proj && steps > 0) mbar_expect(bar + 2, bytes_c);
  }

  // the cell phase: unit jb of rows rb0 + i·RS; the masking phase (with a
  // projection): column jh of rows rh0 + i·RSH; their rows' lengths and
  // carries in registers
  const int RS = kThreads / US, rb0 = tid / US, jb = tid - rb0 * US;
  const int RSH = kThreads / PS, rh0 = tid / PS, jh = tid - rh0 * PS;
  const bool own_u = jb < nu, own_p = jh < np;
  const int ub = u0 + jb;
  int len_b[kRows], len_h[kRows];
  float c_reg[kRows], h_reg[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int rb = rb0 + i * RS, rh = rh0 + i * RSH;
    len_b[i] = rb0 < RS && rb < nr ? lengths[b0 + rb] : 0;
    len_h[i] = has_proj && rh0 < RSH && rh < nr ? lengths[b0 + rh] : 0;
    c_reg[i] = h_reg[i] = 0.0f;
  }
  const float* pd = peep ? peep + (size_t)dir * 3 * H : nullptr;
  float pi = 0.0f, pf = 0.0f, po = 0.0f;
  if (pd && rb0 < RS && own_u) {
    pi = pd[ub];
    pf = pd[H + ub];
    po = pd[2 * H + ub];
  }
  const size_t row_elems = (size_t)2 * batch * 4 * H;
  const float* gx_dir = gx + ((size_t)dir * batch + b0) * 4 * H;

  // the weight chunks of a step: wh's streamed rows, then proj's (one
  // thread issues each)
  const int per_step = pl.nw + pl.np, total = steps * per_step;
  auto issue = [&](int n) {
    const int i = n % per_step;
    if (i < pl.nw) {
      const int r0 = 16 * (pl.res + i * pl.cw), rows = min(16 * pl.cw, P16 - r0);
      ring.issue(n, wh_g + (size_t)r0 * pl.lws, sizeof(T) * rows * pl.lws);
    } else {
      const int r0 = 16 * (i - pl.nw) * pl.cp, rows = min(16 * pl.cp, H16 - r0);
      ring.issue(n, pj_g + (size_t)r0 * PS, sizeof(T) * rows * PS);
    }
  };
  // the stamps (c_fwd_stamps), beside the barriers (3 + kMaxSlots of the
  // region's 128 bytes)
  long long* const stamps = c_fwd_stamps;
  const bool stamp = stamps != nullptr && tid == 0 && blockIdx.x == 0 && dir == 0;
  long long* const phase_sum = reinterpret_cast<long long*>(smem_raw + pl.off_bar + 64);
  long long clk = 0;
  auto mark = [&](int k) {
    if (stamp) {
      const long long now = clock64();
      phase_sum[k] += now - clk;
      clk = now;
    }
  };
  cluster.sync();  // every block is resident, its barriers initialised
  if (tid == 0)
    for (int n = 0; n < pl.slots && n < total; ++n) issue(n);
  int chunk = 0;  // the next chunk to read
  if (stamp) {
    for (int k = 0; k < kStampPhases; ++k) phase_sum[k] = 0;
    clk = clock64();
  }

  uint32_t parity = 0;
  for (int t = 0; t < steps; ++t) {
    const size_t row0 = (size_t)t * 2 * batch + (size_t)dir * batch + b0;
    const bool next = t + 1 < steps;
    // keep(t+1) of each of the thread's rows, loaded as the step starts
    float kn_b[kRows], kn_h[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int rb = rb0 + i * RS, rh = rh0 + i * RSH;
      kn_b[i] = keep && next && rb0 < RS && rb < nr ? keep[(size_t)(t + 1) * batch + b0 + rb]
                                                     : 1.0f;
      kn_h[i] = keep && next && has_proj && rh0 < RSH && rh < nr
                    ? keep[(size_t)(t + 1) * batch + b0 + rh]
                    : 1.0f;
    }

    // a. h(t-1), then the gate sums from gx(t) on (gx read from L2 into
    // the sums' init)
    const int hb = has_proj ? 0 : (t + 1) & 1;
    const T* hq = hb ? hq1 : hq0;
    if (t > 0) {
      mbar_wait(bar + hb, (parity >> hb) & 1);
      parity ^= 1u << hb;
      const int s_next = has_proj ? t : t + 1;
      if (tid == 0 && s_next + 1 < steps) mbar_expect(bar + hb, bytes_h);
    }
    __syncthreads();
    mark(0);
    const float* gxt = gx_dir + (size_t)t * row_elems;
    streamed_product_t<2, NT>(
        hq, pl.qs, P, G, pl.per_g, wres, pl.lws, pl.res, ring, pl.lws, pl.cw, chunk, total,
        issue,
        [&](int r, int c) {
          const int k = c / US, j = c - k * US;
          return r < nr && j < nu ? __ldg(gxt + (size_t)r * 4 * H + k * H + u0 + j) : 0.0f;
        },
        part, pl.ldg);
    __syncthreads();
    mark(1);

    // b. cell update of the owned units, a thread's rows in turn; hand off
    // the cell output (or h)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int rb = rb0 + i * RS;
      const bool in_b = rb0 < RS && rb < nr, own_b = in_b && own_u;
      float share = 0.0f, cv = 0.0f, hv = 0.0f, ov = 0.0f;
      if (own_b) {
        const float kn = kn_b[i];
        float gate[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) gate[k] = part[rb * pl.ldg + k * US + jb];
        const float cp = c_reg[i];
        if (pd) {
          gate[0] += pi * cp;
          gate[2] += pf * cp;
        }
        const float cn = sigmoidf(gate[2] + forget_bias) * cp
                         + sigmoidf(gate[0]) * tanhf(gate[1]);
        if (pd) gate[3] += po * cn;
        const float o = sigmoidf(gate[3]) * tanhf(cn);
        const float m = t < len_b[i] ? 1.0f : 0.0f;
        cv = m * cn + (1.0f - m) * cp;
        c_reg[i] = kn * cv;
        if (has_proj) {
          share = o;
        } else {
          hv = m * o + (1.0f - m) * h_reg[i];
          ov = m * o;
          h_reg[i] = kn * hv;
          share = h_reg[i];
        }
      }
      if (has_proj)
        send_slice<T, C>(share, in_b, cellf, rb * pl.hs + u0 + jb, bar + 2);
      else if (next)
        send_slice<T, C>(share, in_b, t & 1 ? hq1 : hq0, rb * pl.qs + u0 + jb, bar + (t & 1));
      if (own_b) {
        if (c_all) put_state(c_all, (row0 + rb) * H + ub, cv, states_bf16);
        if (!has_proj) {
          out[(row0 + rb) * P + ub] = ov;
          if (h_all) put_state(h_all, (row0 + rb) * P + ub, hv, states_bf16);
        }
      }
    }
    mark(2);
    if (!has_proj) continue;

    // c. the full cell output; d. the owned projection columns, all of
    // proj streamed
    mbar_wait(bar + 2, (parity >> 2) & 1);
    parity ^= 4u;
    if (tid == 0 && next) mbar_expect(bar + 2, bytes_c);
    mark(3);
    streamed_product_t<1, NT>(cellf, pl.hs, H, PS, pl.per_p, wres, pl.lws, 0, ring, PS, pl.cp,
                              chunk, total, issue, [](int, int) { return 0.0f; }, part, pl.ldp);
    __syncthreads();
    mark(4);

    // e. masking, a thread's rows in turn; hand off h(t)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int rh = rh0 + i * RSH;
      const bool in_h = rh0 < RSH && rh < nr, own_h = in_h && own_p;
      float share = 0.0f, hv = 0.0f, ov = 0.0f;
      if (own_h) {
        const float o = part[rh * pl.ldp + jh];
        const float m = t < len_h[i] ? 1.0f : 0.0f;
        hv = m * o + (1.0f - m) * h_reg[i];
        ov = m * o;
        h_reg[i] = kn_h[i] * hv;
        share = h_reg[i];
      }
      if (next) send_slice<T, C>(share, in_h, hq0, rh * pl.qs + p0 + jh, bar);
      if (own_h) {
        out[(row0 + rh) * P + p0 + jh] = ov;
        if (h_all) put_state(h_all, (row0 + rh) * P + p0 + jh, hv, states_bf16);
      }
    }
    mark(5);
  }
  if (stamp) {
    stamps[0] = steps;
    for (int k = 0; k < kStampPhases; ++k) stamps[1 + k] = phase_sum[k];
  }

  const size_t frow = (size_t)dir * batch + b0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int rb = rb0 + i * RS, rh = rh0 + i * RSH;
    if (rb0 < RS && rb < nr && own_u) {
      cfin[(frow + rb) * H + ub] = c_reg[i];
      if (!has_proj) hfin[(frow + rb) * P + ub] = h_reg[i];
    }
    if (has_proj && rh0 < RSH && rh < nr && own_p) hfin[(frow + rh) * P + p0 + jh] = h_reg[i];
  }
  cluster.sync();  // every hand-off has landed before any block leaves
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

// K1's plan with C blocks a cluster, R rows a cluster and the deepest gx
// ring that fits, and whether K1 has it at all: at most kLayerUnits units a
// block, R·US and R·PS threads at most, the bf16 products within
// mma_product_t's bounds, shared memory within a block's.  Host arithmetic
// only: the route asks it before any launch (R = 4 needs the least of each,
// so K1 takes a shape with C blocks when its R = 4 plan fits).
template <typename T>
bool fwd_fits(int units, int out_dim, bool has_proj, int rows, int C, FwdPlan* plan,
              int* depth) {
  int d = kMaxRing;
  while (d > kMinRing && fwd_plan<T>(units, out_dim, has_proj, rows, d, C).bytes > kMaxSmemPerBlock)
    --d;
  const FwdPlan pl = fwd_plan<T>(units, out_dim, has_proj, rows, d, C);
  *plan = pl;
  *depth = d;
  if (pl.us > kLayerUnits || rows * pl.us > kThreads || rows * pl.ps > kThreads) return false;
  if (kMma<T> && (pl.tg.per == 0 || (has_proj && pl.tp.per == 0)))
    return false;  // no split fits the products' bounds
  return pl.bytes <= kMaxSmemPerBlock;
}

// K1's plans, in the order they are tried: resident on 8 blocks, resident
// on 16, streamed on 16 (bf16 only)
enum Kind { kNone = 0, kResident = 1, kStreamed = 2 };

struct Route {
  Kind kind;
  int blocks;
};

// K1's plan for this shape: the first of the resident plans whose R = 4
// fits, else (bf16) the streamed plan where its R = 4 fits, else none
template <typename T>
Route fwd_route(int units, int out_dim, bool has_proj) {
  FwdPlan pl;
  int depth;
  const int sizes[2] = {kCluster, kWideCluster};
  for (int C : sizes)
    if (fwd_fits<T>(units, out_dim, has_proj, 4, C, &pl, &depth)) return Route{kResident, C};
  StreamPlan sp;
  if (kMma<T> && stream_fits<kWideCluster>(units, out_dim, has_proj, 4, -1, &sp))
    return Route{kStreamed, kWideCluster};
  return Route{kNone, 0};
}

// How K1 launches: C blocks a cluster, R batch rows a cluster, clusters,
// those resident at once (the occupancy API's answer), dynamic shared
// memory a block (rows = 0: not with this R); the streamed plan's weight
// bytes a block, held and streamed a step (a resident bf16 plan holds all
// its slices; float32 reads them from L2 at every step).
struct Launch {
  int blocks, rows, clusters, resident;
  size_t smem;
  long long held, streamed;
};

// Set up the launch with R rows per cluster if its plan fits.  Unless
// `force`, first ask the occupancy API whether all 2·ceil(B/R) clusters fit
// at once, and launch nothing (how->rows = 0) if they do not.  Launch
// unless `dry`.
template <typename T, int R, int C>
cudaError_t launch_rows(const Args& a, bool force, bool dry, Launch* how) {
  how->rows = 0;
  const bool has_proj = a.proj_sl != nullptr;
  FwdPlan pl;
  int depth;
  if (!fwd_fits<T>(a.units, a.out_dim, has_proj, R, C, &pl, &depth)) return cudaSuccess;
  auto kernel = lstm_fwd_kernel<T, R, C>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int fit;
  cudaError_t err = cluster_config(kernel, a.batch, R, C, pl.bytes, a.stream, &cfg, attr, &fit);
  if (err != cudaSuccess) return err;
  const int clusters = 2 * cdiv(a.batch, R);
  if (!force && fit < clusters) return cudaSuccess;
  const long long slices = !kMma<T> ? 0 : (long long)sizeof(T) *
      ((long long)round_up(a.out_dim, 16) * 4 * pl.us +
       (has_proj ? (long long)round_up(a.units, 16) * pl.ps : 0));
  const long long l2 = kMma<T> ? 0 : (long long)sizeof(T) *
      ((long long)a.out_dim * 4 * pl.us + (has_proj ? (long long)a.units * pl.ps : 0));
  *how = Launch{C, R, clusters, fit, pl.bytes, slices, l2};
  if (dry) return cudaSuccess;
  err = cudaLaunchKernelEx(
      &cfg, kernel, (const float*)a.gx, (const int*)a.lengths,
      (const float*)a.keep, (const T*)a.wh_sl, (const T*)a.proj_sl,
      (const float*)a.peep, a.forget_bias, a.steps, a.batch, a.units,
      a.out_dim, (float*)a.out, a.c_all, a.h_all, a.states_bf16,
      (float*)a.cfin, (float*)a.hfin, depth);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The smallest R of {4, 6} whose clusters are all resident at once; else
// the largest R whose plan fits, its clusters in waves.  A shape whose R = 4
// plan does not fit is refused.
template <typename T, int C>
cudaError_t choose(const Args& a, bool dry, Launch* how) {
  cudaError_t err = launch_rows<T, 4, C>(a, false, dry, how);
  if (err != cudaSuccess || how->rows) return err;
  err = launch_rows<T, 6, C>(a, false, dry, how);
  if (err != cudaSuccess || how->rows) return err;
  err = launch_rows<T, 8, C>(a, true, dry, how);
  if (err != cudaSuccess || how->rows) return err;
  err = launch_rows<T, 6, C>(a, true, dry, how);
  if (err != cudaSuccess || how->rows) return err;
  err = launch_rows<T, 4, C>(a, true, dry, how);
  if (err == cudaSuccess && !how->rows) return cudaErrorInvalidConfiguration;
  return err;
}

// The streamed plan with R rows a cluster, if it fits (wh's resident steps
// at most `cap`, -1: as many as fit); launched unless `dry`, whatever the
// clusters resident at once (at least one).
template <int R, int C>
cudaError_t launch_streamed(const Args& a, int cap, bool dry, Launch* how) {
  how->rows = 0;
  StreamPlan pl;
  if (!stream_fits<C>(a.units, a.out_dim, a.proj_sl != nullptr, R, cap, &pl))
    return cudaSuccess;
  auto kernel = lstm_fwd_streamed_kernel<R, C>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int fit;
  cudaError_t err = cluster_config(kernel, a.batch, R, C, pl.bytes, a.stream, &cfg, attr, &fit);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaSuccess;
  *how = Launch{C, R, 2 * cdiv(a.batch, R), fit, pl.bytes, pl.res_bytes, pl.stream_bytes};
  if (dry) return cudaSuccess;
  typedef __nv_bfloat16 T;
  err = cudaLaunchKernelEx(
      &cfg, kernel, (const float*)a.gx, (const int*)a.lengths, (const float*)a.keep,
      (const T*)a.wh_sl, (const T*)a.proj_sl, (const float*)a.peep, a.forget_bias, a.steps,
      a.batch, a.units, a.out_dim, (float*)a.out, a.c_all, a.h_all, a.states_bf16,
      (float*)a.cfin, (float*)a.hfin, cap);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int C>
cudaError_t streamed_at(const Args& a, int rows, int cap, bool dry, Launch* how) {
  switch (rows) {
    case 2: return launch_streamed<2, C>(a, cap, dry, how);
    case 4: return launch_streamed<4, C>(a, cap, dry, how);
    case 6: return launch_streamed<6, C>(a, cap, dry, how);
    case 8: return launch_streamed<8, C>(a, cap, dry, how);
    case 16:
      if constexpr (C == kWideCluster) return launch_streamed<16, C>(a, cap, dry, how);
      break;
    default:
      break;
  }
  how->rows = 0;
  return cudaSuccess;
}

// The streamed plan's R: of {2, 4, 6, 8, 16} (16 with 16 blocks) the one
// with the fewest waves, then the fewest clusters (every cluster streams
// the whole slices a step, whatever its rows), then the smallest
template <int C>
cudaError_t choose_streamed(const Args& a, bool dry, Launch* how) {
  Launch best{0, 0, 0, 0, 0, 0, 0}, c;
  for (int r : {2, 4, 6, 8, 16}) {
    const cudaError_t err = streamed_at<C>(a, r, -1, true, &c);
    if (err != cudaSuccess) return err;
    if (!c.rows) continue;
    const int waves = cdiv(c.clusters, c.resident), best_waves = cdiv(best.clusters,
                                                                      max(best.resident, 1));
    if (!best.rows || waves < best_waves || (waves == best_waves && c.clusters < best.clusters))
      best = c;
  }
  const cudaError_t err = streamed_at<C>(a, best.rows, -1, dry, how);
  if (err == cudaSuccess && !how->rows) return cudaErrorInvalidConfiguration;
  return err;
}

template <typename T>
int launch(int device, const Args& a, bool dry, Launch* how) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  *how = Launch{0, 0, 0, 0, 0, 0, 0};
  if (a.batch <= 0) return cudaSuccess;
  if (a.units <= 0 || a.out_dim <= 0 || (!a.proj_sl && a.out_dim != a.units))
    return cudaErrorInvalidValue;
  const Route route = fwd_route<T>(a.units, a.out_dim, a.proj_sl != nullptr);
  if (route.kind == kStreamed) {
    if constexpr (kMma<T>) return choose_streamed<kWideCluster>(a, dry, how);
  }
  switch (route.kind == kResident ? route.blocks : 0) {
    case kCluster:
      return choose<T, kCluster>(a, dry, how);
    case kWideCluster:
      return choose<T, kWideCluster>(a, dry, how);
    default:
      return cudaErrorInvalidConfiguration;
  }
}

// A bf16 launch on the plan that `plan` names, at R = `rows`, for holding
// the plans against each other (chip_smoke.py): 1, the resident plan of
// this shape; 2, the streamed plan with the resident plan's blocks a
// cluster (16 where it has none; those are the blocks lstm_fwd_fits
// answers, so the slices are laid out for them) and at most half of wh's
// steps resident, so that the ring streams wh too; 3, the same with every
// step of wh resident (refused where they do not all fit); 4, with as many
// resident as fit.
template <int C>
cudaError_t forced(const Args& a, int plan, int rows, Launch* how) {
  const bool has_proj = a.proj_sl != nullptr;
  StreamPlan sp;
  const int cap = plan == 2 ? cdiv(a.out_dim, 16) / 2 : plan == 3 ? kAllHeld : -1;
  if (plan > 4 || (plan >= 2 && !stream_fits<C>(a.units, a.out_dim, has_proj, rows, cap, &sp)))
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaErrorInvalidConfiguration;
  typedef __nv_bfloat16 T;
  if (plan >= 2) {
    err = streamed_at<C>(a, rows, cap, false, how);
  } else {
    switch (rows) {
      case 4: err = launch_rows<T, 4, C>(a, true, false, how); break;
      case 6: err = launch_rows<T, 6, C>(a, true, false, how); break;
      case 8: err = launch_rows<T, 8, C>(a, true, false, how); break;
      default: break;
    }
  }
  if (err == cudaSuccess && !how->rows) return cudaErrorInvalidConfiguration;
  return err;
}

}  // namespace

// Point the streamed kernel's stamps at `stamps` (null: none)
extern "C" int lstm_fwd_stamps(void* stamps) {
  return cudaMemcpyToSymbol(c_fwd_stamps, &stamps, sizeof(stamps));
}

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
  Launch how;
  return launch<float>(device, LSTM_FWD_PACK, false, &how);
}

extern "C" int lstm_fwd_bf16(LSTM_FWD_ARGS) {
  Launch how;
  return launch<__nv_bfloat16>(device, LSTM_FWD_PACK, false, &how);
}

// The blocks a cluster of K1's launch plan for this shape (8 or 16;
// negative for the streamed plan, whose wh rows are laid out padded), or 0
// when K1 has none: host arithmetic only, no CUDA call (the plans at R = 4)
extern "C" int lstm_fwd_fits(int units, int out_dim, int has_proj, int bf16) {
  if (units <= 0 || out_dim <= 0) return 0;
  const Route r = bf16 ? fwd_route<__nv_bfloat16>(units, out_dim, has_proj != 0)
                       : fwd_route<float>(units, out_dim, has_proj != 0);
  return r.kind == kStreamed ? -r.blocks : r.blocks;
}

// lstm_fwd_bf16 on a forced plan and R (`plan` 1 resident, 2-4 streamed
// with half, all or as much of wh resident as fits; see `forced`): the slices laid out for lstm_fwd_fits's blocks, and for the
// plan
extern "C" int lstm_fwd_bf16_forced(LSTM_FWD_ARGS, int plan, int rows) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Launch how;
  const Args a = LSTM_FWD_PACK;
  const Route route = fwd_route<__nv_bfloat16>(units, out_dim, proj_sl != nullptr);
  if (plan == 1 && route.kind != kResident) return cudaErrorInvalidConfiguration;
  switch (route.blocks) {
    case kCluster:
      return forced<kCluster>(a, plan, rows, &how);
    case kWideCluster:
      return forced<kWideCluster>(a, plan, rows, &how);
    default:
      return cudaErrorInvalidConfiguration;
  }
}

// How K1 would launch on `device` at this shape: blocks a cluster, rows a
// cluster, clusters, clusters resident at once, dynamic shared memory a
// block, whether the plan is the streamed one, and the weight bytes a
// block holds and streams a step; a CUDA error if it cannot.  With `at`
// > 0 and a streamed plan, the launch at R = `at` (a forced launch's).
extern "C" int lstm_fwd_config(int device, int batch, int units, int out_dim,
                               int has_proj, int bf16, int* blocks, int* rows,
                               int* clusters, int* resident, long long* smem,
                               int* streamed, long long* held, long long* streams,
                               int at) {
  Args a = {};
  a.batch = batch;
  a.units = units;
  a.out_dim = out_dim;
  a.proj_sl = has_proj ? (const void*)1 : nullptr;
  Launch how = {0, 0, 0, 0, 0, 0, 0};
  const bool stream =
      bf16 && fwd_route<__nv_bfloat16>(units, out_dim, has_proj != 0).kind == kStreamed;
  int err;
  if (stream && at > 0) {
    err = cudaSetDevice(device);
    if (err == cudaSuccess) err = streamed_at<kWideCluster>(a, at, -1, true, &how);
    if (err == cudaSuccess && !how.rows) err = cudaErrorInvalidConfiguration;
  } else {
    err = bf16 ? launch<__nv_bfloat16>(device, a, true, &how)
               : launch<float>(device, a, true, &how);
  }
  *blocks = how.blocks;
  *rows = how.rows;
  *clusters = how.clusters;
  *resident = how.resident;
  *smem = (long long)how.smem;
  *streamed = stream;
  *held = how.held;
  *streams = how.streamed;
  return err;
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
