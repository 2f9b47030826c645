"""The layout of the bf16 product engine (``csrc/wg_product.cuh``) and of the
products that run on it, on the CPU: K3's input side (``csrc/
lstm_bwd_fold.cu``: dx = dg·wxᵀ, dwx = xᵀ·dg, dbias) and K7's dw and db
(``csrc/moe_bwd_wgrad.cu``, with the db partials of ``csrc/moe_bwd.cu``).

The engine's block reads, for each 64-deep chunk, four TMA boxes of 64 rows
of 64 elements into one stage (A for warpgroups 0 and 1, then B's two
64-column halves), each written with the 128-byte swizzle (element c of box
row r at r·64 + 8·((c // 8) ^ (r % 8)) + c % 8; rows past a tensor's end
zero), and its wgmma descriptors read the stage as

  * K-major (K3's dx): operand (row i, depth 16 s + k) at byte
    (i // 8)·1024 + (i % 8)·128 + 32 s + 2 k;
  * MN-major (K3's dwx, K7's dw): operand (depth 16 s + k, column c) at
    byte 2048 s + (c // 64)·8192 + (k // 8)·1024 + (k % 8)·128 + 2 (c % 64),

both swizzled (bits 4-6 of the byte offset xor bits 7-9).  The tests
emulate the ops' box coordinates on the tensors seen as the launchers'
tensor maps, build each stage's image, read the operands back through the
descriptors' formulas (bit-exact against the operands the row maps name:
dg's row t·2B + g·B + b, x's and dx's row (g·B + b)·T + t, both directions,
ragged T), add the products of each chunk, scatter the accumulators through
the fragment positions and the ops' epilogues, add the split-K partials in
split order, and hold the results to ``cells.fold_input_side`` and
``moe_kernels.moe_wgrad_reference`` in float32 (rtol = atol = 1e-5; dg
and x at the tenth of a unit that dgates and activations have, so that two
orders of a float32 sum stay inside atol).  K7's
db is emulated in the kernel's order: within a warp the three lane
exchanges of ``unit_column_sum`` (bit-exact against the tree sum they
claim), then the warps in order, then the 64-row tiles in the order of
``group_sum_kernel`` (as is K3's dbias over its 64-row groups).
"""

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.models import cells
from lstm_ctc_tpu_torch.ops import moe_kernels as mk

TOL = dict(rtol=1e-5, atol=1e-5)
TILE = 128
TAU = 10.0


def cdiv(a, b):
    return -(-a // b)


# --- the copy engine and the descriptors ---

def tma_box(view, box1, box3, c):
    """The box at coordinates c (innermost first) of a tensor map whose
    dims, outermost first, are ``view``'s: box (64, box1, 1, box3) as its
    64 rows of 64 elements, zero outside the tensor."""
    out = torch.zeros(box3, box1, 64, dtype=view.dtype)
    c0, c1, c2, c3 = c
    d3, d2, d1, d0 = view.shape
    if 0 <= c2 < d2:
        a3, b3 = max(c3, 0), min(c3 + box3, d3)
        a1, b1 = max(c1, 0), min(c1 + box1, d1)
        a0, b0 = max(c0, 0), min(c0 + 64, d0)
        if a3 < b3 and a1 < b1 and a0 < b0:
            out[a3 - c3:b3 - c3, a1 - c1:b1 - c1, a0 - c0:b0 - c0] = \
                view[a3:b3, c2, a1:b1, a0:b0]
    return out.reshape(64, 64)


def swizzled(box):
    """A box's image in shared memory (elements), as the copy engine writes
    it with CU_TENSOR_MAP_SWIZZLE_128B."""
    r = torch.arange(64)[:, None]
    col = torch.arange(64)[None, :]
    at = r * 64 + ((col // 8) ^ (r % 8)) * 8 + col % 8
    image = torch.zeros(4096, dtype=box.dtype)
    image[at.reshape(-1)] = box.reshape(-1)
    return image


def element(byte):
    """The element at a byte offset of a 1024-aligned stage, swizzled."""
    return (byte ^ (((byte >> 7) & 7) << 4)) // 2


def k_major(rows, step, base):
    """Element index of K-major operand (row i, depth 16·step + k)."""
    i = torch.arange(rows)[:, None]
    k = torch.arange(16)[None, :]
    return element(base + (i // 8) * 1024 + (i % 8) * 128 + 32 * step + 2 * k)


def mn_major(cols, step, base):
    """Element index of MN-major operand (depth 16·step + k, column c):
    64-wide column blocks 8192 bytes apart (the descriptor's leading
    offset), 8-deep row groups 1024 apart (its stride offset)."""
    k = torch.arange(16)[:, None]
    c = torch.arange(cols)[None, :]
    return element(base + 2048 * step + (c // 64) * 8192 + (k // 8) * 1024
                   + (k % 8) * 128 + 2 * (c % 64))


def fragments():
    """(row, col) of register i of consumer thread t of a warpgroup (m64n128
    accumulator): rows 16 (t / 32) + (t % 32) / 4 and + 8, columns
    8 j + 2 (t % 4) and + 1."""
    t = torch.arange(128)[:, None]
    i = torch.arange(64)[None, :]
    j, h, e = i // 4, (i % 4) // 2, i % 2
    row = 16 * (t // 32) + (t % 32) // 4 + 8 * h
    col = 8 * j + 2 * (t % 4) + e
    return row, col


def run_engine(op, map_a, map_b, tiles, splits):
    """Every block of the launch: the ring's stages as images, the
    operands read back through the descriptors (checked against the
    boxes), the products chunk by chunk, and the epilogue from the
    registers at their fragment positions."""
    row, col = fragments()
    for tile in range(tiles):
        for split in range(splits):
            k0, k1 = op.range(tile, split)
            acc = [torch.zeros(64, TILE, dtype=torch.float64)
                   for _ in range(2)]
            for k in range(k0, k1):
                boxes = [tma_box(*map_a, c=op.a_box(tile, h, k))
                         for h in range(2)]
                boxes += [tma_box(*map_b, c=op.b_box(tile, h, k))
                          for h in range(2)]
                op.check_boxes(tile, k, boxes)
                stage = torch.cat([swizzled(b) for b in boxes])
                for wg in range(2):
                    for s in range(4):
                        if op.trans:
                            a = stage[mn_major(64, s, 8192 * wg)].T
                            b = stage[mn_major(TILE, s, 16384)]
                            want_a = boxes[wg][16 * s:16 * s + 16].T
                            want_b = torch.cat(boxes[2:], 1)[16 * s:16 * s + 16]
                        else:
                            a = stage[k_major(64, s, 8192 * wg)]
                            b = stage[k_major(TILE, s, 16384)].T
                            want_a = boxes[wg][:, 16 * s:16 * s + 16]
                            want_b = torch.cat(boxes[2:], 0)[:, 16 * s:
                                                            16 * s + 16].T
                        assert torch.equal(a, want_a)
                        assert torch.equal(b, want_b)
                        acc[wg] += a.double() @ b.double()
            for wg in range(2):
                op.store(tile, split, wg, row, col, acc[wg][row, col])


# --- K3's input side ---

class DxOp:
    """lstm_bwd_fold.cu DxOp: K-major; warpgroup wg of row tile tm takes
    segment s = 2 tm + wg of direction g, b = s // segs, t = 64 (s % segs)
    .. + 63; dg seen as (4H, B, 2, T), wx as (4H, D, 2, 1)."""
    trans = 0

    def __init__(self, dg, wx, x2):
        self.steps, self.b2, self.h4 = dg.shape
        self.batch, self.d = self.b2 // 2, wx.shape[1]
        self.dg_rows = dg.reshape(-1, self.h4)
        self.wx = wx
        self.segs = cdiv(self.steps, 64)
        self.tiles_m = cdiv(self.batch * self.segs, 2)
        self.tiles_n = cdiv(self.d, TILE)
        self.tiles = 2 * self.tiles_m * self.tiles_n
        self.chunks = cdiv(self.h4, 64)
        self.out = torch.full(x2.shape, float("nan"), dtype=torch.float64)
        self.written = torch.zeros(x2.shape, dtype=torch.int32)

    def where(self, tile, wg):
        tn = tile % self.tiles_n
        r = tile // self.tiles_n
        s = 2 * (r % self.tiles_m) + wg
        return r // self.tiles_m, s // self.segs, 64 * (s % self.segs), tn

    def range(self, tile, split):
        return 0, self.chunks

    def a_box(self, tile, wg, k):
        g, b, t0, _ = self.where(tile, wg)
        return (64 * k, b, g, t0) if b < self.batch else \
            (64 * k, 0, g, self.steps)

    def b_box(self, tile, j, k):
        tn, g = tile % self.tiles_n, tile // self.tiles_n // self.tiles_m
        return (64 * k, TILE * tn + 64 * j, g, 0)

    def check_boxes(self, tile, k, boxes):
        """A's rows are dg's rows t·2B + g·B + b (direction g, batch row
        b, 64 consecutive t), B's rows wx[g]'s rows of the tile."""
        for wg in range(2):
            g, b, t0, tn = self.where(tile, wg)
            for r in range(64):
                t = t0 + r
                want = torch.zeros(64)
                if b < self.batch and t < self.steps:
                    src = self.dg_rows[t * self.b2 + g * self.batch + b]
                    part = src[64 * k:64 * k + 64]
                    want[:part.shape[0]] = part
                assert torch.equal(boxes[wg][r], want)
        g = tile // self.tiles_n // self.tiles_m
        n0 = TILE * (tile % self.tiles_n)
        for j in range(2):
            want = torch.zeros(64, 64)
            part = self.wx[g, n0 + 64 * j:n0 + 64 * j + 64,
                           64 * k:64 * k + 64]
            want[:part.shape[0], :part.shape[1]] = part
            assert torch.equal(boxes[2 + j], want)

    def store(self, tile, split, wg, row, col, values):
        g, b, t0, tn = self.where(tile, wg)
        if b >= self.batch:
            return
        t, c = t0 + row, TILE * tn + col
        keep = (t < self.steps) & (c < self.d)
        self.out[g, b, t[keep], c[keep]] = values[keep]
        self.written[g, b, t[keep], c[keep]] += 1


class DwxOp:
    """lstm_bwd_fold.cu DwxOp: MN-major; chunk k of the depth is t =
    64 (k % segs) .. + 63 of batch row b = k // segs; x(bf16) seen as
    (D, T, 2B, 1), dg as (4H, B, 2, T); split s writes partial s."""
    trans = 1

    def __init__(self, dg, x2, splits):
        self.steps, self.b2, self.h4 = dg.shape
        self.batch, self.d = self.b2 // 2, x2.shape[-1]
        self.dg_rows, self.x_rows = dg.reshape(-1, self.h4), \
            x2.reshape(-1, self.d)
        self.segs = cdiv(self.steps, 64)
        self.tiles_m, self.tiles_n = cdiv(self.d, TILE), cdiv(self.h4, TILE)
        self.tiles = 2 * self.tiles_m * self.tiles_n
        self.chunks, self.splits = self.batch * self.segs, splits
        self.part = torch.full((splits, 2, self.d, self.h4), float("nan"),
                               dtype=torch.float64)

    def decode(self, tile):
        tn = tile % self.tiles_n
        r = tile // self.tiles_n
        return r // self.tiles_m, r % self.tiles_m, tn

    def range(self, tile, split):
        per = cdiv(self.chunks, self.splits)
        return split * per, min(self.chunks, split * per + per)

    def a_box(self, tile, wg, k):
        g, tm, _ = self.decode(tile)
        b = k // self.segs
        return (TILE * tm + 64 * wg, 64 * (k % self.segs),
                g * self.batch + b, 0)

    def b_box(self, tile, j, k):
        g, _, tn = self.decode(tile)
        b = k // self.segs
        return (TILE * tn + 64 * j, b, g, 64 * (k % self.segs))

    def check_boxes(self, tile, k, boxes):
        """Row r of every box is depth t = t0 + r of batch row b: x's row
        (g·B + b)·T + t, dg's row t·2B + g·B + b."""
        g, tm, tn = self.decode(tile)
        b, t0 = k // self.segs, 64 * (k % self.segs)
        for r in range(64):
            t = t0 + r
            for h in range(2):
                want_a, want_b = torch.zeros(64), torch.zeros(64)
                if t < self.steps:
                    m0, n0 = TILE * tm + 64 * h, TILE * tn + 64 * h
                    xa = self.x_rows[(g * self.batch + b) * self.steps + t,
                                     m0:m0 + 64]
                    want_a[:xa.shape[0]] = xa
                    db = self.dg_rows[t * self.b2 + g * self.batch + b,
                                      n0:n0 + 64]
                    want_b[:db.shape[0]] = db
                assert torch.equal(boxes[h][r], want_a)
                assert torch.equal(boxes[2 + h][r], want_b)

    def store(self, tile, split, wg, row, col, values):
        g, tm, tn = self.decode(tile)
        m, n = TILE * tm + 64 * wg + row, TILE * tn + col
        keep = (m < self.d) & (n < self.h4)
        self.part[split, g, m[keep], n[keep]] = values[keep]


def fold_case(seed, batch, steps, dim, units):
    rng = np.random.RandomState(seed)
    x2 = torch.from_numpy(rng.randn(2, batch, steps, dim).astype(np.float32))
    wx = torch.from_numpy((0.1 * rng.randn(2, dim, 4 * units)).astype(
        np.float32))
    dg = torch.from_numpy((0.1 * rng.randn(steps, 2 * batch, 4 * units))
                          .astype(np.float32))
    return x2, wx, dg


FOLD_SHAPES = [(3, 70, 72, 40), (5, 40, 120, 16), (2, 130, 136, 24)]


def test_fragment_positions_cover_the_tile_once():
    row, col = fragments()
    seen = torch.zeros(64, TILE, dtype=torch.int32)
    seen.index_put_((row.reshape(-1), col.reshape(-1)),
                    torch.ones(row.numel(), dtype=torch.int32),
                    accumulate=True)
    assert bool((seen == 1).all())


@pytest.mark.parametrize("batch,steps,dim,units", FOLD_SHAPES)
def test_k3_dx_through_the_engine(batch, steps, dim, units):
    x2, wx, dg = fold_case(1, batch, steps, dim, units)
    op = DxOp(dg, wx, x2)
    run_engine(op, (dg.view(steps, 2, batch, 4 * units), 1, 64),
               (wx.view(1, 2, dim, 4 * units), 64, 1), op.tiles, 1)
    assert bool((op.written == 1).all())     # every dx element, once
    want = cells.fold_input_side(x2, wx, dg)[0]
    torch.testing.assert_close(op.out.float(), want, **TOL)


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("batch,steps,dim,units", FOLD_SHAPES)
def test_k3_dwx_split_partials_in_order(batch, steps, dim, units, splits):
    x2, wx, dg = fold_case(2, batch, steps, dim, units)
    op = DwxOp(dg, x2, splits)
    covered = sorted(k for s in range(splits) for k in range(*op.range(0, s)))
    assert covered == list(range(op.chunks))   # each chunk in one split
    run_engine(op, (x2.view(1, 2 * batch, steps, dim), 64, 1),
               (dg.view(steps, 2, batch, 4 * units), 1, 64), op.tiles,
               splits)
    assert not bool(op.part.isnan().any())
    dwx = op.part[0].float()
    for s in range(1, splits):                 # split_sum_kernel's order
        dwx = dwx + op.part[s].float()
    torch.testing.assert_close(dwx, cells.fold_input_side(x2, wx, dg)[1],
                               **TOL)


@pytest.mark.parametrize("batch,steps,dim,units", FOLD_SHAPES)
def test_k3_dbias_side_sum_order(batch, steps, dim, units):
    """dg_column_sums: per direction and column, the rows r = t·B + b in
    groups of 64, each summed in r order; then the groups in group_sum's
    order."""
    x2, wx, dg = fold_case(3, batch, steps, dim, units)
    h4 = 4 * units
    rows = dg.view(steps, 2, batch, h4).permute(1, 0, 2, 3).reshape(
        2, steps * batch, h4).numpy()
    parts = []
    for q in range(cdiv(steps * batch, 64)):
        part = np.zeros((2, h4), np.float32)
        for r in range(64 * q, min(64 * q + 64, steps * batch)):
            part += rows[:, r]
        parts.append(part)
    got = group_sum(np.stack(parts))
    torch.testing.assert_close(torch.from_numpy(got),
                               cells.fold_input_side(x2, wx, dg)[2], **TOL)


def group_sum(parts):
    """wg_product.cuh group_sum_kernel over [groups, ...] float32 partials:
    eight runs of ceil(groups / 8) consecutive groups, each summed in order,
    then the eight sums in order."""
    per = cdiv(parts.shape[0], 8)
    total = np.zeros(parts.shape[1:], np.float32)
    for w in range(8):
        run = np.zeros(parts.shape[1:], np.float32)
        for q in range(w * per, min(parts.shape[0], (w + 1) * per)):
            run = run + parts[q]
        total = total + run
    return total


def test_group_sum_order_covers_every_group_once():
    """Each group lands in exactly one warp's run, for group counts below,
    at and above eight runs, and the order is the one stated (bit-exact
    against the runs added by hand)."""
    for groups in (1, 5, 8, 9, 192, 224):
        per = cdiv(groups, 8)
        runs = [list(range(w * per, min(groups, (w + 1) * per)))
                for w in range(8)]
        assert sorted(q for run in runs for q in run) == list(range(groups))
        parts = np.random.RandomState(groups).randn(groups, 3).astype(
            np.float32)
        want = np.zeros(3, np.float32)
        for run in runs:
            acc = np.zeros(3, np.float32)
            for q in run:
                acc = acc + parts[q]
            want = want + acc
        assert group_sum(parts).tobytes() == want.tobytes()


# --- K7: dw on the engine, db from K6's body ---

class DwOp:
    """moe_bwd_wgrad.cu DwOp: MN-major; chunk k is rows 64 k .. 64 k + 63;
    x(bf16) seen as (D, N, 1, 1), dz as (E·V, N, 1, 1)."""
    trans = 1

    def __init__(self, x, dz, splits):
        self.n, self.d = x.shape
        self.kk = dz.shape[1]
        self.x, self.dz = x, dz
        self.tiles_n = cdiv(self.kk, TILE)
        self.tiles = cdiv(self.d, TILE) * self.tiles_n
        self.chunks, self.splits = cdiv(self.n, 64), splits
        self.part = torch.full((splits, self.d, self.kk), float("nan"),
                               dtype=torch.float64)

    def range(self, tile, split):
        per = cdiv(self.chunks, self.splits)
        return split * per, min(self.chunks, split * per + per)

    def a_box(self, tile, wg, k):
        return (TILE * (tile // self.tiles_n) + 64 * wg, 64 * k, 0, 0)

    def b_box(self, tile, j, k):
        return (TILE * (tile % self.tiles_n) + 64 * j, 64 * k, 0, 0)

    def check_boxes(self, tile, k, boxes):
        for h in range(2):
            for box, src, c0 in (
                    (boxes[h], self.x,
                     TILE * (tile // self.tiles_n) + 64 * h),
                    (boxes[2 + h], self.dz,
                     TILE * (tile % self.tiles_n) + 64 * h)):
                want = torch.zeros(64, 64)
                part = src[64 * k:64 * k + 64, c0:c0 + 64]
                want[:part.shape[0], :part.shape[1]] = part
                assert torch.equal(box, want)

    def store(self, tile, split, wg, row, col, values):
        m = TILE * (tile // self.tiles_n) + 64 * wg + row
        c = TILE * (tile % self.tiles_n) + col
        keep = (m < self.d) & (c < self.kk)
        self.part[split, m[keep], c[keep]] = values[keep]


def moe_case(seed, n, d, e, v, keep_prob):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((0.1 * rng.randn(n, d)).astype(np.float32))
    th = torch.from_numpy(np.tanh(rng.randn(n, e * v)).astype(np.float32))
    logits = rng.randn(n, e).astype(np.float32)
    gate = torch.softmax(torch.from_numpy(logits), -1)
    gout = torch.from_numpy(rng.randn(n, v).astype(np.float32))
    seed_t = torch.tensor([-424242], dtype=torch.int32)
    return x, th, gate, gout, (seed_t, e, TAU, keep_prob)


MOE_SHAPES = [(150, 40, 5, 7), (200, 136, 4, 72), (65, 8, 1, 128)]


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("n,d,e,v", MOE_SHAPES)
def test_k7_dw_through_the_engine(n, d, e, v, splits):
    x, th, gate, gout, args = moe_case(4, n, d, e, v, 0.9)
    dz = mk._dz(th, gate, gout, *args)[0].reshape(n, -1)
    op = DwOp(x, dz, splits)
    run_engine(op, (x.view(1, 1, n, d), 64, 1),
               (dz.view(1, 1, n, e * v), 64, 1), op.tiles, splits)
    assert not bool(op.part.isnan().any())
    dw = op.part[0].float()
    for s in range(1, splits):
        dw = dw + op.part[s].float()
    torch.testing.assert_close(dw, mk.moe_wgrad_reference(x, th, gate, gout,
                                                          *args)[0], **TOL)


def lane_exchange(v):
    """unit_column_sum (csrc/moe_bwd.cu) on 32 lanes' 8 values each
    (float32 numpy [32, 8]): three exchanges with lanes l ^ 4, l ^ 8,
    l ^ 16, each keeping half of the columns."""
    lanes = np.arange(32)
    h1, h2, h3 = (lanes & 4) > 0, (lanes & 8) > 0, (lanes & 16) > 0
    s4 = np.zeros((32, 4), np.float32)
    for i in range(4):
        keep = np.where(h1, v[:, 4 + i], v[:, i])
        send = np.where(h1, v[:, i], v[:, 4 + i])
        s4[:, i] = keep + send[lanes ^ 4]
    s2 = np.zeros((32, 2), np.float32)
    for i in range(2):
        keep = np.where(h2, s4[:, 2 + i], s4[:, i])
        send = np.where(h2, s4[:, i], s4[:, 2 + i])
        s2[:, i] = keep + send[lanes ^ 8]
    keep = np.where(h3, s2[:, 1], s2[:, 0])
    send = np.where(h3, s2[:, 0], s2[:, 1])
    return keep + send[lanes ^ 16]


def tree8(rows):
    """((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)) in float32."""
    return ((rows[0] + rows[1]) + (rows[2] + rows[3])) + \
        ((rows[4] + rows[5]) + (rows[6] + rows[7]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k7_db_lane_exchange_is_the_tree_sum(seed):
    """Lane l = 4 row + part holds unit columns 0-7 of its row; after the
    exchanges it holds column 4 ((l >> 2) & 1) + 2 ((l >> 3) & 1) +
    ((l >> 4) & 1) of its part, summed over the warp's 8 rows as a tree,
    bit for bit."""
    v = np.random.RandomState(seed).randn(32, 8).astype(np.float32) * \
        np.float32(1e3) ** np.random.RandomState(seed + 9).randint(
            -2, 3, (32, 8)).astype(np.float32)
    got = lane_exchange(v)
    for lane in range(32):
        part = lane & 3
        col = 4 * ((lane >> 2) & 1) + 2 * ((lane >> 3) & 1) + ((lane >> 4) & 1)
        rows = [v[4 * r + part, col] for r in range(8)]
        assert got[lane].tobytes() == np.float32(tree8(rows)).tobytes()


@pytest.mark.parametrize("keep_prob", [1.0, 0.9])
@pytest.mark.parametrize("n,d,e,v", MOE_SHAPES)
def test_k7_db_partials_in_tile_order(n, d, e, v, keep_prob):
    """db = the tiles' partials in group_sum's order, a 64-row tile's
    partial the sum over its 8 warps in order of the tree sums of their 8
    rows, of the unrounded dz; rows past N are zero."""
    x, th, gate, gout, args = moe_case(5, n, d, e, v, keep_prob)
    dz = mk._dz(th, gate, gout, *args)[0].reshape(n, -1).numpy()
    tiles = cdiv(n, 64)
    padded = np.zeros((64 * tiles, dz.shape[1]), np.float32)
    padded[:n] = dz
    parts = []
    for t in range(tiles):
        part = np.zeros(dz.shape[1], np.float32)
        for w in range(8):
            part = part + tree8(padded[64 * t + 8 * w:64 * t + 8 * w + 8])
        parts.append(part)
    db = group_sum(np.stack(parts))
    torch.testing.assert_close(torch.from_numpy(db),
                               mk.moe_wgrad_reference(x, th, gate, gout,
                                                      *args)[1], **TOL)
