"""The data layout of the MoE head's bf16 kernels, on the CPU.

K4/K5 (``csrc/moe_fwd.cu``) and K6/K8 (``csrc/moe_bwd.cu``) read W as a
packed image of ready shared-memory operand tiles (``fwd_pack``,
``bwd_pack``).  Unpacked with the kernels' own swizzle formula (the 16-byte
unit j of row r at unit j ^ (r % 8), ``csrc/wgmma.cuh`` ``sw128_offset``),
the image must give W back exactly, with zeros in the padding.

Then plain emulations of the kernels' data paths, fed from those images, are
held to the plain versions in float32 (rtol = atol = 1e-5): K4's and K5's
products in 64-deep chunks per expert, the epilogue at the accumulator's
fragment positions (m64nNP: thread t of a warpgroup holds rows 16 (t / 32) +
(t % 32) / 4 and + 8, columns 8j + 2 (t % 4) and + 1) into one mix per
warpgroup (G warpgroups, ``fwd_groups``: warpgroup g takes experts g, G + g,
...), summed in warpgroup order at the end; K6's dz in 64-deep
chunks across expert boundaries with the gate factor per element, dx from
the packed Wᵀ tiles, and dgate summed in the kernel's order (each thread's
16 elements in k order, one sum per expert segment; the four threads of a
row joined in lane order; the open expert carried to the next chunk).
"""

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.models import moe
from lstm_ctc_tpu_torch.ops import moe_kernels as mk

TAU = 10.0
SEED = -424242
SHAPES = [(5, 7, 40), (6, 16, 200), (72, 72, 640), (1, 128, 48)]


def unswizzle(image):
    """The logical [.., rows, 64] tiles of a swizzled image: element k of
    row r sits at r·64 + 8·((k // 8) ^ (r % 8)) + k % 8 (numpy)."""
    *lead, rows, cols = image.shape
    flat = image.reshape(-1, rows * cols)
    r = np.arange(rows)[:, None]
    k = np.arange(cols)[None, :]
    at = r * 64 + 8 * ((k // 8) ^ (r % 8)) + k % 8
    return flat[:, at].reshape(image.shape)


def fwd_groups(width):
    """K4/K5's consumer warpgroups for the padded expert width
    (csrc/moe_fwd.cu ``fwd_groups``)."""
    return 3 if width <= 72 else 2


def weights(e, v, d, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return moe.init_moe(gen, d, v, e)["w_expert"]


@pytest.mark.parametrize("e,v,d", SHAPES)
def test_fwd_pack_unpacks_to_w(e, v, d):
    w = weights(e, v, d)
    image = mk.fwd_pack(w.to(torch.bfloat16), e)
    width, chunks = mk.fwd_pack_width(v), -(-d // 64)
    assert image.shape == (e, chunks * width, 64)  # one V-tile
    assert image.dtype == torch.bfloat16 and image.is_contiguous()
    tiles = unswizzle(image.float().numpy()).reshape(e, chunks, width, 64)
    wt = tiles.transpose(0, 2, 1, 3).reshape(e, width, chunks * 64)
    ref = w.to(torch.bfloat16).float().numpy().reshape(d, e, v)
    np.testing.assert_array_equal(wt[:, :v, :d], ref.transpose(1, 2, 0))
    assert not wt[:, v:, :].any() and not wt[:, :, d:].any()


@pytest.mark.parametrize("e,v,d", SHAPES)
def test_bwd_pack_unpacks_to_w(e, v, d):
    w = weights(e, v, d)
    image = mk.bwd_pack(w.to(torch.bfloat16), e)
    rows = 4 * mk.bwd_pack_width(d)
    slices, chunks = -(-d // rows), -(-(e * v) // 64)
    assert image.shape == (slices, chunks, rows, 64)
    assert image.dtype == torch.bfloat16 and image.is_contiguous()
    tiles = unswizzle(image.float().numpy())       # [slices, chunks, rows, 64]
    full = tiles.transpose(0, 2, 1, 3).reshape(slices * rows, chunks * 64)
    np.testing.assert_array_equal(full[:d, :e * v],
                                  w.to(torch.bfloat16).float().numpy())
    assert not full[d:, :].any() and not full[:, e * v:].any()


def test_swizzle_is_its_own_inverse():
    t = torch.arange(3 * 16 * 64, dtype=torch.float32).reshape(3, 16, 64)
    assert torch.equal(mk.swizzle128(mk.swizzle128(t)), t)
    np.testing.assert_array_equal(unswizzle(mk.swizzle128(t).numpy()),
                                  t.numpy())


def fragment_map(width):
    """(rows, cols) [128, width / 2] of the m64n<width> accumulator's
    registers, thread by thread (csrc/wgmma.cuh)."""
    t = np.arange(128)[:, None]
    reg = np.arange(width // 2)[None, :]
    rows = 16 * (t // 32) + (t % 32) // 4 + 8 * ((reg // 2) % 2)
    cols = 8 * (reg // 4) + 2 * (t % 4) + reg % 2
    return rows, cols


@pytest.mark.parametrize("width", mk.FWD_PACK_WIDTHS + (160,))
def test_fragment_map_covers_the_tile_once(width):
    rows, cols = fragment_map(width)
    seen = np.zeros((64, width), np.int64)
    np.add.at(seen, (rows, cols), 1)
    assert (seen == 1).all()


def fwd_case(e, v, d, n=70, seed=4):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((0.5 * rng.randn(n, d)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.randn(e * v)).astype(np.float32))
    logits = torch.from_numpy(rng.randn(n, e).astype(np.float32))
    return x, weights(e, v, d, seed), b, torch.softmax(logits, -1)


def emulate_fwd(x, w, b, gate, e, tau, keep_prob, seed):
    """K4/K5 from fwd_pack's image: (out [N, V], th [N, E·V]) in float32."""
    n, d = x.shape
    v = w.shape[1] // e
    width, chunks = mk.fwd_pack_width(v), -(-d // 64)
    tiles = torch.from_numpy(unswizzle(mk.fwd_pack(w, e).numpy())).reshape(
        e, chunks, width, 64)
    tiles_n = -(-n // 64)
    xp = torch.zeros(tiles_n * 64, chunks * 64)
    xp[:n, :d] = x
    rows, cols = fragment_map(width)
    rows_t, cols_t = torch.from_numpy(rows), torch.from_numpy(cols)
    valid = cols_t < v
    out = torch.zeros(tiles_n * 64, v)
    th = torch.zeros(tiles_n * 64, e * v)
    keep_all = torch.ones(tiles_n * 64, e * v)
    if keep_prob < 1.0:
        keep_all = (mk.hash_uniform(seed, 0, 0, tiles_n * 64, e * v)
                    < keep_prob).float() / keep_prob
    gate_p = torch.zeros(tiles_n * 64, e)
    gate_p[:n] = gate
    for tile in range(tiles_n):
        r0 = tile * 64
        groups = fwd_groups(width)
        mix = torch.zeros(groups, 128, width // 2)  # one per warpgroup
        for ex in range(e):
            z = torch.zeros(64, width)
            for c in range(chunks):                 # 64-deep chunks
                z += xp[r0:r0 + 64, 64 * c:64 * c + 64] @ tiles[ex, c].T
            col = ex * v + cols_t.clamp(max=v - 1)
            t = torch.tanh(z[rows_t, cols_t] + b[col])
            a = tau * t * keep_all[r0 + rows_t, col]
            g = gate_p[r0 + rows_t, ex]
            mix[ex % groups] += torch.where(valid, g * a, torch.zeros(()))
            th[r0 + rows_t[valid], col[valid]] = t[valid]
        total = mix[0]
        for h in range(1, groups):                  # in warpgroup order
            total = total + mix[h]
        out[r0 + rows_t[valid], cols_t[valid]] = total[valid]
    return out[:n], th[:n]


@pytest.mark.parametrize("keep_prob", [1.0, 0.9])
@pytest.mark.parametrize("e,v,d", SHAPES)
def test_k4_emulation_matches_reference(e, v, d, keep_prob):
    x, w, b, gate = fwd_case(e, v, d)
    got, _ = emulate_fwd(x, w, b, gate, e, TAU, keep_prob, SEED)
    ref = mk.moe_mix_reference(x, w, b, gate, e, TAU, keep_prob, SEED)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("keep_prob", [1.0, 0.9])
@pytest.mark.parametrize("e,v,d", SHAPES)
def test_k5_emulation_matches_reference(e, v, d, keep_prob):
    x, w, b, gate = fwd_case(e, v, d)
    seed = torch.tensor([SEED], dtype=torch.int32)
    got, th = emulate_fwd(x, w, b, gate, e, TAU, keep_prob, SEED)
    ref, ref_th = mk.moe_stash_reference(x, w, b, gate, seed, e, TAU,
                                         keep_prob)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(th.numpy(), ref_th.numpy(), rtol=1e-5,
                               atol=1e-5)


def emulate_bwd(th, w, gate, gout, e, tau, keep_prob, seed):
    """K6 from bwd_pack's image: (dx [N, D], dgate [N, E], dz [N, E·V]),
    float32, dgate in the kernel's order of sums (numpy over rows)."""
    n, kk = th.shape
    d = w.shape[0]
    v = kk // e
    chunks = -(-kk // 64)
    tiles = torch.from_numpy(unswizzle(mk.bwd_pack(w, e).numpy()))
    slices, _, rows, _ = tiles.shape
    wt = tiles.permute(0, 2, 1, 3).reshape(slices * rows, chunks * 64)
    thn, gn, qn = th.numpy(), gate.numpy(), gout.numpy()
    keep = np.ones((n, kk), np.float32)
    if keep_prob < 1.0:
        keep = ((mk.hash_uniform(seed, 0, 0, n, kk) < keep_prob).float()
                / keep_prob).numpy()
    dz = np.zeros((n, chunks * 64), np.float32)
    dgate = np.full((n, e), np.nan, np.float32)
    run_e = np.full(n, -1)
    run = np.zeros(n, np.float32)
    rr = np.arange(n)
    for c in range(chunks):
        lanes = []
        for part in range(4):
            kb = 64 * c + 16 * part
            cur = np.full(n, min(kb // v, e))
            first_e = np.full(n, e)
            seg = np.zeros(n, np.float32)
            first = np.zeros(n, np.float32)
            single = np.ones(n, bool)
            for k in range(kb, min(kb + 16, kk)):
                t = thn[:, k]
                q = qn[:, k % v]
                g = gn[:, k // v]
                a = np.float32(tau) * t * keep[:, k]
                dz[:, k] = g * q * (np.float32(tau) * (1 - t * t)) * keep[:, k]
                seg = seg + q * a
                if (k + 1) % v == 0:                 # expert k // v ends
                    dgate[~single, cur[~single]] = seg[~single]
                    first_e[single] = cur[single]
                    first[single] = seg[single]
                    single[:] = False
                    seg = np.zeros(n, np.float32)
                    cur = cur + 1
            fe = np.where(single, cur, first_e)
            fs = np.where(single, seg, first)
            lanes.append((fe, fs, cur, seg, single))
        for fe, fs, le, ls, single in lanes:         # lane order
            same = fe == run_e
            run = np.where(same, run + fs, run)
            out = ~same & (run_e >= 0) & (run_e < e)
            dgate[rr[out], run_e[out]] = run[out]
            run_e = np.where(same, run_e, fe)
            run = np.where(same, run, fs)
            closed = ~single & (run_e < e)
            dgate[rr[closed], run_e[closed]] = run[closed]
            run_e = np.where(single, run_e, le)
            run = np.where(single, run, ls)
    last = (run_e >= 0) & (run_e < e)
    dgate[rr[last], run_e[last]] = run[last]
    dx = torch.from_numpy(dz) @ wt[:d].T            # depth-64 chunks of K
    return dx, torch.from_numpy(dgate), torch.from_numpy(dz[:, :kk])


@pytest.mark.parametrize("keep_prob", [1.0, 0.9])
@pytest.mark.parametrize("e,v,d", SHAPES)
def test_k6_emulation_matches_reference(e, v, d, keep_prob):
    x, w, b, gate = fwd_case(e, v, d, n=21)
    seed = torch.tensor([SEED], dtype=torch.int32)
    _, th = mk.moe_stash_reference(x, w, b, gate, seed, e, TAU, keep_prob)
    gout = torch.from_numpy(np.random.RandomState(9).randn(21, v)
                            .astype(np.float32))
    dx, dgate, dz = emulate_bwd(th, w, gate, gout, e, TAU, keep_prob, SEED)
    assert not torch.isnan(dgate).any()           # every (row, expert) once
    ref_dx, ref_dgate, ref_dz = mk.moe_backward_reference(
        th, w, gate, gout, seed, e, TAU, keep_prob)
    for got, ref in ((dx, ref_dx), (dgate, ref_dgate), (dz, ref_dz)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)
