"""The MoE head past 128 targets an expert: K4, K5 and K6 for every V the
reference's fused kernels take (lcm(V, 128) <= 4096, ``fused_eligible``).

On the CPU: the port's mix and its four gradients (dx, dw, db, dgate), under
a random cotangent, against ``jax.grad`` through the JAX package's fused
Pallas mix in interpret mode at V = 136 and 256, keep 1.0 and 0.9 with the
same seed, both held to a float64 witness of the same function (float32;
the port within rtol = atol = 1e-5 of the witness element by element, and
within rtol = atol = 1e-5 of JAX's values widened by one float32 rounding
of each element's sum, u·Σ|terms|: JAX's own float32 sums of dw and dgate
lie up to 0.32 u·Σ|terms| past rtol = atol = 1e-5 of the witness at
V = 256, keep 0.9); the port's head against the JAX
package's at V = 256 (rtol = atol = 1e-4); ``fwd_pack``'s image read back
through K4/K5's own addressing (csrc/moe_fwd.cu ``launch_bf16``: a launch
for the V-tiles of 128 and one for the rest, an expert's image
``expert_bytes`` apart, tile t's chunk c at (t · chunks + c) · NP rows, the
128-byte swizzle), bit-exact; and K6's gout places past V = 128
(``fetch_gout``: a thread's 16 columns of a chunk, gout[n, k mod V], in
quads of four 16-byte copies, or sixteen of 4 bytes where V is not a
multiple of 4) read back as dz_chunk reads them.

The ``cuda`` tests hold K4, K5 and K6 against their plain versions on the
card at V = 136, 200, 256, 1024 and 4096, at ragged row counts, an odd D, the
flagship's D and a D past 1024 (bf16), keep 0.9 and 1.0, with the bounds of
``tests/test_torch_moe_backward.py``, and two launches bit-equal; they skip
without a GPU.  JAX is imported by a fixture, so the ``cuda`` tests also run
where JAX is not installed.
"""

import types
import warnings

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.models import moe
from lstm_ctc_tpu_torch.ops import moe_kernels as mk
from lstm_ctc_tpu_torch.train.checkpoint import params_from_numpy

TAU = 10.0
SEED = -424242
WIDE_V = (136, 200, 256, 1024, 4096)


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from lstm_ctc_tpu.models import moe as jmoe
    from lstm_ctc_tpu.ops import moe_pallas
    return types.SimpleNamespace(jax=jax, jnp=jnp, moe=jmoe,
                                 pallas=moe_pallas)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_case(seed, n=40, d=24, e=3, v=136):
    """x, w_expert, b_expert, gate (softmaxed) and a cotangent gout, as
    float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    w = moe.init_moe(gen, d, v, e)["w_expert"].numpy()
    x = rng.randn(n, d).astype(np.float32)
    b = (0.1 * rng.randn(e * v)).astype(np.float32)
    logits = rng.randn(n, e).astype(np.float32)
    gate = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    gout = rng.randn(n, v).astype(np.float32)
    return x, w, b, gate.astype(np.float32), gout


# --- the CPU: the port's wide head against the JAX package ---

def float64_witness(case, e, v, keep_prob):
    """The mix and its four gradients under the cotangent, in float64 on
    the float32 inputs and the kernels' dropout factors, each beside the
    float64 magnitude of the last sum that makes each element (the sum of
    its terms' |values|): {name: (value, magnitude)}."""
    x, w, b, gate, gout = (torch.from_numpy(a).double() for a in case)
    n = x.shape[0]
    drop = mk._drop_factor(torch.tensor([SEED], dtype=torch.int32), n,
                           e * v, keep_prob, x.device).double() \
        if keep_prob < 1.0 else torch.ones(n, e * v, dtype=torch.float64)
    t = torch.tanh(x @ w + b)
    a = (TAU * t * drop).view(n, e, v)
    dz = (gate[:, :, None] * gout[:, None, :]).reshape(n, e * v) \
        * TAU * (1.0 - t * t) * drop
    return {
        "out": (torch.einsum("ne,nev->nv", gate, a),
                torch.einsum("ne,nev->nv", gate, a.abs())),
        "dx": (dz @ w.t(), dz.abs() @ w.t().abs()),
        "dw": (x.t() @ dz, x.t().abs() @ dz.abs()),
        "db": (dz.sum(0), dz.abs().sum(0)),
        "dgate": (torch.einsum("nv,nev->ne", gout, a),
                  torch.einsum("nv,nev->ne", gout.abs(), a.abs()))}


@pytest.mark.parametrize("keep_prob", [1.0, 0.9])
@pytest.mark.parametrize("v", [136, 256])
def test_wide_mix_and_gradients_match_jax_fused_interpret(jref, v, keep_prob):
    e = 3
    case = make_case(v, e=e, v=v)
    jnp = jref.jnp
    assert mk.mix_eligible(24, v, torch.float32)
    assert jref.pallas.fused_eligible(24, v)

    def loss(x, w, b, gate):
        out = jref.pallas.moe_mix_fused(
            x, w, b, gate, e, TAU, keep_prob=keep_prob, seed=jnp.int32(SEED),
            compute_dtype=jnp.float32, n_block=8, interpret=True)
        return jnp.sum(out * jnp.asarray(case[4])), out

    (_, ref_out), ref = jref.jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(a) for a in case[:4]))
    leaves = [torch.from_numpy(a).requires_grad_() for a in case[:4]]
    seed = torch.tensor([SEED], dtype=torch.int32)
    out = mk.moe_mix_fused(*leaves, e, TAU, keep_prob, seed, torch.float32)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(case[4]))
    witness = float64_witness(case, e, v, keep_prob)
    for name, g, r in zip(("out", "dx", "dw", "db", "dgate"),
                          (out.detach(),) + got, (ref_out,) + ref):
        g, r = g.double().numpy(), np.asarray(r, np.float64)
        exact, terms = (t.numpy() for t in witness[name])
        np.testing.assert_allclose(g, exact, rtol=1e-5, atol=1e-5,
                                   err_msg=name + " against float64")
        # one float32 rounding of the element's sum (u = 2^-24) past
        # rtol = atol = 1e-5: where JAX's float32 sum lies past the witness
        bound = 1e-5 + 1e-5 * np.abs(r) + 2.0 ** -24 * terms
        assert (np.abs(g - r) <= bound).all(), (
            name, float((np.abs(g - r) - bound).max()))


def test_wide_head_matches_jax(jref):
    e, v, d, n = 3, 256, 16, 30
    jparams = jref.moe.init_moe(jref.jax.random.PRNGKey(7), d, v, e)
    x = np.random.RandomState(7).randn(n, d).astype(np.float32)
    ref = jref.moe.apply_moe(jparams, jref.jnp.asarray(x), e, 10.0)
    params = params_from_numpy(jref.jax.tree.map(np.asarray, jparams))
    got = moe.apply_moe(params, torch.from_numpy(x), e, 10.0)
    assert got.shape == (n, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


# --- the CPU: the kernels' data layout past 128 targets ---

def unswizzle_rows(flat, row0, rows):
    """Rows row0 .. row0 + rows of a swizzled [.., 64] bf16 image (numpy,
    flat): element k of row r at r·64 + 8·((k // 8) ^ (r % 8)) + k % 8."""
    r = np.arange(rows)[:, None]
    k = np.arange(64)[None, :]
    return flat[(row0 + r) * 64 + 8 * ((k // 8) ^ (r % 8)) + k % 8]


def read_fwd_image(image, e, v, d):
    """W ``[D, E·V]`` read back from fwd_pack's image through K4/K5's own
    addressing (csrc/moe_fwd.cu launch_bf16 and moe_fwd_wgmma), with every
    padded element of the tiles, as float32 numpy: (w, padding)."""
    flat = image.float().numpy().reshape(-1)
    chunks = -(-d // 64)
    full = v // 128 if v > 128 else 0
    rest = v - 128 * full
    rest_np = mk.fwd_pack_width(rest) if rest else 0
    expert_rows = chunks * (128 * full + rest_np)   # expert_bytes / 128
    launches = []
    if full:
        launches.append((0, 0, 128, full))                 # base, v0, NP, tiles
    if rest:
        launches.append((chunks * 128 * full, 128 * full, rest_np, 1))
    assert flat.size == e * expert_rows * 64
    w = np.full((chunks * 64, e * v), np.nan, np.float32)
    pads = []
    for base, v0, np_, tiles in launches:
        for ex in range(e):
            for t in range(tiles):                         # blockIdx.y
                col_base = v0 + np_ * t
                vt = min(np_, v - col_base)
                for c in range(chunks):
                    row0 = base + ex * expert_rows + (t * chunks + c) * np_
                    tile = unswizzle_rows(flat, row0, np_)  # [NP rows v][64 d]
                    cols = slice(ex * v + col_base, ex * v + col_base + vt)
                    w[64 * c:64 * c + 64, cols] = tile[:vt].T
                    pads.append(tile[vt:])
    return w, w[d:], pads


@pytest.mark.parametrize("e,v,d", [(3, 136, 40), (2, 200, 100),
                                   (3, 256, 37), (2, 4096, 20),
                                   (3, 72, 70), (2, 128, 64)])
def test_fwd_pack_wide_read_back_through_the_kernels_addressing(e, v, d):
    gen = torch.Generator().manual_seed(v)
    w = moe.init_moe(gen, d, v, e)["w_expert"].to(torch.bfloat16)
    image = mk.fwd_pack(w, e)
    tiles = mk.fwd_tiles(v)
    assert image.dtype == torch.bfloat16 and image.is_contiguous()
    assert image.shape == (e, -(-d // 64) * sum(t[2] for t in tiles), 64)
    got, past_d, pads = read_fwd_image(image, e, v, d)
    np.testing.assert_array_equal(got[:d], w.float().numpy())
    assert not past_d.any()
    assert all(not p.any() for p in pads)


@pytest.mark.parametrize("v,tiles", [
    (72, [(0, 72, 72)]), (128, [(0, 128, 128)]),
    (136, [(0, 128, 128), (128, 8, 16)]),
    (200, [(0, 128, 128), (128, 72, 72)]),
    (256, [(0, 128, 128), (128, 128, 128)]),
    (4096, [(128 * t, 128, 128) for t in range(32)])])
def test_fwd_tiles(v, tiles):
    assert mk.fwd_tiles(v) == tiles


def fetched_gout(gout, v, kk, chunk, vec4):
    """K6's gout slot of one chunk as fetch_gout fills it, then each
    thread's 16 values as dz_chunk reads them (quads 2u and 2u + 1 of unit
    u): ``[rows, 64]``, NaN where nothing was copied."""
    rows = gout.shape[0]
    got = np.full((rows, 64), np.nan, np.float32)
    for row in range(rows):
        for part in range(4):
            kb = 64 * chunk + 16 * part
            if kb >= kk:
                continue
            slot = np.full((4, 4), np.nan, np.float32)      # [quad][4]
            col = kb % v
            if vec4:
                for j in range(4):
                    if kb + 4 * j < kk:
                        slot[j] = gout[row, col:col + 4]
                    col += 4
                    if col == v:
                        col = 0
            else:
                for i in range(16):
                    if kb + i < kk:
                        slot[i >> 2, i & 3] = gout[row, col]
                    col += 1
                    if col == v:
                        col = 0
            for u in range(2):
                q8 = np.concatenate([slot[2 * u], slot[2 * u + 1]])
                got[row, 16 * part + 8 * u:16 * part + 8 * u + 8] = q8
    return got


@pytest.mark.parametrize("e,v", [(3, 7), (5, 6), (3, 136), (2, 200),
                                 (2, 4096), (4, 72)])
def test_k6_gout_places_give_gout_k_mod_v(e, v):
    rng = np.random.RandomState(v)
    gout = rng.randn(5, v).astype(np.float32)
    kk = e * v
    for vec4 in ((True, False) if v % 4 == 0 else (False,)):
        for chunk in range(-(-kk // 64)):
            got = fetched_gout(gout, v, kk, chunk, vec4)
            k = np.arange(64 * chunk, min(64 * chunk + 64, kk))
            np.testing.assert_array_equal(got[:, :k.size], gout[:, k % v])


def test_gate_takes_every_target_count_the_reference_takes(jref):
    for v in range(1, 4200):
        if jref.pallas.fused_eligible(640, v):
            assert mk.mix_eligible(640, v, torch.bfloat16)
            assert mk.mix_eligible(1024, v, torch.float32)
            assert mk.mix_eligible(4096, v, torch.bfloat16)


# --- the card: K4, K5 and K6 against their plain versions ---

def bf16_step(t):
    """One bf16 rounding step at each element of t (float32 view)."""
    return 2.0 ** -7 * t.float().abs() + 1e-6


def ratio(got, ref):
    return float((got.float() - ref.float()).abs().max()) / max(
        float(ref.float().abs().max()), 1e-30)


def held_to_plain(x, w, b, gate, gout, e, keep_prob, seed):
    """K4, K5 and K6 on CUDA tensors against their plain versions, each
    launched twice (bit-equal), at the bounds of
    tests/test_torch_moe_backward.py: float32 ratio <= 1e-4; bf16 out
    within 5e-2, th and dz within one rounding step (plus 2^-20 of the sum
    of |x·w|'s terms for th), dx and dgate ratio <= 1e-2."""
    f32 = w.dtype == torch.float32
    wrappers = (mk.moe_mix_forward, mk.moe_mix_forward_stash,
                mk.moe_mix_backward)
    before = [f.launches for f in wrappers]
    args = (seed, e, TAU, keep_prob)
    out4 = [mk.moe_mix_forward(x, w, b, gate, e, TAU, keep_prob, seed,
                               w.dtype) for _ in range(2)]
    out5 = [mk.moe_mix_forward_stash(x, w, b, gate, *args) for _ in range(2)]
    ref_out, ref_th = mk.moe_stash_reference(x, w, b, gate, *args)
    th = out5[0][1]
    bwd = [mk.moe_mix_backward(th, w, gate, gout, *args) for _ in range(2)]
    ref = mk.moe_backward_reference(th, w, gate, gout, *args)
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [n + 2 for n in before]
    assert torch.equal(out4[0], out4[1])
    assert all(torch.equal(a, b) for a, b in zip(out5[0], out5[1]))
    assert all(torch.equal(a, b) for a, b in zip(bwd[0], bwd[1]))
    out, dx, dgate, dz = out5[0][0], bwd[0][0], bwd[0][1], bwd[0][2]
    assert out.shape == out4[0].shape == ref_out.shape
    assert th.dtype == dz.dtype == w.dtype
    for t in (out4[0], out, th, dx, dgate, dz):
        assert bool(torch.isfinite(t.float()).all())
    if f32:
        assert ratio(out4[0], ref_out) <= 1e-4 and ratio(out, ref_out) <= 1e-4
        assert ratio(th, ref_th) <= 1e-4
        assert ratio(dx, ref[0]) <= 1e-4 and ratio(dgate, ref[1]) <= 1e-4
        assert ratio(dz, ref[2]) <= 1e-4
        return
    assert float((out4[0] - ref_out).abs().max()) <= 5e-2
    assert float((out - ref_out).abs().max()) <= 5e-2
    terms = x.to(torch.bfloat16).float().abs() @ w.float().abs()
    assert bool(((th.float() - ref_th.float()).abs()
                 <= bf16_step(ref_th) + 2.0 ** -20 * terms).all())
    assert ratio(dx, ref[0]) <= 1e-2 and ratio(dgate, ref[1]) <= 1e-2
    assert bool(((dz.float() - ref[2].float()).abs()
                 <= bf16_step(ref[2])).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("keep_prob", [1.0, 0.9])
@pytest.mark.parametrize("v", WIDE_V)
def test_wide_kernels_match_plain_on_gpu(cuda, dtype, keep_prob, v):
    case = make_case(11, n=150, d=64, e=3, v=v)
    x, w32, b, gate, gout = (torch.from_numpy(a).to(cuda) for a in case)
    seed = torch.tensor([SEED], dtype=torch.int32, device=cuda)
    held_to_plain(x, w32.to(dtype).contiguous(), b, gate, gout, 3,
                  keep_prob, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("keep_prob", [1.0, 0.9])
@pytest.mark.parametrize("d", [37, 640, 1100])
@pytest.mark.parametrize("n", [1, 63, 65, 1100])
@pytest.mark.parametrize("v", WIDE_V)
def test_wide_kernels_edge_shapes_on_gpu(cuda, v, n, d, keep_prob):
    """Ragged row counts (one row, a tile less or more one, many tiles), an
    odd D, the flagship's D and a D past 1024 (bf16 only: the float32
    bodies take D <= 1024), two experts."""
    case = make_case(13, n=n, d=d, e=2, v=v)
    x, w32, b, gate, gout = (torch.from_numpy(a).to(cuda) for a in case)
    seed = torch.tensor([SEED], dtype=torch.int32, device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        if dtype == torch.float32 and d > mk.MAX_D:
            continue
        held_to_plain(x, w32.to(dtype).contiguous(), b, gate, gout, 2,
                      keep_prob, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("v", [136, 256])
def test_wide_head_trains_on_the_kernels_on_gpu(cuda, v):
    """The head (``apply_moe``) in training on the card under the default
    backward: K5, K6 and one dw product, no route warning, the output and
    the gradients of x and every weight within 1e-4 of the plain
    version's (float32)."""
    x, *_, gout = (torch.from_numpy(a).to(cuda)
                   for a in make_case(17, n=300, d=64, e=4, v=v))
    gen = torch.Generator().manual_seed(v)
    params = {k: t.to(cuda).requires_grad_()
              for k, t in moe.init_moe(gen, 64, v, 4).items()}
    xt = x.clone().requires_grad_()
    leaves = [xt] + list(params.values())
    wrappers = (mk.moe_mix_forward_stash, mk.moe_mix_backward)
    before = [f.launches for f in wrappers]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = moe.apply_moe(params, xt, 4, TAU, compute_dtype=torch.float32)
        got = torch.autograd.grad(out, leaves, gout)
        torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [n + 1 for n in before]
    assert not [w for w in seen if "moe" in str(w.message)]
    gate = torch.softmax(xt @ params["w_prior"] + params["b_prior"], -1)
    ref_out = mk.moe_mix_reference(xt, params["w_expert"], params["b_expert"],
                                   gate, 4, TAU)
    ref = torch.autograd.grad(ref_out, leaves, gout)
    assert ratio(out, ref_out) <= 1e-4
    for g, r in zip(got, ref):
        assert ratio(g, r) <= 1e-4
