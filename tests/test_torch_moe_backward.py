"""The MoE head's training: K5 (forward with the tanh stash), K6 and K8
(backward to x and the gate), K9 (weight gradient), K7 (the whole backward
in one kernel), and the autograd function around them
(``moe_kernels._MoeMix`` through ``moe_mix_fused``).

On the CPU the four head gradients (dx, dw, db, dgate) of the port's
autograd function, under a random cotangent, are held against ``jax.grad``
through the JAX package's fused Pallas mix in interpret mode, in float32,
at keep 1.0 and at keep 0.9 with the same seed, in each of the port's three
weight-gradient modes, and the ``"kernel"`` mode also against the JAX
package's own ``"kernel"`` backward at keep 1.0 and 0.8 (rtol = atol =
1e-5).  The ``cuda`` tests hold each
kernel against its plain version on the card, in float32 and bfloat16 at
keep 1.0 and 0.9; they skip without a GPU.  JAX is imported by a fixture,
so the ``cuda`` tests also run where JAX is not installed.
"""

import types

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.models import moe
from lstm_ctc_tpu_torch.ops import moe_kernels

TAU = 10.0
SEED = -424242


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from lstm_ctc_tpu.ops import moe_pallas
    return types.SimpleNamespace(jax=jax, jnp=jnp, pallas=moe_pallas)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_case(seed, n=21, d=24, e=5, v=7):
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


def port_grads(case, e, keep_prob, wgrad_mode, device="cpu",
               dtype=torch.float32):
    x, w, b, gate, gout = (torch.from_numpy(a).to(device) for a in case)
    leaves = [t.clone().requires_grad_() for t in (x, w, b, gate)]
    seed = torch.tensor([SEED], dtype=torch.int32, device=device)
    out = moe_kernels.moe_mix_fused(*leaves, e, TAU, keep_prob, seed, dtype,
                                    wgrad_mode=wgrad_mode)
    grads = torch.autograd.grad(out, leaves, gout)
    return out.detach(), grads


@pytest.mark.parametrize("wgrad_mode", ["xla", "twokernel", "kernel"])
@pytest.mark.parametrize("keep_prob", [1.0, 0.9])
@pytest.mark.parametrize("e,v", [(5, 7), (3, 16), (4, 72)])
def test_head_gradients_match_jax_fused_vjp(jref, e, v, keep_prob,
                                            wgrad_mode):
    case = make_case(e + v, e=e, v=v)
    jnp = jref.jnp

    def loss(x, w, b, gate):
        out = jref.pallas.moe_mix_fused(
            x, w, b, gate, e, TAU, keep_prob=keep_prob, seed=jnp.int32(SEED),
            compute_dtype=jnp.float32, n_block=8, interpret=True)
        return jnp.sum(out * jnp.asarray(case[4])), out

    (_, ref_out), ref = jref.jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(a) for a in case[:4]))
    out, got = port_grads(case, e, keep_prob, wgrad_mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-5,
                               atol=1e-5)
    for name, g, r in zip(("dx", "dw", "db", "dgate"), got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("keep_prob", [1.0, 0.8])
@pytest.mark.parametrize("e,v", [(5, 7), (4, 72)])
def test_kernel_mode_matches_jax_kernel_mode(jref, monkeypatch, e, v,
                                             keep_prob):
    """K7's plain version against the JAX package's single-kernel backward
    (``LSTM_CTC_TPU_MOE_WGRAD=kernel``, ``_bwd_kernel_wgrad`` in interpret
    mode): the same hash mask, bit for bit, at keep 0.8."""
    monkeypatch.setenv("LSTM_CTC_TPU_MOE_WGRAD", "kernel")
    case = make_case(2 * e + v, n=29, e=e, v=v)
    jnp = jref.jnp

    def loss(x, w, b, gate):
        out = jref.pallas.moe_mix_fused(
            x, w, b, gate, e, TAU, keep_prob=keep_prob, seed=jnp.int32(SEED),
            compute_dtype=jnp.float32, n_block=8, interpret=True)
        return jnp.sum(out * jnp.asarray(case[4]))

    ref = jref.jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in case[:4]))
    before = moe_kernels.moe_mix_backward_wgrad.launches
    _, got = port_grads(case, e, keep_prob, "kernel")
    # the CPU path runs the plain version: no kernel launch is counted
    assert moe_kernels.moe_mix_backward_wgrad.launches == before
    for name, g, r in zip(("dx", "dw", "db", "dgate"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("keep_prob", [1.0, 0.9])
def test_twokernel_plain_path_reproduces_the_default(keep_prob):
    """In float32 the two weight-gradient modes give the same gradients:
    K9's recomputed dz is K6's emitted dz."""
    case = make_case(7, n=37, d=20, e=4, v=72)
    out_x, grads_x = port_grads(case, 4, keep_prob, "xla")
    out_t, grads_t = port_grads(case, 4, keep_prob, "twokernel")
    assert torch.equal(out_x, out_t)
    for a, b in zip(grads_x, grads_t):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_mask_is_shared_by_forward_and_backward():
    """A dropped element carries no gradient to its expert weights: with
    one expert and one row, dw's column is zero exactly where the hash
    mask drops it, and the stash's forward agrees with the plain mix."""
    x, w, b, gate, gout = make_case(3, n=1, d=6, e=1, v=64)
    seed = torch.tensor([SEED], dtype=torch.int32)
    args = [torch.from_numpy(a) for a in (x, w, b, gate)]
    out, th = moe_kernels.moe_stash_reference(*args, seed, 1, TAU, 0.5)
    assert torch.equal(out, moe_kernels.moe_mix_reference(
        *args, 1, TAU, 0.5, seed))
    dw, db = moe_kernels.moe_wgrad_reference(
        args[0], th, args[3], torch.from_numpy(gout), seed, 1, TAU, 0.5)
    kept = moe_kernels.hash_uniform(seed, 0, 0, 1, 64)[0] < 0.5
    assert 0 < int(kept.sum()) < 64
    assert torch.equal(db != 0, kept)
    assert torch.equal((dw != 0).any(0), kept)


def test_wgrad_mode_kernel_is_not_ported():
    """Once K7 was missing and "kernel" raised; now it runs, its plain
    version is K8's and K9's together, and the mode gives the default's
    gradients.  An unknown mode still raises."""
    case = make_case(1, e=5, v=7)
    x, w, b, gate, gout = (torch.from_numpy(a) for a in case)
    seed = torch.tensor([SEED], dtype=torch.int32)
    out, th = moe_kernels.moe_stash_reference(x, w, b, gate, seed, 5, TAU,
                                              0.9)
    args = (seed, 5, TAU, 0.9)
    got = moe_kernels.moe_mix_backward_wgrad(x, th, w, gate, gout, *args)
    want = (moe_kernels.moe_backward_noemit_reference(th, w, gate, gout,
                                                      *args)
            + moe_kernels.moe_wgrad_reference(x, th, gate, gout, *args))
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    _, grads_k = port_grads(case, 5, 0.9, "kernel")
    _, grads_x = port_grads(case, 5, 0.9, "xla")
    for a, c in zip(grads_k, grads_x):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="wgrad_mode"):
        moe_kernels.moe_mix_fused(x, w, b, gate, 5, TAU, wgrad_mode="fold")


def test_grad_mode_picks_the_kernel():
    """Under autograd the stash forward (K5's plain version) runs; without
    it, the serving forward (K4's), with the same output."""
    x, w, b, gate, _ = (torch.from_numpy(a) for a in make_case(2))
    calls = []
    real_stash, real_fwd = (moe_kernels.moe_mix_forward_stash,
                            moe_kernels.moe_mix_forward)

    def stash(*args):
        calls.append("K5")
        return real_stash(*args)

    def forward(*args):
        calls.append("K4")
        return real_fwd(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe_kernels, "moe_mix_forward_stash", stash)
        mp.setattr(moe_kernels, "moe_mix_forward", forward)
        trained = moe_kernels.moe_mix_fused(x, w.clone().requires_grad_(), b,
                                            gate, 5, TAU,
                                            compute_dtype=torch.float32)
        with torch.no_grad():
            served = moe_kernels.moe_mix_fused(
                x, w.clone().requires_grad_(), b, gate, 5, TAU,
                compute_dtype=torch.float32)
    assert calls == ["K5", "K4"]
    torch.testing.assert_close(trained.detach(), served, rtol=0, atol=0)


def test_apply_moe_training_draws_a_device_seed():
    """keep < 1 with a generator: gate dropout and an int32 seed drawn on
    the device; the same generator seed repeats the output exactly."""
    x, w, b, _, _ = make_case(4, e=3, v=16)
    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe(gen, 24, 16, 3)
    xt = torch.from_numpy(x)
    outs = [moe.apply_moe(params, xt, 3, TAU, keep_prob=0.9,
                          generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    plain = moe.apply_moe(params, xt, 3, TAU)
    assert not torch.equal(outs[0], plain)
    assert torch.equal(moe.apply_moe(params, xt, 3, TAU, keep_prob=0.9),
                       plain)


def bf16_step(t):
    """One bf16 rounding step at each element of t (float32 view)."""
    return 2.0 ** -7 * t.float().abs() + 1e-6


def ratio(got, ref):
    return float((got.float() - ref.float()).abs().max()) / max(
        float(ref.float().abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("keep_prob", [1.0, 0.9])
@pytest.mark.parametrize("e,v,d", [(5, 7, 40), (4, 72, 200)])
def test_kernels_match_plain_on_gpu(cuda, dtype, keep_prob, e, v, d):
    case = make_case(5, n=150, d=d, e=e, v=v)
    x, w32, b, gate, gout = (torch.from_numpy(a).to(cuda) for a in case)
    w = w32.to(dtype).contiguous()
    seed = torch.tensor([SEED], dtype=torch.int32, device=cuda)
    counts = {f: f.launches for f in (
        moe_kernels.moe_mix_forward_stash, moe_kernels.moe_mix_backward,
        moe_kernels.moe_mix_backward_noemit, moe_kernels.moe_mix_wgrad)}
    args = (seed, e, TAU, keep_prob)
    f32 = dtype == torch.float32
    tol = 1e-4 if f32 else 1e-2

    out, th = moe_kernels.moe_mix_forward_stash(x, w, b, gate, *args)
    ref_out, ref_th = moe_kernels.moe_stash_reference(x, w, b, gate, *args)
    assert th.dtype == dtype
    if f32:
        assert ratio(out, ref_out) <= 1e-4 and ratio(th, ref_th) <= 1e-4
    else:
        assert float((out - ref_out).abs().max()) <= 5e-2
        assert bool(((th.float() - ref_th.float()).abs()
                     <= bf16_step(ref_th)).all())

    dx, dgate, dz = moe_kernels.moe_mix_backward(th, w, gate, gout, *args)
    ref = moe_kernels.moe_backward_reference(th, w, gate, gout, *args)
    assert ratio(dx, ref[0]) <= tol and ratio(dgate, ref[1]) <= tol
    assert dz.dtype == dtype
    assert bool(((dz.float() - ref[2].float()).abs()
                 <= (1e-4 * ref[2].float().abs().max() if f32
                     else bf16_step(ref[2]))).all())
    dx8, dgate8 = moe_kernels.moe_mix_backward_noemit(th, w, gate, gout,
                                                      *args)
    assert torch.equal(dx8, dx) and torch.equal(dgate8, dgate)

    dw, db = moe_kernels.moe_mix_wgrad(x, th, gate, gout, *args)
    ref_dw, ref_db = moe_kernels.moe_wgrad_reference(x, th, gate, gout,
                                                     *args)
    assert ratio(dw, ref_dw) <= tol and ratio(db, ref_db) <= tol
    torch.cuda.synchronize()
    for f, before in counts.items():
        assert f.launches == before + 1, f.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 65, 150, 1100])
@pytest.mark.parametrize("e,v,d", [(1, 8, 40), (1, 128, 40), (4, 8, 37),
                                   (3, 128, 1000), (3, 72, 1408),
                                   (3, 128, 1408), (3, 72, 1600),
                                   (3, 128, 1600)])
def test_kernels_edge_shapes_on_gpu(cuda, n, e, v, d):
    """bf16 K5, K6 and K8 at ragged row counts, one expert, V at the
    narrowest and widest products, an odd D, a D of two dx slices, and D
    where K5 streams x with W; keep 0.9, the rules of
    test_kernels_match_plain_on_gpu."""
    case = make_case(7, n=n, d=d, e=e, v=v)
    x, w32, b, gate, gout = (torch.from_numpy(a).to(cuda) for a in case)
    w = w32.to(torch.bfloat16).contiguous()
    seed = torch.tensor([SEED], dtype=torch.int32, device=cuda)
    args = (seed, e, TAU, 0.9)
    out, th = moe_kernels.moe_mix_forward_stash(x, w, b, gate, *args)
    ref_out, ref_th = moe_kernels.moe_stash_reference(x, w, b, gate, *args)
    assert float((out - ref_out).abs().max()) <= 5e-2
    # two orders of the float32 sum x·W can differ by 2^-20 of the sum of
    # its terms' magnitudes, which near a cancellation (th near 0) exceeds
    # a rounding step of th
    terms = x.to(torch.bfloat16).float().abs() @ w.float().abs()
    assert bool(((th.float() - ref_th.float()).abs()
                 <= bf16_step(ref_th) + 2.0 ** -20 * terms).all())
    dx, dgate, dz = moe_kernels.moe_mix_backward(th, w, gate, gout, *args)
    ref = moe_kernels.moe_backward_reference(th, w, gate, gout, *args)
    assert ratio(dx, ref[0]) <= 1e-2 and ratio(dgate, ref[1]) <= 1e-2
    assert bool(((dz.float() - ref[2].float()).abs()
                 <= bf16_step(ref[2])).all())
    dx8, dgate8 = moe_kernels.moe_mix_backward_noemit(th, w, gate, gout,
                                                      *args)
    torch.cuda.synchronize()
    assert torch.equal(dx8, dx) and torch.equal(dgate8, dgate)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("keep_prob", [1.0, 0.9])
@pytest.mark.parametrize("n,e,v,d", [(150, 5, 7, 40), (1100, 4, 72, 200)])
def test_single_kernel_backward_matches_plain_on_gpu(cuda, dtype, keep_prob,
                                                     n, e, v, d):
    """K7 against its plain version, fed the stash K5 wrote: dx and dgate
    as K6's rules, dw and db as K9's (n = 1100 spans three row groups)."""
    case = make_case(8, n=n, d=d, e=e, v=v)
    x, w32, b, gate, gout = (torch.from_numpy(a).to(cuda) for a in case)
    w = w32.to(dtype).contiguous()
    seed = torch.tensor([SEED], dtype=torch.int32, device=cuda)
    args = (seed, e, TAU, keep_prob)
    _, th = moe_kernels.moe_mix_forward_stash(x, w, b, gate, *args)
    before = moe_kernels.moe_mix_backward_wgrad.launches
    got = moe_kernels.moe_mix_backward_wgrad(x, th, w, gate, gout, *args)
    ref = moe_kernels.moe_backward_wgrad_reference(x, th, w, gate, gout,
                                                   *args)
    torch.cuda.synchronize()
    assert moe_kernels.moe_mix_backward_wgrad.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert ratio(g, r) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 65, 150, 1100])
@pytest.mark.parametrize("e,v,d", [(1, 8, 40), (5, 7, 120), (3, 128, 1000),
                                   (4, 72, 1000)])
def test_single_kernel_backward_edge_shapes_on_gpu(cuda, n, e, v, d):
    """bf16 K7 (K6's body, then the dw product) at ragged row counts, E·V
    not a multiple of 8, D of one and of two dx slices, keep 0.9: dx and
    dgate equal K6's bit for bit, the rest within test_single_kernel_
    backward_matches_plain_on_gpu's bounds, and two calls on the same
    inputs bit-equal."""
    case = make_case(9, n=n, d=d, e=e, v=v)
    x, w32, b, gate, gout = (torch.from_numpy(a).to(cuda) for a in case)
    w = w32.to(torch.bfloat16).contiguous()
    seed = torch.tensor([SEED], dtype=torch.int32, device=cuda)
    args = (seed, e, TAU, 0.9)
    _, th = moe_kernels.moe_mix_forward_stash(x, w, b, gate, *args)
    got = moe_kernels.moe_mix_backward_wgrad(x, th, w, gate, gout, *args)
    again = moe_kernels.moe_mix_backward_wgrad(x, th, w, gate, gout, *args)
    k6 = moe_kernels.moe_mix_backward(th, w, gate, gout, *args)
    ref = moe_kernels.moe_backward_wgrad_reference(x, th, w, gate, gout,
                                                   *args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], k6[0]) and torch.equal(got[1], k6[1])
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, a)
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert ratio(g, r) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("keep_prob", [1.0, 0.9])
@pytest.mark.parametrize("n", [1, 63, 65, 150, 1100])
@pytest.mark.parametrize("e,v,d", [(1, 8, 36), (5, 7, 120), (3, 128, 1000),
                                   (4, 72, 1408)])
def test_wgrad_equals_single_kernel_on_gpu(cuda, keep_prob, n, e, v, d):
    """bf16 K9 (dz and db's partials made once, then K7's second stage) at
    ragged row counts, E·V not a multiple of 8, V at 8 and 128, D of one
    and of two dx slices and past 1024: (dw, db) equal K7's bit for bit,
    within the plain bounds of test_kernels_match_plain_on_gpu, and two
    calls on the same inputs bit-equal."""
    case = make_case(10, n=n, d=d, e=e, v=v)
    x, w32, b, gate, gout = (torch.from_numpy(a).to(cuda) for a in case)
    w = w32.to(torch.bfloat16).contiguous()
    seed = torch.tensor([SEED], dtype=torch.int32, device=cuda)
    args = (seed, e, TAU, keep_prob)
    _, th = moe_kernels.moe_mix_forward_stash(x, w, b, gate, *args)
    before = moe_kernels.moe_mix_wgrad.launches
    got = moe_kernels.moe_mix_wgrad(x, th, gate, gout, *args)
    again = moe_kernels.moe_mix_wgrad(x, th, gate, gout, *args)
    k7 = moe_kernels.moe_mix_backward_wgrad(x, th, w, gate, gout, *args)
    ref = moe_kernels.moe_wgrad_reference(x, th, gate, gout, *args)
    torch.cuda.synchronize()
    assert moe_kernels.moe_mix_wgrad.launches == before + 2
    for g, a, k, r in zip(got, again, k7[2:], ref):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert torch.equal(g, a) and torch.equal(g, k)
        assert ratio(g, r) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("wgrad_mode", ["xla", "twokernel", "kernel"])
def test_autograd_on_gpu_matches_cpu(cuda, wgrad_mode):
    """The autograd function through the kernels (f32, TF32 off) against
    the same function on the CPU, through the plain versions."""
    case = make_case(6, n=300, d=200, e=4, v=72)
    out, grads = port_grads(case, 4, 0.9, wgrad_mode, cuda)
    ref_out, ref = port_grads(case, 4, 0.9, wgrad_mode)
    assert ratio(out.cpu(), ref_out) <= 1e-4
    for g, r in zip(grads, ref):
        assert ratio(g.cpu(), r) <= 1e-4
