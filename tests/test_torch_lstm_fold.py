"""The folded BLSTM layer backward (``cells.dual_recurrence_backward_fold``,
kernel K3) and the training path that runs it with the MoE head's
single-kernel backward (K7).

On the CPU the autograd layer with ``fold_dx``
(``lstm_kernels.bilstm_dual_scan_train``) runs the plain forward and the
plain folded backward.  Its gradients (every parameter, and both inputs)
are held against ``jax.vjp`` of the JAX package's fused layer with
``LSTM_CTC_TPU_LSTM_FOLD_DX=1``, in interpret mode with store float32 and
an input width of 128 (where the reference folds), at rtol = atol = 1e-5,
on weights from JAX's ``init_lstm_cell`` and numpy inputs from a seed.
The whole train step of a small BLSTM + MoE model whose layer 1 is 128 wide,
with ``lstm_fold_dx`` and ``moe_wgrad_mode = kernel``, is held against the
JAX package's ``make_train_step`` with both folds switched on (params after
1 and 3 adam steps, 1e-4).  The ``cuda`` tests hold K3 against its plain
version on the card: float32 max|diff| / max|plain| <= 1e-4 per output; in
bfloat16 each step replayed from the kernel's own carries within 1e-3, and
the input side against the plain one over the kernel's own dgates.  JAX is
imported by a fixture, so the ``cuda`` tests also run where JAX is not
installed (pytest --noconftest).
"""

import types

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.models import cells
from lstm_ctc_tpu_torch.ops import lstm_kernels, moe_kernels
from lstm_ctc_tpu_torch.train.checkpoint import params_from_numpy

FORGET_BIAS = 5.0
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from lstm_ctc_tpu.models import cells as jcells
    from lstm_ctc_tpu.ops.lstm_pallas import bilstm_dual_scan_fused
    return types.SimpleNamespace(jax=jax, jnp=jnp, cells=jcells,
                                 fused=bilstm_dual_scan_fused)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def random_case(seed, batch=3, time_steps=13, dim=128, units=16, proj=8,
                peepholes=True, reset=False, jref=None):
    """Port parameters, numpy inputs and output cotangents from a seed; with
    ``jref`` the weights are JAX's ``init_lstm_cell``'s, through the
    checkpoint bridge, else the port's own (where JAX is not installed)."""
    if jref is None:
        gen = torch.Generator().manual_seed(seed)
        fw = cells.init_lstm_cell(gen, dim, units, proj, peepholes)
        bw = cells.init_lstm_cell(gen, dim, units, proj, peepholes)
    else:
        fw, bw = (params_from_numpy(jref.jax.tree.map(
            np.asarray, jref.cells.init_lstm_cell(
                jref.jax.random.PRNGKey(key), dim, units, num_proj=proj,
                use_peepholes=peepholes))) for key in (seed, seed + 50))
    rng = np.random.RandomState(seed)
    for p in (fw, bw):
        p["bias"] = torch.from_numpy((0.1 * rng.randn(4 * units)).astype(
            np.float32))
    out_dim = proj or units
    x = rng.randn(batch, time_steps, dim).astype(np.float32)
    seq_len = rng.randint(time_steps // 2, time_steps + 1,
                          batch).astype(np.int32)
    seq_len[0] = time_steps
    reset_mask = None
    if reset:
        reset_mask = np.zeros((batch, time_steps), np.float32)
        reset_mask[:, 0] = 1.0
        for b in range(batch):
            reset_mask[b, rng.randint(1, seq_len[b], 2)] = 1.0
    cots = [rng.randn(batch, time_steps, out_dim).astype(np.float32)
            for _ in range(2)]
    cots += [rng.randn(batch, n).astype(np.float32)
             for n in (units, out_dim, units, out_dim)]
    return fw, bw, x, seq_len, reset_mask, cots


def jax_fold_vjp(jref, fw, bw, x, seq_len, reset_mask, cots):
    """Gradients (fw params, bw params, x, x_rev) of the JAX fused layer
    with the fold on, under the given output cotangents."""
    jnp = jref.jnp
    jfw = {k: jnp.asarray(v.numpy()) for k, v in fw.items()}
    jbw = {k: jnp.asarray(v.numpy()) for k, v in bw.items()}
    seq = jnp.asarray(seq_len)
    reset = None if reset_mask is None else jnp.asarray(reset_mask)
    x_rev = jref.cells.reverse_sequence(jnp.asarray(x), seq) \
        if reset is None else \
        jref.cells.reverse_segments(jnp.asarray(x), seq, reset)

    def layer(a, b, xx, xr):
        return jref.fused(a, b, xx, xr, seq, FORGET_BIAS, time_block=4,
                          store_dtype="float32", interpret=True,
                          reset_mask=reset)

    _, vjp = jref.jax.vjp(layer, jfw, jbw, jnp.asarray(x), x_rev)
    c = [jnp.asarray(v) for v in cots]
    grads = vjp((c[0], c[1], ((c[2], c[3]), (c[4], c[5]))))
    return grads, np.array(x_rev)


def port_grads(fw, bw, x, x_rev, seq_len, reset_mask, cots, fold_dx=True):
    fw = {k: v.clone().requires_grad_() for k, v in fw.items()}
    bw = {k: v.clone().requires_grad_() for k, v in bw.items()}
    xt = torch.from_numpy(x).requires_grad_()
    xr = torch.from_numpy(x_rev).requires_grad_()
    fw_out, bw_out, ((cf, hf), (cb, hb)) = \
        lstm_kernels.bilstm_dual_scan_train(
            fw, bw, xt, xr, torch.from_numpy(seq_len), FORGET_BIAS,
            reset_mask=None if reset_mask is None
            else torch.from_numpy(reset_mask), store_dtype=torch.float32,
            fold_dx=fold_dx)
    total = sum((o * torch.from_numpy(c)).sum()
                for o, c in zip((fw_out, bw_out, cf, hf, cb, hb), cots))
    total.backward()
    return ({k: v.grad for k, v in fw.items()},
            {k: v.grad for k, v in bw.items()}, xt.grad, xr.grad)


@pytest.mark.parametrize("seed,peep,proj,reset", [
    (0, True, 8, False), (1, False, 8, False), (2, True, None, False),
    (3, True, 8, True), (4, False, None, True)])
def test_folded_layer_backward_matches_jax_fold(jref, monkeypatch, seed,
                                                peep, proj, reset):
    monkeypatch.setenv("LSTM_CTC_TPU_LSTM_FOLD_DX", "1")
    fw, bw, x, seq_len, reset_mask, cots = random_case(
        seed, peepholes=peep, proj=proj, reset=reset, jref=jref)
    ref, x_rev = jax_fold_vjp(jref, fw, bw, x, seq_len, reset_mask, cots)
    before = (lstm_kernels.lstm_layer_backward_fold.launches,
              lstm_kernels.lstm_layer_backward.launches)
    got = port_grads(fw, bw, x, x_rev, seq_len, reset_mask, cots)
    # the CPU path runs the plain versions: no kernel launch is counted
    assert (lstm_kernels.lstm_layer_backward_fold.launches,
            lstm_kernels.lstm_layer_backward.launches) == before
    for side in (0, 1):
        assert sorted(got[side]) == sorted(ref[side])
        for name in got[side]:
            np.testing.assert_allclose(got[side][name].numpy(),
                                       np.asarray(ref[side][name]),
                                       err_msg=name, **TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), **TOL)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), **TOL)


@pytest.mark.parametrize("reset", [False, True])
def test_fold_changes_only_the_order_of_sums(reset):
    """In float32 the folded layer gives the unfolded layer's gradients."""
    fw, bw, x, seq_len, reset_mask, cots = random_case(5, dim=24,
                                                       reset=reset)
    seq = torch.from_numpy(seq_len)
    x_rev = (cells.reverse_sequence(torch.from_numpy(x), seq)
             if reset_mask is None else cells.reverse_segments(
                 torch.from_numpy(x), seq, torch.from_numpy(reset_mask)))
    args = (fw, bw, x, x_rev.numpy(), seq_len, reset_mask, cots)
    folded, plain = port_grads(*args), port_grads(*args, fold_dx=False)
    for side in (0, 1):
        for name in plain[side]:
            torch.testing.assert_close(folded[side][name], plain[side][name],
                                       rtol=1e-6, atol=1e-6)
    for side in (2, 3):
        torch.testing.assert_close(folded[side], plain[side], rtol=1e-6,
                                   atol=1e-6)


def fold_args(seed, device="cpu", dtype=torch.float32, store=None, proj=8,
              reset=True, **shape):
    """The folded backward's arguments for one layer: x2 and wx, then K2's
    (the forward run through ``lstm_layer_forward`` with states in the
    store dtype)."""
    store = store or dtype
    fw, bw, x, seq_len, reset_mask, _ = random_case(seed, proj=proj,
                                                    reset=reset, **shape)
    fw = {k: v.to(device) for k, v in fw.items()}
    bw = {k: v.to(device) for k, v in bw.items()}
    xt = torch.from_numpy(x).to(device)
    seq = torch.from_numpy(seq_len).to(device)
    x2 = torch.stack([xt, cells.reverse_sequence(xt, seq)])
    wx, bias = cells.input_weights(fw, bw, dtype)
    gx = cells.input_projection(x2, wx, bias)
    wh, pj, peep = cells.recurrent_weights(fw, bw, dtype)
    _, keep = cells.step_masks(
        seq, None if reset_mask is None else torch.from_numpy(reset_mask),
        x.shape[1], device)
    args = (gx, seq, keep, wh, pj, peep, FORGET_BIAS)
    out, cfin, hfin, c_all, h_all = lstm_kernels.lstm_layer_forward(
        *args, states=True, store_dtype=store)
    gen = torch.Generator().manual_seed(seed + 100)
    dout = torch.randn(out.shape, generator=gen).to(device)
    dcfin = torch.randn(cfin.shape, generator=gen).to(device)
    dhfin = torch.randn(hfin.shape, generator=gen).to(device)
    return (x2, wx) + args + (c_all, h_all, dout, dcfin, dhfin)


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_plain_fold_is_k2_then_the_input_side(store):
    """The plain K3 gives K2's outputs (but dgates), and the input side
    as products over K2's dgates, rounded where the kernel rounds."""
    args = fold_args(6, store=store, dim=20)
    x2, wx = args[:2]
    got = lstm_kernels.lstm_layer_backward_fold(*args, store_dtype=store,
                                                steps=True)
    k2 = lstm_kernels.lstm_layer_backward(*args[2:], store_dtype=store,
                                          steps=True)
    dgates = k2[0]
    assert torch.equal(got[6], dgates)
    for g, r in zip(got[3:6] + got[7:], k2[1:4] + k2[4:]):
        assert torch.equal(g, r)
    dx2, dwx, dbias = got[:3]
    assert dx2.dtype == store and dx2.shape == x2.shape
    assert dwx.dtype == dbias.dtype == torch.float32
    dg = dgates.float().view(x2.shape[2], 2, x2.shape[1], -1)
    want_dx = torch.einsum("tgbk,gdk->gbtd", dg, wx.float())
    # within 1e-5, or one rounding step of the store dtype where it rounds
    bound = 1e-5 + 1e-5 * want_dx.abs() if store == torch.float32 \
        else bf16_step(want_dx)
    assert bool(((dx2.float() - want_dx).abs() <= bound).all())
    torch.testing.assert_close(dwx, torch.einsum("gbtd,tgbk->gdk", x2, dg),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dbias, dg.sum((0, 2)), rtol=1e-5, atol=1e-5)


def test_fold_wrapper_refuses_other_devices():
    args = fold_args(7, dim=16)
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_kernels.lstm_layer_backward_fold(*meta)


# --- the training path with both folds: the model against JAX's step ---

FOLD_CONFIG = dict(nnet_type="blstm", input_dim=4, left_context=1,
                   right_context=1, subsample=3, num_layers=2, num_neurons=16,
                   num_projects=64, num_targets=7, use_peepholes=True,
                   dropout_rate=1.0, num_experts=3, moe_temp=10.0, seed=777,
                   store_dtype="float32")


def labeled_batch(seed=0, batch=3, time_steps=14, max_u=4):
    rng = np.random.RandomState(seed)
    dim = FOLD_CONFIG["input_dim"] * 3
    targets = rng.randint(0, FOLD_CONFIG["num_targets"] - 1,
                          (batch, max_u)).astype(np.int32)
    target_length = np.array([4, 3, 2], np.int32)[:batch]
    for b in range(batch):
        targets[b, target_length[b]:] = -1
    return {"nnet_input": rng.randn(batch, time_steps, dim).astype(
                np.float32),
            "sequence_length": np.array([14, 10, 8], np.int32)[:batch],
            "nnet_target": targets, "target_length": target_length}


def test_train_step_with_both_folds_matches_jax(jref, monkeypatch):
    """Layer 1 (2P = 128 wide) trains through the plain K3, layer 0
    through K2's, the head through K7's; the JAX step runs its fused
    kernels in interpret mode with both folds switched on."""
    from lstm_ctc_tpu.models import init_model as jax_init_model
    from lstm_ctc_tpu.train.graph import make_train_step as jax_train_step
    from lstm_ctc_tpu_torch.train.checkpoint import tree_map
    from lstm_ctc_tpu_torch.train.graph import make_train_step, param_leaves
    jax, jnp = jref.jax, jref.jnp
    for name, value in (("LSTM_CTC_TPU_LSTM_IMPL", "pallas"),
                        ("LSTM_CTC_TPU_LSTM_FOLD_DX", "1"),
                        ("LSTM_CTC_TPU_MOE_IMPL", "fused"),
                        ("LSTM_CTC_TPU_MOE_WGRAD", "kernel")):
        monkeypatch.setenv(name, value)
    batch = labeled_batch()
    jparams, jstate = jax_init_model(jax.random.PRNGKey(5), FOLD_CONFIG)
    init, step = jax_train_step(FOLD_CONFIG, 1e-2, "adam")
    ref = jax.tree.map(jnp.array, jparams)
    ref_opt = init(ref)
    params = tree_map(lambda t: t.requires_grad_(), params_from_numpy(
        jax.tree.map(np.asarray, jparams)))
    port_init, port_step = make_train_step(
        dict(FOLD_CONFIG, lstm_fold_dx=True, moe_wgrad_mode="kernel"), 1e-2,
        "adam")
    opt_state = port_init(params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    calls = {"fold": 0, "k2": 0, "k7": 0}

    def counted(key, fn):
        def run(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(lstm_kernels, "lstm_layer_backward_fold", counted(
        "fold", lstm_kernels.lstm_layer_backward_fold))
    monkeypatch.setattr(lstm_kernels, "lstm_layer_backward", counted(
        "k2", lstm_kernels.lstm_layer_backward))
    monkeypatch.setattr(moe_kernels, "moe_mix_backward_wgrad", counted(
        "k7", moe_kernels.moe_mix_backward_wgrad))
    for i in range(3):
        ref, ref_opt, jstate, ref_metrics = step(
            ref, ref_opt, jstate, jax.random.PRNGKey(i),
            {k: jnp.asarray(v) for k, v in batch.items()})
        params, opt_state, _, metrics = port_step(params, opt_state, {},
                                                  None, tbatch)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(ref_metrics["loss"]), rtol=1e-4,
                                   atol=1e-4)
        if i in (0, 2):
            want = param_leaves(params_from_numpy(
                jax.tree.map(np.asarray, ref)))
            for got, w in zip(param_leaves(params), want):
                np.testing.assert_allclose(got.detach().numpy(), w.numpy(),
                                           rtol=1e-4, atol=1e-4)
    assert calls == {"fold": 3, "k2": 3, "k7": 3}


def ratio(got, ref):
    return float((got.float() - ref.float()).abs().max()) / max(
        float(ref.float().abs().max()), 1e-30)


def bf16_step(t):
    """One bf16 rounding step at each element of t (float32 view)."""
    return 2.0 ** -7 * t.float().abs() + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("proj,reset", [(8, True), (8, False),
                                        (None, True)])
def test_kernel_matches_plain_on_gpu_f32(cuda, proj, reset):
    args = fold_args(8, cuda, proj=proj, reset=reset, batch=5,
                     time_steps=40, dim=136)
    before = lstm_kernels.lstm_layer_backward_fold.launches
    got = lstm_kernels.lstm_layer_backward_fold(*args)
    ref = cells.dual_recurrence_backward_fold(*args)
    torch.cuda.synchronize()
    assert lstm_kernels.lstm_layer_backward_fold.launches == before + 1
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert ratio(g, r) <= 1e-4


@pytest.mark.cuda
def test_kernel_steps_replay_on_gpu_bf16(cuda):
    args = fold_args(9, cuda, dtype=torch.bfloat16, batch=5, time_steps=40,
                     dim=128)
    got = lstm_kernels.lstm_layer_backward_fold(
        *args, store_dtype=torch.bfloat16, steps=True)
    dgates, dc_in, dh_in = got[6:]
    dg, dc_out, dh_out = cells.replay_backward_steps(
        *args[2:-2], dc_in, dh_in, store_dtype=torch.bfloat16)
    assert ratio(dc_out[1:], dc_in[:-1]) <= 1e-3
    assert ratio(dh_out[1:], dh_in[:-1]) <= 1e-3
    assert bool(((dgates.float() - dg.float()).abs() <= bf16_step(dg)).all())
    # the input side against the plain one over the kernel's own dgates:
    # dx within one rounding step, and 16 float32 ulps of its terms' sum
    # (two orders of a sum differ by that much near a cancellation)
    dx2, dwx, dbias = cells.fold_input_side(args[0], args[1], dgates,
                                            torch.bfloat16)
    terms = cells.fold_input_side(args[0], args[1].abs(), dgates.abs(),
                                  torch.float32)[0]
    assert dx2.dtype == got[0].dtype == torch.bfloat16
    assert bool(((got[0].float() - dx2.float()).abs()
                 <= bf16_step(dx2) + 2.0 ** -20 * terms).all())
    assert ratio(got[1], dwx) <= 1e-3 and ratio(got[2], dbias) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("store", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dim", [36, 120, 1000])
def test_kernel_input_side_edge_shapes_on_gpu_bf16(cuda, dim, store):
    """K3's bf16 input side on the product engine at 200 rows a direction
    (B = 5, T = 40: no multiple of 64), input widths of one and eight 128-
    column tiles and one not a multiple of 8, with dgates stored in bf16
    and in float32 (cast to bf16 for the products): over the kernel's own
    dgates, dx within one bf16 rounding step plus 2^-20 of its terms' sum
    (float32 store: ratio <= 1e-3), dwx and dbias ratio <= 1e-3; and two
    launches on the same inputs bit-equal."""
    args = fold_args(10, cuda, dtype=torch.bfloat16, store=store, batch=5,
                     time_steps=40, dim=dim)
    got = lstm_kernels.lstm_layer_backward_fold(*args, store_dtype=store,
                                                steps=True)
    again = lstm_kernels.lstm_layer_backward_fold(*args, store_dtype=store,
                                                  steps=True)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert (g is None) == (a is None)
        if g is not None:
            assert torch.equal(g, a)
    dx2, dwx, dbias = cells.fold_input_side(args[0], args[1], got[6], store)
    assert got[0].dtype == store
    if store == torch.bfloat16:
        terms = cells.fold_input_side(args[0], args[1].abs(), got[6].abs(),
                                      torch.float32)[0]
        assert bool(((got[0].float() - dx2.float()).abs()
                     <= bf16_step(dx2) + 2.0 ** -20 * terms).all())
    else:
        assert ratio(got[0], dx2) <= 1e-3
    assert ratio(got[1], dwx) <= 1e-3 and ratio(got[2], dbias) <= 1e-3
