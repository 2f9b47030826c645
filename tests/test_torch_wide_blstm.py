"""The BLSTM layer at Kaldi's BLSTMP widths (cell 1024, projection 256),
which the layer kernels take with 16-block clusters (``csrc/lstm_fwd.cu``,
``csrc/lstm_bwd.cu``; their cluster partitions are emulated at these
widths in ``test_torch_lstm_fwd_cluster.py`` and
``test_torch_lstm_bwd_cluster.py``), and at the widths of their streamed
plan (H = P = 1024 without a projection, 2048 cells with a projection of
512; emulated in ``test_torch_lstm_streamed.py``): there the layer at B =
2, T = 4, and a train step at 1024/1024, as at 1024/256.

On the CPU the layer runs its plain versions (``cells.dual_recurrence``
and, under autograd, ``cells.dual_recurrence_backward``).  Here, at H =
1024, P = 256, B = 3, with inputs from a numpy seed in float32, they are
held against the JAX package: the forward and every gradient against its
scan ``cells.bilstm_dual_scan`` (T = 6) and against its fused Pallas layer
in interpret mode (T = 4), at rtol = atol = 1e-5; and a 2-layer wide
BLSTM with the MoE head, on the same weights through the checkpoint
bridge, against the JAX package's train step: the parameters after one
adam step at rtol = atol = 1e-4, at the recipes' learning rate of 1e-3
(adam's first step moves each weight by lr·g / (|g| + eps), about lr
whatever the gradient's size: where a gradient is near eps, as a few of
the 262,144 of a wide projection are, the two sides' float32 rounding of
g moves the update by a part of lr).
"""

import types

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.models import cells
from lstm_ctc_tpu_torch.ops import lstm_kernels
from lstm_ctc_tpu_torch.train.checkpoint import params_from_numpy

FORGET_BIAS = 5.0
TOL = dict(rtol=1e-5, atol=1e-5)
UNITS, PROJ = 1024, 256  # Kaldi's nnet3 BLSTMP cell-dim and projection


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from lstm_ctc_tpu.models import cells as jcells
    from lstm_ctc_tpu.ops.lstm_pallas import bilstm_dual_scan_fused
    return types.SimpleNamespace(jax=jax, jnp=jnp, cells=jcells,
                                 fused=bilstm_dual_scan_fused)


def wide_case(seed, time_steps, batch=3, dim=8, units=UNITS, proj=PROJ):
    """Port parameters of both directions, numpy inputs with resets, and
    output cotangents, from a seed (``proj`` None: no projection)."""
    gen = torch.Generator().manual_seed(seed)
    fw, bw = (cells.init_lstm_cell(gen, dim, units, proj, True)
              for _ in range(2))
    out_dim = proj or units
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, time_steps, dim).astype(np.float32)
    seq_len = np.array([time_steps, time_steps - 1, time_steps // 2],
                       np.int32)[:batch]
    reset_mask = np.zeros((batch, time_steps), np.float32)
    reset_mask[:, 0] = 1.0
    reset_mask[0, time_steps // 2] = 1.0
    cots = [rng.randn(batch, time_steps, out_dim).astype(np.float32)
            for _ in range(2)]
    cots += [rng.randn(batch, n).astype(np.float32)
             for n in (units, out_dim, units, out_dim)]
    return fw, bw, x, seq_len, reset_mask, cots


def jax_layer(jref, fused):
    if not fused:
        return jref.cells.bilstm_dual_scan

    def layer(*args, **kwargs):
        return jref.fused(*args, time_block=4, store_dtype="float32",
                          interpret=True, **kwargs)
    return layer


def jax_outputs_and_grads(jref, fn, fw, bw, x, seq_len, reset_mask, cots):
    """The JAX layer's outputs, and the gradients (fw params, bw params, x,
    x_rev) under the given output cotangents."""
    jnp = jref.jnp
    jfw = {k: jnp.asarray(v.numpy()) for k, v in fw.items()}
    jbw = {k: jnp.asarray(v.numpy()) for k, v in bw.items()}
    seq, reset = jnp.asarray(seq_len), jnp.asarray(reset_mask)
    x_rev = jref.cells.reverse_segments(jnp.asarray(x), seq, reset)

    def layer(a, b, xx, xr):
        return fn(a, b, xx, xr, seq, FORGET_BIAS, reset_mask=reset)

    out, vjp = jref.jax.vjp(layer, jfw, jbw, jnp.asarray(x), x_rev)
    c = [jnp.asarray(v) for v in cots]
    grads = vjp((c[0], c[1], ((c[2], c[3]), (c[4], c[5]))))
    return out, grads, np.array(x_rev)


def port_outputs_and_grads(fw, bw, x, x_rev, seq_len, reset_mask, cots):
    fw = {k: v.clone().requires_grad_() for k, v in fw.items()}
    bw = {k: v.clone().requires_grad_() for k, v in bw.items()}
    xt = torch.from_numpy(x).requires_grad_()
    xr = torch.from_numpy(x_rev).requires_grad_()
    fw_out, bw_out, ((cf, hf), (cb, hb)) = \
        lstm_kernels.bilstm_dual_scan_train(
            fw, bw, xt, xr, torch.from_numpy(seq_len), FORGET_BIAS,
            reset_mask=torch.from_numpy(reset_mask),
            store_dtype=torch.float32)
    outs = (fw_out, bw_out, cf, hf, cb, hb)
    total = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    total.backward()
    return (outs, ({k: v.grad for k, v in fw.items()},
                   {k: v.grad for k, v in bw.items()}, xt.grad, xr.grad))


def check_layer_against_jax(jref, fused, case):
    fw, bw, x, seq_len, reset_mask, cots = case
    ref_out, ref_grads, x_rev = jax_outputs_and_grads(
        jref, jax_layer(jref, fused), fw, bw, x, seq_len, reset_mask, cots)
    before = (lstm_kernels.lstm_layer_forward.launches,
              lstm_kernels.lstm_layer_backward.launches)
    outs, grads = port_outputs_and_grads(fw, bw, x, x_rev, seq_len,
                                         reset_mask, cots)
    # the CPU path runs the plain versions: no kernel launch is counted
    assert (lstm_kernels.lstm_layer_forward.launches,
            lstm_kernels.lstm_layer_backward.launches) == before
    flat_ref = [ref_out[0], ref_out[1], ref_out[2][0][0], ref_out[2][0][1],
                ref_out[2][1][0], ref_out[2][1][1]]
    for name, g, r in zip(("fw_out", "bw_out", "fw_c", "fw_h", "bw_c",
                           "bw_h"), outs, flat_ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   err_msg=name, **TOL)
    for side in (0, 1):
        assert sorted(grads[side]) == sorted(ref_grads[side])
        for name in grads[side]:
            np.testing.assert_allclose(grads[side][name].numpy(),
                                       np.asarray(ref_grads[side][name]),
                                       err_msg=name, **TOL)
    np.testing.assert_allclose(grads[2].numpy(), np.asarray(ref_grads[2]),
                               **TOL)
    np.testing.assert_allclose(grads[3].numpy(), np.asarray(ref_grads[3]),
                               **TOL)


@pytest.mark.parametrize("fused,time_steps", [(False, 6), (True, 4)],
                         ids=["scan", "pallas-interpret"])
def test_wide_layer_matches_jax(jref, fused, time_steps):
    """The plain forward (the layer's outputs and final states) and its
    autograd backward (every parameter's gradient and both inputs') at H =
    1024, P = 256, with packed-row resets."""
    check_layer_against_jax(jref, fused, wide_case(1, time_steps))


# the widths of the layer kernels' streamed plan (on the card; the CPU runs
# the plain versions): H = P = 1024 without a projection, and 2048 cells
# with a projection of 512 (Sak, Senior and Beaufays' LSTMP)
STREAMED = [(1024, None), (2048, 512)]


@pytest.mark.parametrize("fused", [False, True],
                         ids=["scan", "pallas-interpret"])
@pytest.mark.parametrize("units,proj", STREAMED,
                         ids=["1024-noproj", "2048x512"])
def test_streamed_widths_match_jax(jref, units, proj, fused):
    """The layer and every gradient at the streamed plan's widths, B = 2,
    T = 4, with packed-row resets, against JAX's scan and its fused Pallas
    layer in interpret mode."""
    check_layer_against_jax(jref, fused, wide_case(
        2, 4, batch=2, units=units, proj=proj))


WIDE_CONFIG = dict(nnet_type="blstm", input_dim=4, left_context=1,
                   right_context=1, subsample=3, num_layers=2,
                   num_neurons=UNITS, num_projects=PROJ, num_targets=7,
                   use_peepholes=True, dropout_rate=1.0, num_experts=3,
                   moe_temp=10.0, seed=777, store_dtype="float32")
LEARN_RATE = 1e-3


def labeled_batch(seed=0, batch=3, time_steps=8, max_u=3):
    rng = np.random.RandomState(seed)
    dim = WIDE_CONFIG["input_dim"] * 3
    targets = rng.randint(0, WIDE_CONFIG["num_targets"] - 1,
                          (batch, max_u)).astype(np.int32)
    target_length = np.array([3, 2, 1], np.int32)[:batch]
    for b in range(batch):
        targets[b, target_length[b]:] = -1
    return {"nnet_input": rng.randn(batch, time_steps, dim).astype(
                np.float32),
            "sequence_length": np.array([8, 6, 5], np.int32)[:batch],
            "nnet_target": targets, "target_length": target_length}


def test_wide_train_step_matches_jax(jref):
    """A 2-layer BLSTM of 1024 cells with 256-wide projections (layer 1
    fed 512 wide) and the MoE head: the loss and every parameter after one
    adam step, from the JAX package's initial weights through the bridge."""
    check_train_step_against_jax(jref, WIDE_CONFIG, 2 * PROJ)


@pytest.mark.parametrize("units,proj", STREAMED,
                         ids=["1024-noproj", "2048x512"])
def test_streamed_train_step_matches_jax(jref, units, proj):
    """The same at the streamed plan's widths (on the card): H = P = 1024
    without a projection (layer 1 fed 2048 wide) and 2048 cells with a
    projection of 512 (layer 1 fed 1024 wide)."""
    check_train_step_against_jax(
        jref, dict(WIDE_CONFIG, num_neurons=units, num_projects=proj or 0),
        2 * (proj or units), units)


def check_train_step_against_jax(jref, config, layer1_width, units=UNITS):
    from lstm_ctc_tpu.models import init_model as jax_init_model
    from lstm_ctc_tpu.train.graph import make_train_step as jax_train_step
    from lstm_ctc_tpu_torch.train.checkpoint import tree_map
    from lstm_ctc_tpu_torch.train.graph import make_train_step, param_leaves
    jax, jnp = jref.jax, jref.jnp
    batch = labeled_batch()
    jparams, jstate = jax_init_model(jax.random.PRNGKey(3), config)
    init, step = jax_train_step(config, LEARN_RATE, "adam")
    ref = jax.tree.map(jnp.array, jparams)
    ref, _, _, ref_metrics = step(
        ref, init(ref), jstate, jax.random.PRNGKey(0),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = tree_map(lambda t: t.requires_grad_(), params_from_numpy(
        jax.tree.map(np.asarray, jparams)))
    assert params["fwd"][1]["wx"].shape == (layer1_width, 4 * units)
    port_init, port_step = make_train_step(config, LEARN_RATE, "adam")
    before = lstm_kernels.lstm_layer_backward.launches
    params, _, _, metrics = port_step(
        params, port_init(params), {}, None,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert lstm_kernels.lstm_layer_backward.launches == before
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(ref_metrics["loss"]), rtol=1e-4,
                               atol=1e-4)
    want = param_leaves(params_from_numpy(jax.tree.map(np.asarray, ref)))
    got = param_leaves(params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-4)
