"""The unidirectional stack at Kaldi's LSTMP widths (cell 1024, recurrent
projection 256), which the stack kernels take with 16-block clusters
(``csrc/lstm_stack_fwd.cu``, ``csrc/lstm_stack_bwd.cu``; their partitions
are emulated with 16 blocks in ``test_torch_lstm_stack_pipeline.py``), and
at Sak, Senior and Beaufays' LSTMP widths (cell 2048, projection 512),
which they take on the streamed plan, 128 units a block (emulated in
``test_torch_lstm_stack_streamed.py``).

On the CPU the stack runs its plain versions (``stack_forward_reference``
and, under autograd, ``stack_backward_reference``).  Here, at H = 1024, P
= 256, with inputs from a numpy seed in float32, they are held against the
JAX package: a 2-layer stack's outputs, final states and every gradient
against its ``lstm_stack_fused`` (the Pallas wavefront kernels in
interpret mode, store float32; B = 3, T = 6; at 2048/512 B = 2, T = 4)
at rtol = atol = 1e-5; and a
2-layer ``lstm`` model with the MoE head, on the same weights through the
checkpoint bridge, against the JAX package's train step at keep 1.0: the
loss and the parameters after one adam step at rtol = atol = 1e-4, at the
recipes' learning rate of 1e-3 (adam's first step moves each weight by
about lr whatever the gradient's size).  The streaming session at both
widths equals the offline forward (rtol = atol = 1e-4); and a uniform stack
the route runs layer by layer (a plan refusal, faked) applies the stack
kernels' hash dropout: at keep 0.9 it equals the plain K12 with the same
seed (rtol = atol = 1e-5).
"""

import types

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.models import cells
from lstm_ctc_tpu_torch.models import lstm as lstm_model
from lstm_ctc_tpu_torch.ops import lstm_stack_kernels as sk
from lstm_ctc_tpu_torch.train.checkpoint import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
UNITS, PROJ = 1024, 256  # Kaldi's nnet3 LSTMP cell-dim and projection
# Sak, Senior and Beaufays' LSTMP (2014): 2048 cells, projection 512
SAK_UNITS, SAK_PROJ = 2048, 512


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from lstm_ctc_tpu.ops import lstm_stack_pallas
    return types.SimpleNamespace(jax=jax, jnp=jnp, stack=lstm_stack_pallas)


def wide_stack(seed, layers=2, dim=12, units=UNITS, proj=PROJ):
    """A uniform stack of peephole cells of ``units`` (1024) with
    ``proj``-wide (256) projections (layer 0 fed ``dim`` wide), non-zero
    biases."""
    gen = torch.Generator().manual_seed(seed)
    params, d = [], dim
    for _ in range(layers):
        params.append(cells.init_lstm_cell(gen, d, units, proj, True))
        d = proj
    rng = np.random.RandomState(seed)
    for p in params:
        p["bias"] = torch.from_numpy(
            (0.1 * rng.randn(p["bias"].shape[0])).astype(np.float32))
    return params


def wide_inputs(seed, batch=3, time_steps=6, dim=12):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, time_steps, dim).astype(np.float32)
    seq = np.array([time_steps, time_steps - 2, 3][:batch], np.int32)
    return x, seq


def test_wide_stack_matches_jax(jref):
    """The plain forward (outputs, each layer's final states) and its
    autograd backward (every parameter's gradient and dx) of a 2-layer
    stack at H = 1024, P = 256 (layer 1 residual), with initial states and
    their gradients."""
    stack_matches_jax(jref, UNITS, PROJ, batch=3, time_steps=6)


def test_sak_lstmp_stack_matches_jax(jref):
    """The same at Sak, Senior and Beaufays' LSTMP widths, H = 2048, P =
    512 (B = 2, T = 4)."""
    stack_matches_jax(jref, SAK_UNITS, SAK_PROJ, batch=2, time_steps=4)


def stack_matches_jax(jref, units, proj, batch, time_steps):
    jnp = jref.jnp
    params = wide_stack(1, units=units, proj=proj)
    x, seq = wide_inputs(1, batch, time_steps)
    flags = (False, True)
    rng = np.random.RandomState(2)
    init = [(0.1 * rng.randn(batch, units).astype(np.float32),
             0.1 * rng.randn(batch, proj).astype(np.float32))
            for _ in range(2)]
    cot = rng.randn(batch, time_steps, proj).astype(np.float32)
    state_cots = [(rng.randn(batch, units).astype(np.float32),
                   rng.randn(batch, proj).astype(np.float32))
                  for _ in range(2)]

    def jax_loss(ps, xs, states):
        out, fin = jref.stack.lstm_stack_fused(
            ps, xs, jnp.asarray(seq), 1.0, residual_flags=flags,
            store_dtype="float32", time_block=8, interpret=True,
            initial_states=states)
        total = jnp.sum(out * cot)
        for (c, h), (dc, dh) in zip(fin, state_cots):
            total = total + jnp.sum(c * dc) + jnp.sum(h * dh)
        return total, (out, fin)

    jparams = [{k: jnp.asarray(v.numpy()) for k, v in p.items()}
               for p in params]
    jstates = [(jnp.asarray(c), jnp.asarray(h)) for c, h in init]
    (_, (want_out, want_fin)), want_grads = jref.jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(jparams, jnp.asarray(x),
                                                   jstates)

    leaves = [t.requires_grad_() for p in params for t in p.values()]
    xt = torch.from_numpy(x).requires_grad_()
    states = [(torch.from_numpy(c).requires_grad_(),
               torch.from_numpy(h).requires_grad_()) for c, h in init]
    before = (sk.lstm_stack_forward.launches, sk.lstm_stack_backward.launches)
    out, fin = sk.lstm_stack_fused(params, xt, torch.from_numpy(seq), 1.0,
                                   residual_flags=flags,
                                   store_dtype=torch.float32,
                                   initial_states=states)
    total = (out * torch.from_numpy(cot)).sum()
    for (c, h), (dc, dh) in zip(fin, state_cots):
        total = total + (c * torch.from_numpy(dc)).sum() \
            + (h * torch.from_numpy(dh)).sum()
    grads = torch.autograd.grad(
        total, leaves + [xt] + [t for s in states for t in s])
    # the CPU path runs the plain versions: no kernel launch is counted
    assert (sk.lstm_stack_forward.launches,
            sk.lstm_stack_backward.launches) == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               err_msg="outputs", **TOL)
    for l, ((c, h), (wc, wh)) in enumerate(zip(fin, want_fin)):
        np.testing.assert_allclose(c.detach().numpy(), np.asarray(wc),
                                   err_msg="c of layer %d" % l, **TOL)
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(wh),
                                   err_msg="h of layer %d" % l, **TOL)
    i = 0
    for l, p in enumerate(params):
        for name in p:
            np.testing.assert_allclose(
                grads[i].numpy(), np.asarray(want_grads[0][l][name]),
                err_msg="layer %d d%s" % (l, name), **TOL)
            i += 1
    np.testing.assert_allclose(grads[i].numpy(), np.asarray(want_grads[1]),
                               err_msg="dx", **TOL)
    for l, (dc, dh) in enumerate(zip(grads[i + 1::2], grads[i + 2::2])):
        np.testing.assert_allclose(dc.numpy(),
                                   np.asarray(want_grads[2][l][0]),
                                   err_msg="dc0 of layer %d" % l, **TOL)
        np.testing.assert_allclose(dh.numpy(),
                                   np.asarray(want_grads[2][l][1]),
                                   err_msg="dh0 of layer %d" % l, **TOL)


WIDE_CONFIG = dict(nnet_type="lstm", input_dim=4, left_context=1,
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


def test_wide_train_step_matches_jax(jref, monkeypatch):
    """A 2-layer lstm of 1024 cells with 256-wide projections (layer 1
    residual) and the MoE head: the loss and every parameter after one
    adam step, from the JAX package's initial weights through the bridge;
    the port's step runs the stack (K12 and K13's plain versions), the JAX
    package's its per-layer scan on the CPU."""
    from lstm_ctc_tpu.models import init_model as jax_init_model
    from lstm_ctc_tpu.train.graph import make_train_step as jax_train_step
    from lstm_ctc_tpu_torch.train.checkpoint import tree_map
    from lstm_ctc_tpu_torch.train.graph import make_train_step, param_leaves
    jax, jnp = jref.jax, jref.jnp
    batch = labeled_batch()
    jparams, jstate = jax_init_model(jax.random.PRNGKey(3), WIDE_CONFIG)
    init, step = jax_train_step(WIDE_CONFIG, LEARN_RATE, "adam")
    ref = jax.tree.map(jnp.array, jparams)
    ref, _, _, ref_metrics = step(
        ref, init(ref), jstate, jax.random.PRNGKey(0),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = tree_map(lambda t: t.requires_grad_(), params_from_numpy(
        jax.tree.map(np.asarray, jparams)))
    assert params["layers"][1]["wx"].shape == (PROJ, 4 * UNITS)
    calls = []
    backward = sk.stack_backward_reference

    def spy(*args, **kwargs):
        calls.append(args[2].shape)
        return backward(*args, **kwargs)

    monkeypatch.setattr(sk, "stack_backward_reference", spy)
    port_init, port_step = make_train_step(WIDE_CONFIG, LEARN_RATE, "adam")
    params, _, _, metrics = port_step(
        params, port_init(params), {}, None,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert calls == [(2, 2 * PROJ, 4 * UNITS)]   # the stack's wz
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(ref_metrics["loss"]), rtol=1e-4,
                               atol=1e-4)
    want = param_leaves(params_from_numpy(jax.tree.map(np.asarray, ref)))
    got = param_leaves(params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_wide_streaming_matches_offline():
    """The streaming session (the stack's plain version with carried
    states, chunks of 5 model rows, raw frames fed 7 at a time) equals the
    offline forward at H = 1024, P = 256."""
    streaming_matches_offline(dict(WIDE_CONFIG, num_experts=0, num_layers=3))


def test_sak_lstmp_streaming_matches_offline():
    """The same at H = 2048, P = 512 (2 layers)."""
    streaming_matches_offline(dict(WIDE_CONFIG, num_experts=0, num_layers=2,
                                   num_neurons=SAK_UNITS,
                                   num_projects=SAK_PROJ))


def streaming_matches_offline(config):
    from lstm_ctc_tpu_torch.host.data import splice_frames, subsample_frames
    from lstm_ctc_tpu_torch.models import apply_model, init_model
    from lstm_ctc_tpu_torch.models.streaming import StreamingSession
    params, state = init_model(torch.Generator().manual_seed(4), config)
    raw = np.random.RandomState(4).randn(40, 4).astype(np.float32)
    session = StreamingSession(params, state, config, chunk_size=5)
    chunks = [session.process(raw[i:i + 7]) for i in range(0, len(raw), 7)]
    chunks.append(session.process(None, flush=True))
    got = np.concatenate(chunks)
    feats = subsample_frames(splice_frames(raw, 1, 1), 3)
    with torch.no_grad():
        want = apply_model(params, state, torch.from_numpy(feats[None]),
                           torch.tensor([feats.shape[0]], dtype=torch.int32),
                           config)[0][0].numpy()
    assert got.shape == want.shape == (13, 7)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
def test_routed_stack_keeps_the_kernels_dropout(monkeypatch, train):
    """A uniform stack that the route runs layer by layer (here a plan
    refusal, faked) draws one seed from the generator, as the stack path
    does, and applies the hash mask K12 applies (row s·L·B + l·B + b at s =
    t + l, column p): at keep 0.9 it equals the plain K12 with that seed
    (and under autograd, its gradients equal the stack's)."""
    params = wide_stack(5, layers=3)
    x, seq = (torch.from_numpy(a) for a in wide_inputs(5))
    flags = [False, True, True]
    refused = []

    def refuse(*args, **kwargs):
        refused.append(len(args[0]))
        return False

    def run(route):
        cells_ = [{k: v.detach().clone().requires_grad_(train)
                   for k, v in p.items()} for p in params]
        gen = torch.Generator().manual_seed(11)
        with monkeypatch.context() as m:
            if route:
                m.setattr(lstm_model, "stack_eligible", refuse)
            with torch.set_grad_enabled(train):
                out, _ = lstm_model.stack_layers(
                    cells_, x, seq, flags, torch.float32, torch.float32,
                    keep_prob=0.9, generator=gen)
        grads = torch.autograd.grad(torch.sin(out).sum(), [
            t for c in cells_ for t in c.values()]) if train else ()
        return out.detach(), grads

    got, got_grads = run(route=True)
    assert refused == [3]
    seed = cells.draw_seed(torch.Generator().manual_seed(11), "cpu")
    with torch.no_grad():
        want, _ = sk.lstm_stack_fused(
            params, x, seq, lstm_model.FORGET_BIAS, residual_flags=flags,
            compute_dtype=torch.float32, keep_prob=0.9, seed=seed)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    drop = sk.layer_drop_factors(seed, 0.9, x.shape[1], 3, x.shape[0], PROJ,
                                 "cpu")
    assert bool((drop == 0).any()) and bool((drop > 0).any())
    # the stack path, from the same generator seed
    stacked, stacked_grads = run(route=False)
    np.testing.assert_allclose(got.numpy(), stacked.numpy(), **TOL)
    for g, w in zip(got_grads, stacked_grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
