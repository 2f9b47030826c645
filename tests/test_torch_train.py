"""The port's training path on the CPU (``train/graph``, ``train/loop``, the
``nnet_init`` / ``nnet_train`` / ``nnet_validate`` CLIs).

The train step is held against the JAX package's ``make_train_step`` on
the same weights and batch, at keep 1.0 and store float32: the loss, and
the parameters after 1 and 3 steps of adam, sgd and momentum, at
rtol = atol = 1e-4 (float32 on both sides; adam's first steps move each
weight by about the learning rate whatever the gradient's size, so a
rounding difference in a gradient shows in full).  The MoE-head model's
step is held to JAX's the same way (through the JAX package's fused mix
in interpret mode), in both of the port's weight-gradient modes; its
keep-0.9 step gives finite gradients and repeats under the same seed.  A CLI run writes a
checkpoint the JAX package loads, and loads one the JAX package wrote.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_ctc_tpu.config import format_config
from lstm_ctc_tpu.models import init_model as jax_init_model
from lstm_ctc_tpu.train import checkpoint as jax_checkpoint
from lstm_ctc_tpu.train.graph import _clip_by_global_norm as jax_clip
from lstm_ctc_tpu.train.graph import _l2_loss as jax_l2_loss
from lstm_ctc_tpu.train.graph import make_train_step as jax_make_train_step
from lstm_ctc_tpu_torch.bin import nnet_init, nnet_train, nnet_validate
from lstm_ctc_tpu_torch.cli import build_batcher, make_shard_fn
from lstm_ctc_tpu_torch.host.data import RecordShardWriter, iterate_batches
from lstm_ctc_tpu_torch.models.cells import dropout
from lstm_ctc_tpu_torch.train.checkpoint import params_from_numpy, tree_map
from lstm_ctc_tpu_torch.train.graph import (clip_by_global_norm,
                                            compute_losses, l2_loss,
                                            make_train_step, param_leaves)

CONFIG = dict(nnet_type="blstm", input_dim=4, left_context=1,
              right_context=1, subsample=3, num_layers=2, num_neurons=16,
              num_projects=8, num_targets=7, use_peepholes=True,
              dropout_rate=1.0, num_experts=0, seed=777,
              store_dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)


def labeled_batch(seed=0, batch=3, time_steps=14, max_u=4):
    rng = np.random.RandomState(seed)
    dim = CONFIG["input_dim"] * 3
    targets = rng.randint(0, CONFIG["num_targets"] - 1,
                          (batch, max_u)).astype(np.int32)
    target_length = np.array([4, 3, 2], np.int32)[:batch]
    for b in range(batch):
        targets[b, target_length[b]:] = -1
    return {"nnet_input": rng.randn(batch, time_steps, dim).astype(
                np.float32),
            "sequence_length": np.array([14, 10, 8], np.int32)[:batch],
            "nnet_target": targets, "target_length": target_length}


def jax_params(seed=3):
    return jax_init_model(jax.random.PRNGKey(seed), CONFIG)


def port_params(jparams):
    return tree_map(lambda t: t.requires_grad_(),
                    params_from_numpy(jax.tree.map(np.asarray, jparams)))


def assert_params_close(port, ref):
    ref_leaves = param_leaves(params_from_numpy(
        jax.tree.map(np.asarray, ref)))
    for got, want in zip(param_leaves(port), ref_leaves):
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("optimizer", ["adam", "sgd", "momentum"])
def test_train_step_matches_jax(optimizer):
    batch = labeled_batch()
    jparams, jstate = jax_params()
    init, step = jax_make_train_step(CONFIG, 1e-2, optimizer)
    ref = jax.tree.map(jnp.array, jparams)
    ref_opt = init(ref)
    params = port_params(jparams)
    port_init, port_step = make_train_step(CONFIG, 1e-2, optimizer)
    opt_state = port_init(params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(3):
        ref, ref_opt, jstate, ref_metrics = step(
            ref, ref_opt, jstate, jax.random.PRNGKey(i),
            {k: jnp.asarray(v) for k, v in batch.items()})
        params, opt_state, _, metrics = port_step(params, opt_state, {},
                                                  None, tbatch)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(ref_metrics["loss"]), **TOL)
        assert int(metrics["size"]) == int(ref_metrics["size"])
        if i in (0, 2):
            assert_params_close(params, ref)


MOE_CONFIG = dict(CONFIG, num_experts=3, moe_temp=10.0)


@pytest.mark.parametrize("wgrad_mode", ["xla", "twokernel"])
def test_moe_train_step_matches_jax(wgrad_mode):
    batch = labeled_batch(1)
    jparams, jstate = jax_init_model(jax.random.PRNGKey(4), MOE_CONFIG)
    init, step = jax_make_train_step(MOE_CONFIG, 1e-2, "adam")
    ref = jax.tree.map(jnp.array, jparams)
    ref_opt = init(ref)
    params = port_params(jparams)
    assert sorted(params["moe"]) == ["b_expert", "b_prior", "w_expert",
                                     "w_prior"]
    port_init, port_step = make_train_step(
        dict(MOE_CONFIG, moe_wgrad_mode=wgrad_mode), 1e-2, "adam")
    opt_state = port_init(params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(3):
        ref, ref_opt, jstate, ref_metrics = step(
            ref, ref_opt, jstate, jax.random.PRNGKey(i),
            {k: jnp.asarray(v) for k, v in batch.items()})
        params, opt_state, _, metrics = port_step(params, opt_state, {},
                                                  None, tbatch)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(ref_metrics["loss"]), **TOL)
        if i in (0, 2):
            assert_params_close(params, ref)


def test_moe_dropout_step_is_finite_and_repeats():
    """keep 0.9: gate and expert dropout in the head (and after each
    layer); the same generator seed gives the same loss and gradients."""
    jparams, _ = jax_init_model(jax.random.PRNGKey(4), MOE_CONFIG)
    tbatch = {k: torch.from_numpy(v) for k, v in labeled_batch(2).items()}
    config = dict(MOE_CONFIG, dropout_rate=0.9)

    def grads(seed, cfg=config):
        params = port_params(jparams)
        metrics, _, _ = compute_losses(
            params, {}, tbatch, cfg, train=True,
            generator=torch.Generator().manual_seed(seed))
        total = metrics["loss"] + 1e-5 * l2_loss(params)
        return float(total.detach()), torch.autograd.grad(
            total, param_leaves(params))

    loss, g = grads(5)
    again, g_again = grads(5)
    assert np.isfinite(loss) and all(torch.isfinite(t).all() for t in g)
    assert again == loss
    assert all(torch.equal(a, b) for a, b in zip(g, g_again))
    assert grads(6)[0] != loss
    assert grads(5, MOE_CONFIG)[0] != loss


def test_l2_covers_the_moe_head():
    """No MoE leaf is named "bias", so all four are regularized, as in the
    reference."""
    jparams, _ = jax_init_model(jax.random.PRNGKey(4), MOE_CONFIG)
    params = port_params(jparams)
    with torch.no_grad():
        for name in ("w_prior", "b_prior", "w_expert", "b_expert"):
            params["moe"][name].fill_(0.5)
    want = sum(0.5 * float((v.detach() ** 2).sum())
               for direction in ("fwd", "bwd") for layer in params[direction]
               for k, v in layer.items() if k != "bias")
    want += sum(0.5 * 0.25 * v.numel() for v in params["moe"].values())
    got = float(l2_loss(params).detach())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ref = jax_l2_loss(jax.tree.map(
        lambda t: jnp.asarray(t.detach().numpy()), params))
    np.testing.assert_allclose(got, float(ref), rtol=1e-5)


def test_l2_regularizes_every_leaf_not_named_bias():
    jparams, _ = jax_params()
    params = port_params(jparams)
    want = 0.5 * float((params["head"]["w"].detach() ** 2).sum())
    for direction in ("fwd", "bwd"):
        for layer in params[direction]:
            want += sum(0.5 * float((v.detach() ** 2).sum())
                        for k, v in layer.items() if k != "bias")
    with torch.no_grad():
        params["head"]["b"].fill_(0.5)       # the head's b is regularized
        params["fwd"][0]["bias"].fill_(9.0)  # the cells' biases are not
    want += 0.5 * 0.25 * CONFIG["num_targets"]
    got = float(l2_loss(params).detach())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ref = jax_l2_loss(jax.tree.map(
        lambda t: jnp.asarray(t.detach().numpy()), params))
    np.testing.assert_allclose(got, float(ref), rtol=1e-5)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_uses_tf_formula(scale):
    """Below the clip norm nothing changes; above it every gradient is
    scaled by clip_norm / global_norm exactly (no epsilon)."""
    rng = np.random.RandomState(1)
    grads = [scale * rng.randn(*s).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2))]
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))
    clipped, got_norm = clip_by_global_norm(
        [torch.from_numpy(g) for g in grads], 5.0)
    ref, ref_norm = jax_clip([jnp.asarray(g) for g in grads], 5.0)
    np.testing.assert_allclose(float(got_norm), norm, rtol=1e-6)
    np.testing.assert_allclose(float(got_norm), float(ref_norm), rtol=1e-6)
    factor = min(1.0, 5.0 / norm)
    assert (norm < 5.0) == (scale < 1.0)
    for g, c, r in zip(grads, clipped, ref):
        np.testing.assert_allclose(c.numpy(), g * factor, rtol=1e-6)
        np.testing.assert_allclose(c.numpy(), np.asarray(r), rtol=1e-6)


def test_dropout_keep_semantics():
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(0)
    assert dropout(gen, x, 1.0) is x
    y = dropout(gen, x, 0.75)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / 0.75))
    again = dropout(torch.Generator().manual_seed(0), x, 0.75)
    assert torch.equal(again, y)


def write_corpus(work, count=10, seed=0):
    """Labeled records: 30-70 raw frames of 4-dim features, 2-6 labels."""
    rng = np.random.RandomState(seed)
    scp = os.path.join(work, "feats.scp")
    with RecordShardWriter(os.path.join(work, "feats.rec")) as writer:
        for i in range(count):
            frames = int(rng.randint(30, 71))
            labels = rng.randint(0, CONFIG["num_targets"] - 1,
                                 rng.randint(2, 7)).astype(np.int32)
            writer.write("utt%02d" % i, rng.randn(frames, 4).astype(
                np.float32), labels)
        with open(scp, "w") as fh:
            fh.write("".join(m.scp_line() for m in writer.metas))
    return scp


@pytest.mark.parametrize("rank_major", [True, False])
def test_packed_batches_match_unpacked(tmp_path, rank_major):
    """Over one epoch, packed rows (reset mask + per-utterance CTC view)
    give the unpacked rows' loss and gradient (float32)."""
    scp = write_corpus(str(tmp_path))
    jparams, _ = jax_params()
    shard = make_shard_fn(torch.device("cpu"))

    def epoch(pack_factor, config):
        params = port_params(jparams)
        total, grads = 0.0, None
        batcher = build_batcher(scp, config, 4, pack_factor=pack_factor)
        for batch in iterate_batches(batcher, shuffle=False):
            metrics, _, _ = compute_losses(params, {}, shard(batch), config,
                                           train=True)
            total += float(metrics["eval_loss"].detach())
            g = torch.autograd.grad(metrics["eval_loss"],
                                    param_leaves(params))
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        return total, grads

    packed_config = dict(CONFIG, packed_slots_rank_major=rank_major)
    loss, grads = epoch(1, CONFIG)
    packed_loss, packed_grads = epoch(3, packed_config)
    np.testing.assert_allclose(packed_loss, loss, **TOL)
    for a, b in zip(packed_grads, grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def log_value(text, name):
    lines = [ln for ln in text.splitlines() if ("%s = " % name) in ln]
    assert lines, "no %s line" % name
    return float(lines[-1].rsplit("=", 1)[1])


def test_cli_init_train_validate_on_cpu(tmp_path, capfd):
    work = str(tmp_path)
    scp = write_corpus(work, count=12)
    config = os.path.join(work, "nnet.config")
    with open(config, "w") as fh:
        fh.write(format_config(CONFIG))
    nnet0, nnet1 = (os.path.join(work, n) for n in ("nnet0.npz",
                                                   "nnet1.npz"))
    common = ["--objective", "ctc", "--device", "cpu", "--batch-size", "4"]
    nnet_init.main([scp, config, nnet0] + common)
    cv0 = log_value(capfd.readouterr().err, "cv_loss")
    nnet_train.main([scp, config, nnet0, nnet1, "--optimizer", "adam",
                     "--learn-rate", "1e-2", "--pack-factor", "3",
                     "--metrics-file", os.path.join(work, "m.jsonl")]
                    + common)
    err = capfd.readouterr().err
    tr = log_value(err, "tr_loss")
    assert 'saving nnet to "%s"' % nnet1 in err
    nnet_validate.main([scp, config, nnet1, "--evaluate", "true"] + common)
    err = capfd.readouterr().err
    cv1, cv_eval = log_value(err, "cv_loss"), log_value(err, "cv_eval")
    assert all(np.isfinite(v) for v in (cv0, tr, cv1, cv_eval))
    assert cv1 < cv0
    # the checkpoint loads in the JAX package, and JAX's in the port
    template, state = jax_init_model(jax.random.PRNGKey(0), CONFIG)
    loaded, _, _ = jax_checkpoint.load_checkpoint(nnet1, template, state)
    stored = np.load(nnet1)
    np.testing.assert_array_equal(np.asarray(loaded["head"]["w"]),
                                  stored["params/head/w"])
    jax_nnet = os.path.join(work, "jax.npz")
    jax_checkpoint.save_checkpoint(jax_nnet, loaded, state)
    nnet_validate.main([scp, config, jax_nnet] + common)
    np.testing.assert_allclose(
        log_value(capfd.readouterr().err, "cv_loss"), cv1, rtol=1e-6)


def test_cli_refuses_cuda_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nnet_validate.main(["x.scp", "nnet.config", "nnet.npz",
                            "--objective", "ctc"])
