"""The unidirectional families (``lstm``, ``cudnnlstm``; ``models/lstm.py``)
against the JAX package on the CPU.

The same weights on both sides through the checkpoint bridge, inputs from
a numpy seed.  Tolerance 1e-4 (error builds up over the layers; adam moves
each weight by about the learning rate whatever the gradient's size):
``apply_model`` logits in evaluation and in training at keep 1.0 (with the
batch-norm ``new_state``), for a uniform stack (the stack kernels' plain
versions), a stack that is not uniform and an odd batch (the layer
kernels' plain versions, two half-batches as the two directions, a pad
row), an MoE head; the parameters after 1 and 3 adam steps against
``make_train_step``; a checkpoint's batch-norm ``state/`` leaves written
by either package and read by the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_ctc_tpu.models import apply_model as jax_apply_model
from lstm_ctc_tpu.models import init_model as jax_init_model
from lstm_ctc_tpu.train import checkpoint as jax_checkpoint
from lstm_ctc_tpu.train.graph import make_train_step as jax_make_train_step
from lstm_ctc_tpu_torch.models import apply_model, init_model
from lstm_ctc_tpu_torch.ops import lstm_stack_kernels
from lstm_ctc_tpu_torch.train import checkpoint
from lstm_ctc_tpu_torch.train.checkpoint import params_from_numpy, tree_map
from lstm_ctc_tpu_torch.train.graph import make_train_step, param_leaves

LSTM = dict(nnet_type="lstm", input_dim=4, left_context=1, right_context=1,
            subsample=3, num_layers=3, num_neurons=16, num_projects=8,
            num_targets=7, use_peepholes=True, dropout_rate=1.0,
            num_experts=0, seed=777, store_dtype="float32")
FAMILIES = {
    "lstm": LSTM,
    "cudnnlstm": dict(LSTM, nnet_type="cudnnlstm", num_projects=0,
                      use_peepholes=False),
    "lstm_bn": dict(LSTM, use_bn=True),
}
TOL = dict(rtol=1e-4, atol=1e-4)


def batch(config, seed=0, size=4, time_steps=14):
    rng = np.random.RandomState(seed)
    dim = config["input_dim"] * (1 + config.get("left_context", 0)
                                 + config.get("right_context", 0))
    x = rng.randn(size, time_steps, dim).astype(np.float32)
    seq = np.array([time_steps] + list(rng.randint(
        time_steps // 2, time_steps, size - 1)), np.int32)
    return x, seq


def jax_model(config, seed=3):
    """JAX weights and state, the batch-norm moments made non-trivial."""
    params, state = jax_init_model(jax.random.PRNGKey(seed), config)
    if config.get("use_bn"):
        rs = np.random.RandomState(seed)
        for bn in list(state["bn"]) + [state["bn_in"]]:
            dim = bn["mean"].shape[0]
            bn["mean"] = jnp.asarray(rs.randn(dim) * 0.3, jnp.float32)
            bn["var"] = jnp.asarray(0.5 + rs.rand(dim), jnp.float32)
        for bn in list(params["bn"]) + [params["bn_in"]]:
            dim = bn["scale"].shape[0]
            bn["scale"] = jnp.asarray(0.5 + rs.rand(dim), jnp.float32)
            bn["offset"] = jnp.asarray(rs.randn(dim) * 0.2, jnp.float32)
    return params, state


def port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def assert_tree_close(got, want, what):
    got_leaves = list(checkpoint.leaves_with_path(got))
    want_leaves = list(checkpoint.leaves_with_path(port(want)))
    assert [k for k, _ in got_leaves] == [k for k, _ in want_leaves]
    for (key, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), **TOL,
                                   err_msg="%s %s" % (what, key))


@pytest.mark.parametrize("variant", [
    "lstm", "cudnnlstm", "lstm_bn",
    "moe",            # MoE head
    "one_layer",      # not uniform: a single layer
    "layer0_residual",  # not uniform: input as wide as the output
    "odd_batch",      # a stack, an odd batch
])
@pytest.mark.parametrize("train", [False, True])
def test_logits_match_jax(variant, train):
    config = FAMILIES.get(variant, LSTM)
    size = 3 if variant == "odd_batch" else 4
    if variant == "moe":
        config = dict(LSTM, num_experts=3)
    elif variant == "one_layer":
        config = dict(LSTM, num_layers=1)
    elif variant == "layer0_residual":
        config = dict(LSTM, left_context=0, right_context=0, input_dim=8,
                      use_bn=True)
    x, seq = batch(config, size=size)
    jparams, jstate = jax_model(config)
    ref = jax_apply_model(jparams, jstate, jnp.asarray(x), jnp.asarray(seq),
                          config, train=train)
    params = port(jparams)
    if train:
        params = tree_map(lambda t: t.requires_grad_(), params)
    got = apply_model(params, port(jstate), torch.from_numpy(x),
                      torch.from_numpy(seq), config, train=train)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(ref[0]),
                               **TOL)
    assert got[1] is None and got[2] == []
    assert_tree_close(got[3], ref[3], "new_state")


def test_uniform_stack_uses_the_stack_kernels(monkeypatch):
    calls = []
    forward = lstm_stack_kernels.lstm_stack_forward

    def spy(*args, **kwargs):
        calls.append(kwargs.get("affine") is not None)
        return forward(*args, **kwargs)

    monkeypatch.setattr(lstm_stack_kernels, "lstm_stack_forward", spy)
    for config in (LSTM, FAMILIES["lstm_bn"]):
        params, state = init_model(torch.Generator().manual_seed(0), config)
        x, seq = batch(config)
        apply_model(params, state, torch.from_numpy(x),
                    torch.from_numpy(seq), config)
    assert calls == [False, True]


def labeled_batch(config, seed=0, size=3, time_steps=14, max_u=4):
    x, _ = batch(config, seed, size, time_steps)
    rng = np.random.RandomState(seed)
    targets = rng.randint(0, config["num_targets"] - 1,
                          (size, max_u)).astype(np.int32)
    target_length = np.array([4, 3, 2], np.int32)[:size]
    for b in range(size):
        targets[b, target_length[b]:] = -1
    return {"nnet_input": x,
            "sequence_length": np.array([14, 10, 8], np.int32)[:size],
            "nnet_target": targets, "target_length": target_length}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_matches_jax(family):
    config = FAMILIES[family]
    data = labeled_batch(config)
    jparams, jstate = jax_model(config, seed=4)
    init, step = jax_make_train_step(config, 1e-2, "adam")
    ref = jax.tree.map(jnp.array, jparams)
    ref_opt = init(ref)
    params = tree_map(lambda t: t.requires_grad_(), port(jparams))
    state = port(jstate)
    port_init, port_step = make_train_step(config, 1e-2, "adam")
    opt_state = port_init(params)
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}
    for i in range(3):
        ref, ref_opt, jstate, ref_metrics = step(
            ref, ref_opt, jstate, jax.random.PRNGKey(i),
            {k: jnp.asarray(v) for k, v in data.items()})
        params, opt_state, state, metrics = port_step(
            params, opt_state, state, torch.Generator().manual_seed(i),
            tbatch)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(ref_metrics["loss"]), **TOL)
        if i in (0, 2):
            ref_leaves = param_leaves(port(ref))
            for got, want in zip(param_leaves(params), ref_leaves):
                np.testing.assert_allclose(got.detach().numpy(),
                                           want.numpy(), **TOL)
            assert_tree_close(state, jstate, "state")


def test_checkpoint_bn_state_round_trip(tmp_path):
    config = FAMILIES["lstm_bn"]
    jparams, jstate = jax_model(config, seed=5)
    jax_path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_checkpoint(jax_path, jparams, jstate)
    with np.load(jax_path) as data:
        keys = set(data.files)
    assert {"state/bn_in/mean", "state/bn_in/var", "state/bn/0/mean",
            "state/bn/2/var"} <= keys
    template, template_state = init_model(torch.Generator().manual_seed(0),
                                          config)
    params, state, _ = checkpoint.load_checkpoint(jax_path, template,
                                                  template_state)
    assert_tree_close(params, jparams, "params")
    assert_tree_close(state, jstate, "state")
    port_path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(port_path, params, state)
    jtemplate, jtemplate_state = jax_init_model(jax.random.PRNGKey(0),
                                                config)
    back, back_state, _ = jax_checkpoint.load_checkpoint(
        port_path, jtemplate, jtemplate_state)
    assert_tree_close(params, back, "params back")
    assert_tree_close(state, back_state, "state back")


@pytest.mark.parametrize("family", ["lstm", "cudnnlstm"])
def test_packed_rows_are_refused(family):
    config = FAMILIES[family]
    params, state = init_model(torch.Generator().manual_seed(0), config)
    x, seq = batch(config)
    with pytest.raises(NotImplementedError, match="packed rows"):
        apply_model(params, state, torch.from_numpy(x), torch.from_numpy(seq),
                    config, reset_mask=torch.zeros(x.shape[:2]))


@pytest.mark.parametrize("family", ["lstm", "lstm_bn"])
def test_dropout_training_runs(family):
    """keep 0.9: the stack's hash dropout (or the per-layer dropout with
    batch norm) and its gradients; the same generator seed repeats."""
    config = dict(FAMILIES[family], dropout_rate=0.9, num_experts=3)
    params, state = init_model(torch.Generator().manual_seed(0), config)
    params = tree_map(lambda t: t.requires_grad_(), params)
    x, seq = (torch.from_numpy(a) for a in batch(config))

    def run(seed):
        logits = apply_model(params, state, x, seq, config, train=True,
                             generator=torch.Generator().manual_seed(seed))[0]
        return logits, torch.autograd.grad(logits.square().sum(),
                                           param_leaves(params))

    a, grads = run(1)
    b, _ = run(1)
    assert torch.equal(a, b)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with torch.no_grad():
        assert not torch.equal(a, apply_model(params, state, x, seq,
                                              config)[0])
