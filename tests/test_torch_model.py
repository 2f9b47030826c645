"""The port's whole model against JAX ``apply_model(train=False)`` (CPU).

The flagship's shape (residual projected BLSTM, peepholes, MoE head) at a
small width, with the same weights on both sides through the checkpoint
bridge.  Tolerance 1e-4 on logits: error builds up over the layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_ctc_tpu.models import apply_model as jax_apply_model
from lstm_ctc_tpu.models import init_model as jax_init_model
from lstm_ctc_tpu_torch.models import apply_model, init_model
from lstm_ctc_tpu_torch.models.blstm import _compute_dtype
from lstm_ctc_tpu_torch.train.checkpoint import params_from_numpy

FLAGSHIP_SMALL = dict(nnet_type="blstm", input_dim=4, left_context=1,
                      right_context=1, subsample=3, num_layers=2,
                      num_neurons=16, num_projects=8, num_targets=7,
                      use_peepholes=True, dropout_rate=0.9, num_experts=4,
                      moe_temp=10.0, seed=777)
TOL = dict(rtol=1e-4, atol=1e-4)


def batch(config, seed=0, size=3, time_steps=20, packed=False):
    rng = np.random.RandomState(seed)
    dim = config["input_dim"] * (1 + config.get("left_context", 0)
                                 + config.get("right_context", 0))
    x = rng.randn(size, time_steps, dim).astype(np.float32)
    seq_len = np.array([time_steps] + list(rng.randint(
        time_steps // 2, time_steps, size - 1)), np.int32)
    reset = None
    if packed:
        reset = np.zeros((size, time_steps), np.float32)
        reset[:, 0] = 1.0
        reset[0, 7] = reset[1, 4] = 1.0
    return x, seq_len, reset


def run_both(config, x, seq_len, reset=None):
    jparams, jstate = jax_init_model(jax.random.PRNGKey(3), config)
    ref = jax_apply_model(jparams, jstate, jnp.asarray(x),
                          jnp.asarray(seq_len), config, train=False,
                          reset_mask=None if reset is None
                          else jnp.asarray(reset))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    got = apply_model(params, {}, torch.from_numpy(x),
                      torch.from_numpy(seq_len), config,
                      reset_mask=None if reset is None
                      else torch.from_numpy(reset))
    return got, ref


@pytest.mark.parametrize("variant", [
    {},                                             # flagship shape
    {"num_experts": 0},                             # dense head
    {"left_context": 0, "right_context": 0,         # layer-0 residual:
     "input_dim": 16},                              # input == 2 * proj
    {"num_projects": 0, "use_peepholes": False},
    {"uniform_label_sm": 0.5},
])
def test_logits_match_jax(variant):
    config = dict(FLAGSHIP_SMALL, **variant)
    x, seq_len, _ = batch(config)
    got, ref = run_both(config, x, seq_len)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **TOL,
                               err_msg="logits")
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **TOL,
                               err_msg="encoder")
    assert len(got[2]) == len(ref[2])
    for (gv, gw), (rv, rw) in zip(got[2], ref[2]):
        assert gw == rw
        np.testing.assert_allclose(float(gv), float(rv), rtol=1e-4)


def test_packed_rows_match_jax():
    x, seq_len, reset = batch(FLAGSHIP_SMALL, seed=1, packed=True)
    got, ref = run_both(FLAGSHIP_SMALL, x, seq_len, reset)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **TOL)


def test_prior_label_smoothing_matches_jax(tmp_path):
    counts = tmp_path / "counts"
    counts.write_text("[ 30 10 0 5 7 9 11 ]\n")
    config = dict(FLAGSHIP_SMALL, prior_label_sm=0.3,
                  prior_label_path=str(counts))
    x, seq_len, _ = batch(config, seed=2)
    got, ref = run_both(config, x, seq_len)
    np.testing.assert_allclose(float(got[2][0][0]), float(ref[2][0][0]),
                               rtol=1e-4)


def test_compute_dtype():
    assert _compute_dtype({}, "cpu") == torch.float32
    assert _compute_dtype({}, "cuda") == torch.bfloat16
    assert _compute_dtype({"compute_dtype": "float32"}, "cuda") \
        == torch.float32
    assert _compute_dtype({"compute_dtype": "bf16"}, "cpu") \
        == torch.bfloat16


def test_bf16_on_cpu_stays_close_to_f32():
    config = dict(FLAGSHIP_SMALL)
    x, seq_len, _ = batch(config, seed=4)
    params, state = init_model(torch.Generator().manual_seed(0), config)
    args = (params, state, torch.from_numpy(x), torch.from_numpy(seq_len))
    f32 = apply_model(*args, config)[0]
    bf16 = apply_model(*args, dict(config, compute_dtype="bfloat16"))[0]
    assert bf16.dtype == torch.float32
    assert 0.0 < float((bf16 - f32).abs().max()) < 0.5


@pytest.mark.parametrize("nnet_type", ["lstm", "cudnnlstm"])
def test_unidirectional_families_run(nnet_type):
    """The unidirectional families build and run (their parity with JAX is
    in tests/test_torch_lstm_family.py)."""
    config = dict(FLAGSHIP_SMALL, nnet_type=nnet_type, num_experts=0)
    params, state = init_model(torch.Generator().manual_seed(0), config)
    x, seq_len, _ = batch(config)
    logits, encoder, reg, new_state = apply_model(
        params, state, torch.from_numpy(x), torch.from_numpy(seq_len),
        config)
    assert logits.shape == (3, 20, 7) and encoder is None and reg == []
    assert bool(torch.isfinite(logits).all())
    assert new_state == state


def test_training_mode_raises():
    """The MoE model trains (its head's dropout and backward are ported).
    Once the single-kernel weight gradient (K7) raised; now it trains too,
    with the default mode's gradient, and an unknown mode raises."""
    params, state = init_model(torch.Generator().manual_seed(0),
                               FLAGSHIP_SMALL)
    params["moe"]["w_expert"].requires_grad_()
    x, seq_len, _ = batch(FLAGSHIP_SMALL)
    args = (params, state, torch.from_numpy(x), torch.from_numpy(seq_len))
    logits = apply_model(*args, FLAGSHIP_SMALL, train=True,
                         generator=torch.Generator().manual_seed(1))[0]
    (grad,) = torch.autograd.grad(logits.sum(), params["moe"]["w_expert"])
    assert bool(torch.isfinite(grad).all()) and bool((grad != 0).any())
    with torch.no_grad():
        assert not torch.equal(logits, apply_model(*args, FLAGSHIP_SMALL)[0])
    config = dict(FLAGSHIP_SMALL, dropout_rate=1.0)
    grads = []
    for mode in ("xla", "kernel"):
        logits = apply_model(*args, dict(config, moe_wgrad_mode=mode),
                             train=True)[0]
        grads += torch.autograd.grad(logits.sum(), params["moe"]["w_expert"])
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="wgrad_mode"):
        apply_model(*args, dict(FLAGSHIP_SMALL, moe_wgrad_mode="fold"),
                    train=True)
