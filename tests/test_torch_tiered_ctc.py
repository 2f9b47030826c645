"""The tiered CTC view of packed rows (``ctc_tiered_slots``;
``lstm_ctc_tpu_torch/train/graph.compute_losses``): each rank tier k of a
packed batch is gathered at width ⌈row_t/(k+1)⌉ and gets a CTC of its own.
At pack factors 2 and 3, on the same logits, its loss and the loss's
gradient to the logits equal the rank-major view's and the JAX package's
tiered view's, rtol = atol = 1e-5 in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lstm_ctc_tpu.train.graph as jax_graph
import lstm_ctc_tpu_torch.train.graph as graph
from lstm_ctc_tpu_torch.graft_entry import FLAGSHIP_CONFIG, _packed_batch

TOL = dict(rtol=1e-5, atol=1e-5)
CONFIG = dict(FLAGSHIP_CONFIG, input_dim=4, num_targets=7)


def packed(pf):
    batch = _packed_batch(CONFIG, num_rows=4, pack_factor=pf, rng_seed=pf)
    rows, row_t = batch["nnet_input"].shape[:2]
    logits = np.random.RandomState(pf).randn(
        rows, row_t, CONFIG["num_targets"]).astype(np.float32)
    return batch, logits


def port_loss_and_grad(batch, logits, tiered, monkeypatch):
    leaf = torch.from_numpy(logits).requires_grad_()
    monkeypatch.setattr(graph, "apply_model",
                        lambda *a, **k: (leaf, None, [], {}))
    config = dict(CONFIG, ctc_tiered_slots=tiered)
    metrics, _, _ = graph.compute_losses(
        {}, {}, {k: torch.from_numpy(v) for k, v in batch.items()}, config,
        train=True)
    grad, = torch.autograd.grad(metrics["loss"], leaf)
    return float(metrics["loss"]), grad.numpy()


def jax_loss_and_grad(batch, logits, monkeypatch):
    config = dict(CONFIG, ctc_tiered_slots=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(lg):
        monkeypatch.setattr(jax_graph, "apply_model",
                            lambda *a, **k: (lg, None, [], {}))
        metrics, _, _ = jax_graph.compute_losses({}, {}, jbatch, config,
                                                 train=True)
        return metrics["loss"]

    value, grad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(logits))
    return float(value), np.asarray(grad)


@pytest.mark.parametrize("pf", [2, 3])
def test_tiered_view_matches_rank_major_and_jax(pf, monkeypatch):
    batch, logits = packed(pf)
    assert jax_graph.ctc_tiered_enabled(dict(CONFIG, ctc_tiered_slots=True))
    assert graph.ctc_tiered_enabled(dict(CONFIG, ctc_tiered_slots=True))
    assert not graph.ctc_tiered_enabled(CONFIG)
    tiered = port_loss_and_grad(batch, logits, True, monkeypatch)
    full = port_loss_and_grad(batch, logits, False, monkeypatch)
    ref = jax_loss_and_grad(batch, logits, monkeypatch)
    assert np.isfinite(tiered[0]) and tiered[0] > 0
    np.testing.assert_allclose(tiered[0], full[0], **TOL)
    np.testing.assert_allclose(tiered[1], full[1], **TOL)
    np.testing.assert_allclose(tiered[0], ref[0], **TOL)
    np.testing.assert_allclose(tiered[1], ref[1], **TOL)


def test_tiered_view_launches_one_ctc_a_tier(monkeypatch):
    batch, logits = packed(3)
    calls = []
    real = graph.ctc_loss

    def counted(view, *args):
        calls.append(tuple(view.shape))
        return real(view, *args)

    monkeypatch.setattr(graph, "ctc_loss", counted)
    port_loss_and_grad(batch, logits, True, monkeypatch)
    row_t = batch["nnet_input"].shape[1]
    assert calls == [(4, -(-row_t // (k + 1)), 7) for k in range(3)]
