"""Train and eval steps: the compute-graph layer.

Counterpart of ``lstm_ctc_tpu/train/graph.py`` (the reference's
nnet/graph.py:51-209):

  * ``eval_loss`` = summed per-sequence CTC loss over the batch;
  * ``size`` = count of real (non-pad) target labels, the normalizer of the
    outer loop's running mean;
  * ``loss`` = eval_loss + active label-smoothing regularizers;
  * training adds L2 (0.5·Σv²) × 1e-5 over parameters with no path key
    equal to "bias": the head's ``b`` is regularized, as in the reference,
    where only the LSTM cell biases are named "bias";
  * gradients are clipped by global norm with TF's formula and applied by
    adam / sgd / momentum(0.9).

PyTorch runs eagerly: a step is the model forward, the CTC loss,
``torch.autograd.grad`` and an in-place update of the parameter tensors.
Packed batches use the row-batched rank-major view (the default under
``packed_slots_rank_major``), its opt-in tiered form (``ctc_tiered_slots``)
or the flat gather.

Under data parallelism (``parallel/mesh.py``) a device batch carries its
``parallel.Shard``: each rank computes its rows' loss and gradients, the
gradients and metrics are summed over the ranks (``parallel.combine``), and
the L2 term's gradient is added once after that, so the clip and the
optimizer see the global gradient and every rank stays equal.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .. import parallel
from ..models import apply_model
from ..models.cells import DropoutStreams
from ..ops.ctc import ctc_loss
from .checkpoint import leaves_with_path


def param_leaves(params) -> List[torch.Tensor]:
    """The parameter tensors, in the order of ``leaves_with_path``."""
    return [leaf for _, leaf in leaves_with_path(params)]


def _l2_leaf(key: str) -> bool:
    return "bias" not in key.split("/")


def l2_loss(params) -> torch.Tensor:
    """0.5·Σv² over the leaves with no path key equal to "bias"
    (``graph._l2_loss``)."""
    terms = [0.5 * torch.sum(leaf * leaf)
             for key, leaf in leaves_with_path(params) if _l2_leaf(key)]
    return torch.stack(terms).sum()


def l2_grads(params, weight: float) -> List:
    """The gradient of ``weight``·``l2_loss``: weight·v on its leaves,
    None on the others."""
    return [weight * leaf.detach() if _l2_leaf(key) else None
            for key, leaf in leaves_with_path(params)]


def clip_by_global_norm(grads: List[torch.Tensor], clip_norm: float):
    """``tf.clip_by_global_norm``: every gradient times
    min(1, clip_norm / max(global_norm, 1e-20)); returns (grads, norm)."""
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-20), max=1.0)
    return [g * scale for g in grads], norm


class Optimizer:
    """adam (TF1 defaults: 0.9, 0.999, eps 1e-8), sgd, or momentum 0.9,
    with optax's arithmetic (``graph.get_optimizer``).  ``init`` makes the
    state; ``update`` changes the parameters in place."""

    def __init__(self, name: str, learn_rate: float, momentum: float = 0.9):
        if name not in ("adam", "sgd", "momentum"):
            raise ValueError("unsupported optimizer: %s" % name)
        self.name, self.learn_rate, self.momentum = name, learn_rate, momentum

    def init(self, leaves: List[torch.Tensor]) -> Dict:
        zeros = [torch.zeros_like(p) for p in leaves]
        if self.name == "adam":
            return {"count": 0, "mu": zeros,
                    "nu": [torch.zeros_like(p) for p in leaves]}
        if self.name == "momentum":
            return {"trace": zeros}
        return {}

    @torch.no_grad()
    def update(self, leaves, grads, state: Dict) -> None:
        lr = self.learn_rate
        if self.name == "sgd":
            for p, g in zip(leaves, grads):
                p.sub_(lr * g)
        elif self.name == "momentum":
            for p, g, t in zip(leaves, grads, state["trace"]):
                t.mul_(self.momentum).add_(g)
                p.sub_(lr * t)
        else:
            b1, b2, eps = 0.9, 0.999, 1e-8
            state["count"] += 1
            c1 = 1.0 - b1 ** state["count"]
            c2 = 1.0 - b2 ** state["count"]
            for p, g, mu, nu in zip(leaves, grads, state["mu"], state["nu"]):
                mu.mul_(b1).add_((1.0 - b1) * g)
                nu.mul_(b2).add_((1.0 - b2) * (g * g))
                p.sub_(lr * ((mu / c1) / (torch.sqrt(nu / c2) + eps)))


def get_optimizer(name: str, learn_rate: float,
                  momentum: float = 0.9) -> Optimizer:
    return Optimizer(name, learn_rate, momentum)


def _row_relative_slots(batch: Dict, num_rows: int, row_t: int, pf: int):
    """The flat ``utt_time_index`` rebased to row-relative time indices,
    ``[pf, B, T_u]``, under the rank-major slot contract (slot k·B + r
    reads row r)."""
    index = batch["utt_time_index"].long()
    n_slots, t_u = index.shape
    row_ids = torch.arange(n_slots, device=index.device) % num_rows
    rel = (index - row_ids[:, None] * row_t).clamp(0, row_t - 1)
    return rel.reshape(pf, num_rows, t_u)


def ctc_tiered_enabled(config: Dict) -> bool:
    """The opt-in rank-tier CTC gather (``ctc_tiered_slots`` in
    nnet.config; the reference also reads a TPU environment variable,
    which means nothing here)."""
    return str(config.get("ctc_tiered_slots", "") or "") in (
        "1", "true", "True")


def compute_losses(params, net_state, batch: Dict, config: Dict,
                   train: bool, generator=None) -> Tuple[Dict, torch.Tensor,
                                                         Dict]:
    """The shared forward → (metrics, logits, net_state).  ``batch`` is a
    dict of tensors on the device (``cli.make_shard_fn``); under data
    parallelism it holds this rank's rows and their ``parallel.Shard``,
    and the metrics are this rank's."""
    shard = batch.get(parallel.SHARD_KEY)
    if (shard is not None and not shard.split
            and isinstance(generator, DropoutStreams)):
        generator = generator.whole()   # every rank computes it alike
    logits, _, reg_losses, new_state = apply_model(
        params, net_state, batch["nnet_input"], batch["sequence_length"],
        config, train=train, generator=generator,
        reset_mask=batch.get("reset_mask"), shard=shard)
    if "utt_time_index" in batch:
        num_rows, row_t, vocab = logits.shape
        n_slots = batch["utt_time_index"].shape[0]
        pf = n_slots // num_rows
        rank_major = (bool(config.get("packed_slots_rank_major"))
                      and pf >= 1 and n_slots == pf * num_rows)
        if rank_major and pf >= 2 and ctc_tiered_enabled(config):
            # slot k·B + r holds row r's (k+1)-th longest utterance, at
            # most ⌈row_t/(k+1)⌉ frames: each rank tier is gathered at that
            # width and gets a CTC of its own (row-local: under data
            # parallelism it runs on this rank's rows)
            rel3 = _row_relative_slots(batch, num_rows, row_t, pf)
            parts = []
            for k in range(pf):
                width = -(-row_t // (k + 1))
                sl = slice(k * num_rows, (k + 1) * num_rows)
                index = rel3[k, :, :width, None].expand(-1, -1, vocab)
                parts.append(ctc_loss(
                    torch.gather(logits, 1, index),
                    batch["utt_sequence_length"][sl],
                    batch["nnet_target"][sl], batch["target_length"][sl]))
            per_seq = torch.cat(parts)
        elif rank_major:
            rel3 = _row_relative_slots(batch, num_rows, row_t, pf)
            # [B, pf, T_u, V]: a gather along time, rows aligned; slots
            # fold out row-major (per_seq is only summed, so the order
            # does not change the loss)
            index = rel3.transpose(0, 1)[..., None].expand(-1, -1, -1, vocab)
            view = torch.gather(logits[:, None].expand(-1, pf, -1, -1), 2,
                                index).reshape(n_slots, -1, vocab)

            def row_major(a):
                return (a.reshape((pf, num_rows) + a.shape[1:])
                        .transpose(0, 1).reshape((n_slots,) + a.shape[1:]))

            per_seq = ctc_loss(view, row_major(batch["utt_sequence_length"]),
                               row_major(batch["nnet_target"]),
                               row_major(batch["target_length"]))
        else:
            flat = logits.reshape(num_rows * row_t, vocab)
            per_seq = ctc_loss(flat[batch["utt_time_index"].long()],
                               batch["utt_sequence_length"],
                               batch["nnet_target"], batch["target_length"])
    else:
        per_seq = ctc_loss(logits, batch["sequence_length"],
                           batch["nnet_target"], batch["target_length"])
    eval_loss = torch.sum(per_seq)
    size = torch.sum(batch["nnet_target"] >= 0)
    loss = eval_loss
    for value, weight in reg_losses:
        if value is not None and weight is not None and weight > 0:
            loss = loss + value
    metrics = {"size": size, "eval_loss": eval_loss, "loss": loss}
    return metrics, logits, new_state


def make_eval_step(config: Dict, with_logits: bool = False):
    """Returns eval_step(params, net_state, batch) → metrics[, logits].
    Under data parallelism the metrics are the global batch's and the
    logits its rows, gathered from the ranks."""

    def eval_step(params, net_state, batch):
        with torch.no_grad():
            metrics, logits, _ = compute_losses(params, net_state, batch,
                                                config, train=False)
            shard = batch.get(parallel.SHARD_KEY)
            if shard is not None:
                _, metrics = parallel.combine(shard, [], metrics)
                if with_logits:
                    logits = parallel.gather_rows(shard, logits)
        return (metrics, logits) if with_logits else metrics

    return eval_step


def make_train_step(config: Dict, learn_rate: float, optimizer: str = "sgd",
                    clip_norm: float = 5.0, l2_decay_weight: float = 1e-5):
    """Returns (init_opt_state, train_step).

    train_step(params, opt_state, net_state, generator, batch)
        → (params, opt_state, net_state, metrics)

    The parameter tensors are updated in place (and returned); each must
    be a float32 leaf that requires grad.  ``generator`` is a
    ``torch.Generator`` on the device or ``cells.DropoutStreams``.  Under
    data parallelism the loss's gradients and the metrics are combined
    over the ranks (``parallel.combine``) before the L2 term's gradient is
    added, once."""
    tx = get_optimizer(optimizer, learn_rate)

    def init_opt_state(params):
        return tx.init(param_leaves(params))

    def train_step(params, opt_state, net_state, generator, batch):
        leaves = param_leaves(params)
        metrics, _, new_state = compute_losses(
            params, net_state, batch, config, train=True, generator=generator)
        grads = list(torch.autograd.grad(metrics["loss"], leaves))
        metrics = {k: v.detach() for k, v in metrics.items()}
        shard = batch.get(parallel.SHARD_KEY)
        if shard is not None:
            grads, metrics = parallel.combine(shard, grads, metrics)
        grads = [g if d is None else g + d
                 for g, d in zip(grads, l2_grads(params, l2_decay_weight))]
        grads, _ = clip_by_global_norm(grads, clip_norm)
        tx.update(leaves, grads, opt_state)
        return params, opt_state, new_state, metrics

    return init_opt_state, train_step
