"""CTC loss: log-space forward/backward DP over the 2U+1 label lattice.

Counterpart of ``lstm_ctc_tpu/ops/ctc.py``, the mirror of
``tf.nn.ctc_loss(..., ignore_longer_outputs_than_inputs=True)``:

  * logits are batch-major ``[B, T, V]``, softmax-normalized inside, in
    float32;
  * blank is the LAST class (V-1);
  * per-sequence loss = -log p(labels | logits), shape ``[B]``;
  * infeasible pairs (more labels than frames, also counting the blanks
    that repeated labels force, or no frames at all) get loss 0 and
    gradient 0.

The alpha recursion runs through kernel K10 and the beta recursion through
K11 (``ctc_kernels``), or, for a lattice the kernels refuse
(``ctc_kernels.dp_eligible``), through their plain versions, with one
warning, as the reference runs its scan (:197); the glue around them
(log-softmax, the lattice gather, the occupancy and its scatter back to
classes) is plain PyTorch, as it is XLA outside the kernels in the
reference.  The gradient is the analytic ``softmax - occupancy`` of
``ctc._backward`` (:245-326), not autograd through the DP.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ctc_kernels
from .ctc_kernels import NEG_INF


def _lattice(labels, label_length, blank_id: int):
    """Extended labels ``[B, S]`` and the masks valid / can_skip
    (``ctc._lattice`` :155-167)."""
    batch, max_u = labels.shape
    ext_len = 2 * max_u + 1
    ext = torch.full((batch, ext_len), blank_id, dtype=torch.long,
                     device=labels.device)
    ext[:, 1::2] = labels.clamp(min=0).long()
    s = torch.arange(ext_len, device=labels.device)[None, :]
    valid = s < (2 * label_length.long()[:, None] + 1)
    ext_prev2 = torch.cat([ext.new_full((batch, 2), -1), ext[:, :-2]], dim=1)
    can_skip = (s % 2 == 1) & (ext != ext_prev2) & (s >= 2)
    return ext, valid, can_skip


def _kernels(lp_ext) -> bool:
    """Whether the DP goes through K10 and K11 (else their plain versions):
    decided from the lattice's width before any launch."""
    return ctc_kernels.dp_eligible(lp_ext.shape[2],
                                   warn=lp_ext.device.type == "cuda")


def _forward(logits, sequence_length, labels, label_length, blank_id):
    """Returns (loss [B], what the backward needs)."""
    max_t = logits.shape[1]
    device = logits.device
    ext, valid, can_skip = _lattice(labels, label_length, blank_id)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    # one gather for the whole sequence, then time-major [T, B, S]
    lp_ext = torch.gather(
        log_probs, 2, ext[:, None, :].expand(-1, max_t, -1))
    lp_ext = lp_ext.transpose(0, 1).contiguous()

    s = torch.arange(ext.shape[1], device=device)[None, :]
    lengths = label_length.long()
    init = (s == 0) | ((s == 1) & (lengths[:, None] > 0))
    alpha0 = torch.where(init & valid, lp_ext[0],
                         torch.full_like(lp_ext[0], NEG_INF))
    time_mask = (torch.arange(max_t, device=device)[:, None]
                 < sequence_length.to(device).long()[None, :]).contiguous()
    alpha = ctc_kernels.ctc_alpha if _kernels(lp_ext) \
        else ctc_kernels.alpha_reference
    alpha_all = alpha(lp_ext, time_mask, valid.contiguous(),
                      can_skip.contiguous(), alpha0)
    alpha_last = alpha_all[-1]

    end = 2 * lengths[:, None]
    last_blank = torch.gather(alpha_last, 1, end)[:, 0]
    last_label = torch.gather(alpha_last, 1, (end - 1).clamp(min=0))[:, 0]
    last_label = torch.where(lengths > 0, last_label,
                             torch.full_like(last_label, NEG_INF))
    m = torch.maximum(last_blank, last_label)
    log_lik = m + torch.log(torch.exp(last_blank - m)
                            + torch.exp(last_label - m))
    log_lik = torch.where(m <= NEG_INF * 0.5, torch.full_like(m, NEG_INF),
                          log_lik)
    seq = sequence_length.to(device).long()
    feasible = (lengths <= seq) & (seq > 0) & (log_lik > NEG_INF * 0.5)
    loss = torch.where(feasible, -log_lik, torch.zeros_like(log_lik))
    saved = (log_probs, lp_ext, alpha_all, log_lik, feasible, ext, valid,
             can_skip, time_mask, lengths)
    return loss, saved


def _backward(saved, grad_loss):
    """softmax - occupancy, masked to real frames and feasible pairs and
    scaled per row by the upstream cotangent (``ctc._backward``)."""
    (log_probs, lp_ext, alpha_all, log_lik, feasible, ext, valid, can_skip,
     time_mask, lengths) = saved
    max_t, batch, ext_len = lp_ext.shape
    device = lp_ext.device
    s = torch.arange(ext_len, device=device)[None, :]
    end = 2 * lengths[:, None]
    final_mask = (s == end) | ((s == end - 1) & (lengths[:, None] > 0))
    # the transition s -> s+2 is allowed iff can_skip holds at s+2
    skip_from = torch.cat([can_skip[:, 2:], torch.zeros_like(can_skip[:, :2])],
                          dim=1)
    seq = time_mask.sum(0)
    is_last = (torch.arange(max_t, device=device)[:, None]
               == (seq - 1)[None, :]).contiguous()
    beta = ctc_kernels.ctc_beta if _kernels(lp_ext) \
        else ctc_kernels.beta_reference
    beta_all = beta(lp_ext, time_mask, is_last, valid.contiguous(),
                    skip_from.contiguous(), (final_mask & valid).contiguous())

    gamma_log = alpha_all + beta_all - lp_ext - log_lik[None, :, None]
    keep = valid[None] & time_mask[:, :, None] & feasible[None, :, None]
    gamma_log = torch.where(keep, gamma_log,
                            torch.full_like(gamma_log, NEG_INF))
    gamma = torch.exp(torch.clamp(gamma_log, max=0.0))       # [T, B, S]
    # occupancy back to classes: gamma summed over the lattice positions
    # that carry each class, as one batched [S -> V] product
    onehot = torch.nn.functional.one_hot(
        ext, log_probs.shape[2]).float()                      # [B, S, V]
    occ = torch.bmm(gamma.transpose(0, 1), onehot)            # [B, T, V]
    grad = torch.exp(log_probs) - occ
    grad = grad * time_mask.t()[:, :, None]
    grad = grad * feasible[:, None, None]
    return grad * grad_loss[:, None, None]


class _CtcLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, sequence_length, labels, label_length,
                blank_id):
        loss, saved = _forward(logits, sequence_length, labels, label_length,
                               blank_id)
        ctx.saved = saved
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, grad_loss):
        grad = _backward(ctx.saved, grad_loss.float())
        ctx.saved = None
        return grad.to(ctx.dtype), None, None, None, None


def ctc_loss(logits: torch.Tensor,
             sequence_length: torch.Tensor,
             labels: torch.Tensor,
             label_length: Optional[torch.Tensor] = None,
             blank_id: Optional[int] = None) -> torch.Tensor:
    """Per-sequence negative log-likelihood, shape ``[B]``."""
    num_classes = logits.shape[2]
    if blank_id is None:
        blank_id = num_classes - 1
    if label_length is None:
        label_length = (labels >= 0).sum(1)
    label_length = label_length.to(logits.device)
    labels = labels.to(logits.device)
    if labels.shape[1] == 0:
        # every reference empty (``ctc.py`` :372-382): the only path is
        # all-blank, loss = -sum_t log P(blank)
        log_probs = torch.log_softmax(logits.float(), dim=2)
        t = torch.arange(logits.shape[1], device=logits.device)
        mask = t[None, :] < sequence_length.to(logits.device)[:, None]
        return -torch.where(mask, log_probs[:, :, blank_id],
                            torch.zeros_like(mask, dtype=log_probs.dtype)
                            ).sum(1).to(logits.dtype)
    return _CtcLoss.apply(logits, sequence_length, labels, label_length,
                          blank_id)
