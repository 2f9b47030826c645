"""High-rank mixture-of-softmaxes output head.

Counterpart of ``lstm_ctc_tpu/models/moe.py:67-140``: a softmax gate over
``num_experts`` (with dropout on the gate probabilities in training) mixes
per-expert logit vectors ``tau * tanh(xW + b)`` (with hash dropout on the
expert logits); the mixed result is used directly as CTC logits.  The gate
linear, softmax and dropout are plain torch; the expert mix goes through
the fused kernels (``ops/moe_kernels.moe_mix_fused``: K4 in evaluation, K5
with the K6 backward in training), which run their plain versions on the
CPU.  The kernels take every target count V <= 128 and every V whose lcm
with 128 is at most 4096 (the reference's ``fused_eligible``: 136, 144,
192, 200, 256, 384, 512, 1024, 2048, 4096, ...); a head they refuse
(``moe_kernels.mix_eligible``: another V, more than 128 targets under the
opt-in twokernel or kernel backward, or a float32 input past 1024) takes
the plain mix under autograd instead, with one warning, as the reference
takes XLA's einsum (:110-140).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..ops import moe_kernels
from .cells import draw_seed, dropout, truncated_normal


def init_moe(generator: torch.Generator, output_dim: int, num_targets: int,
             num_experts: int, device="cpu") -> Dict:
    stddev = 1.0 / math.sqrt(float(output_dim))
    return {
        "w_prior": truncated_normal(generator, (output_dim, num_experts),
                                    stddev, device),
        "b_prior": torch.zeros(num_experts, device=device),
        "w_expert": truncated_normal(
            generator, (output_dim, num_targets * num_experts), stddev,
            device),
        "b_expert": torch.zeros(num_targets * num_experts, device=device),
    }


def apply_moe(params: Dict, x: torch.Tensor, num_experts: int,
              moe_temperature: float, compute_dtype=None,
              keep_prob: float = 1.0, generator=None,
              wgrad_mode: str = "xla") -> torch.Tensor:
    """x ``[N, output_dim]`` → mixed logits ``[N, num_targets]``.

    ``compute_dtype`` is the expert product's operand precision (None:
    x's dtype).  With keep_prob < 1 and a ``generator`` (on x's device;
    or ``cells.DropoutStreams``) the gate probabilities are dropped
    (``cells.dropout``) and the expert dropout seed is drawn as a
    one-element int32 tensor on the device (``cells.draw_seed``), as the
    reference draws it (:118-120); the kernels read it there, so the step
    never waits for it.  ``wgrad_mode`` picks the backward of the weight
    gradient (``moe_kernels.moe_mix_fused``)."""
    gate = torch.softmax(x @ params["w_prior"] + params["b_prior"], dim=-1)
    seed = None
    if keep_prob < 1.0 and generator is not None:
        gate = dropout(generator, gate, keep_prob)
        seed = draw_seed(generator, x.device)
    else:
        keep_prob = 1.0
    cdt = compute_dtype or x.dtype
    w_expert = params["w_expert"]
    if not moe_kernels.mix_eligible(
            w_expert.shape[0], w_expert.shape[1] // num_experts, cdt,
            wgrad_mode, warn=x.device.type == "cuda"):
        return moe_kernels.moe_mix_reference(
            x, w_expert, params["b_expert"], gate, num_experts,
            moe_temperature, keep_prob, seed, cdt)
    return moe_kernels.moe_mix_fused(
        x, w_expert, params["b_expert"], gate, num_experts, moe_temperature,
        keep_prob=keep_prob, seed=seed, compute_dtype=cdt,
        wgrad_mode=wgrad_mode)
