"""High-rank mixture-of-softmaxes output head.

Counterpart of ``lstm_ctc_tpu/models/moe.py:67-140``: a softmax gate over
``num_experts`` mixes per-expert logit vectors ``tau * tanh(xW + b)``; the
mixed result is used directly as CTC logits.  The gate linear and softmax
are plain torch; the expert mix goes through the fused kernel
(``ops/moe_kernels.moe_mix_fused``), which runs its plain version on the
CPU.  Evaluation only: the head's dropout belongs to training.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..ops import moe_kernels
from .cells import truncated_normal


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
              moe_temperature: float, compute_dtype=None) -> torch.Tensor:
    """x ``[N, output_dim]`` → mixed logits ``[N, num_targets]``.
    ``compute_dtype`` is the expert product's operand precision (None:
    x's dtype)."""
    gate = torch.softmax(x @ params["w_prior"] + params["b_prior"], dim=-1)
    return moe_kernels.moe_mix_fused(
        x, params["w_expert"], params["b_expert"], gate, num_experts,
        moe_temperature, compute_dtype=compute_dtype or x.dtype)
