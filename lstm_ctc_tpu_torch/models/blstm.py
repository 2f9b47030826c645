"""Residual projected bidirectional LSTM acoustic model.

Counterpart of ``lstm_ctc_tpu/models/blstm.py:40-257``:
  * per-layer forward and backward LSTM cells (peepholes, projection,
    forget bias 5.0) run through the reverse-sequence trick, both
    directions in one fused layer kernel (``ops/lstm_kernels``);
  * forward/backward outputs concatenated; residual add on layer 0 iff
    ``input_dim == 2 * num_projects``;
  * head: dense, or the MoE mixture-of-softmaxes head when
    ``num_experts > 0``;
  * the uniform / prior label-smoothing KL regularizers;
  * an ``encoder`` vector: concat of both final states;
  * in training, per-direction output dropout with *keep* probability
    ``dropout_rate`` after every layer, each layer differentiable through
    the backward kernel (``lstm_kernels.bilstm_dual_scan_train``), and the
    MoE head's gate and expert dropout at the same keep probability, the
    head differentiable through its backward kernels;
  * a layer the kernels refuse (``lstm_kernels.layer_eligible``: past 2048
    units, a backward with H or P not divisible by 4, no launch plan of K1
    or K2, resident or streamed) runs the plain
    recurrence (``cells.bilstm_dual_scan``) under autograd, with one
    warning.

Two nnet.config keys choose among the backward kernels, as two env knobs
do in the reference:

  * ``lstm_fold_dx`` (default false; ``LSTM_CTC_TPU_LSTM_FOLD_DX=1``
    there): every layer whose input width is a multiple of 128 trains
    through the folded backward (K3), which also computes the layer's
    input side; the others, through K2;
  * ``moe_wgrad_mode`` (``LSTM_CTC_TPU_MOE_WGRAD`` there): ``xla`` (the
    default), ``twokernel`` or ``kernel`` picks how the head's weight
    gradient is computed (``moe_kernels.moe_mix_fused``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from ..host.class_prior import get_class_prior
from ..ops import lstm_kernels
from .cells import (bilstm_dual_scan, dropout, init_lstm_cell,
                    reverse_segments, reverse_sequence, truncated_normal)
from .moe import apply_moe, init_moe

FORGET_BIAS = 5.0


def _model_dims(config: Dict) -> Dict:
    dims = {
        "input_dim": config["input_dim"] * (
            1 + config.get("left_context", 0) + config.get("right_context", 0)),
        "num_layers": config["num_layers"],
        "num_neurons": config["num_neurons"],
        "num_projects": config.get("num_projects") or None,
        "num_targets": config["num_targets"],
        "use_peepholes": bool(config.get("use_peepholes", False)),
        "num_experts": config.get("num_experts") or 0,
        "moe_temp": float(config.get("moe_temp", 10.0)),
    }
    dims["output_dim"] = 2 * (dims["num_projects"] or dims["num_neurons"])
    return dims


def _compute_dtype(config: Dict, device) -> torch.dtype:
    """Matmul operand precision (accumulation and the carried state stay
    float32).  ``compute_dtype`` in nnet.config wins; otherwise bfloat16
    on CUDA and float32 on the CPU."""
    raw = str(config.get("compute_dtype", "") or "").lower()
    if raw in ("bfloat16", "bf16"):
        return torch.bfloat16
    if raw in ("float32", "f32", "fp32"):
        return torch.float32
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def _store_dtype(config: Dict) -> torch.dtype:
    """Precision of the per-step states kept for the backward and of the
    dgates stream (``store_dtype`` in nnet.config; bfloat16 by default, as
    ``blstm._fused_store_dtype`` of the reference)."""
    raw = str(config.get("store_dtype", "") or "").lower()
    return torch.float32 if raw in ("float32", "f32", "fp32") \
        else torch.bfloat16


def init_blstm(generator: torch.Generator, config: Dict,
               device="cpu") -> Dict:
    dims = _model_dims(config)
    params: Dict = {"fwd": [], "bwd": []}
    layer_input_dim = dims["input_dim"]
    proj_dim = dims["num_projects"] or dims["num_neurons"]
    for _ in range(dims["num_layers"]):
        for direction in ("fwd", "bwd"):
            params[direction].append(init_lstm_cell(
                generator, layer_input_dim, dims["num_neurons"],
                dims["num_projects"], dims["use_peepholes"], device))
        layer_input_dim = 2 * proj_dim
    if dims["num_experts"] > 0:
        params["moe"] = init_moe(generator, dims["output_dim"],
                                 dims["num_targets"], dims["num_experts"],
                                 device)
    else:
        stddev = 1.0 / math.sqrt(float(dims["num_neurons"]))
        params["head"] = {
            "w": truncated_normal(generator, (dims["output_dim"],
                                              dims["num_targets"]),
                                  stddev, device),
            "b": torch.zeros(dims["num_targets"], device=device),
        }
    return params


def label_smoothing_reg(logits: torch.Tensor, config: Dict) -> List:
    """KL(label-smoothing) regularizers as (value, weight) pairs."""
    reg_losses = []
    uniform_w = config.get("uniform_label_sm")
    prior_w = config.get("prior_label_sm")
    prior_path = config.get("prior_label_path")
    if uniform_w is not None and uniform_w > 0:
        log_target = math.log(1.0 / config["num_targets"])
        weight = uniform_w
    elif prior_w is not None and prior_w > 0 and prior_path is not None:
        log_target = torch.from_numpy(get_class_prior(prior_path)).to(
            logits.device)
        weight = prior_w
    else:
        return reg_losses
    pred = torch.softmax(logits, dim=-1)
    kl = pred * (torch.log(pred) - log_target)
    reg_losses.append((torch.sum(kl) * weight, weight))
    return reg_losses


def apply_blstm(params: Dict,
                nnet_input: torch.Tensor,
                sequence_length: torch.Tensor,
                config: Dict,
                reset_mask=None,
                train: bool = False,
                generator=None) -> Tuple[torch.Tensor, torch.Tensor, List]:
    """nnet_input ``[B, T, D·ctx]`` (already spliced) → (logits [B, T, V],
    encoder [B, 2(H+P)], reg_losses).

    ``reset_mask`` ``[B, T]`` marks the first frame of each segment when
    rows pack several utterances: the carry is zeroed there and the
    backward direction reverses each segment in place.  With ``train``
    the layers are differentiable, and ``generator`` (on the input's
    device) draws the dropout masks."""
    dims = _model_dims(config)
    compute_dtype = _compute_dtype(config, nnet_input.device)
    keep_prob = float(config.get("dropout_rate", 1.0)) if train else 1.0

    if reset_mask is None:
        def rev(v):
            return reverse_sequence(v, sequence_length)
    else:
        def rev(v):
            return reverse_segments(v, sequence_length, reset_mask)

    fold_dx = bool(config.get("lstm_fold_dx", False))
    finput = nnet_input
    binput = rev(nnet_input)
    kernels = lstm_kernels.layer_eligible(
        nnet_input.device, dims["num_neurons"],
        dims["num_projects"] or dims["num_neurons"],
        dims["num_projects"] is not None, compute_dtype, train,
        _store_dtype(config), warn=nnet_input.device.type == "cuda")
    for i in range(dims["num_layers"]):
        if not kernels:
            fw_out, bw_out, (fw_state, bw_state) = bilstm_dual_scan(
                params["fwd"][i], params["bwd"][i], finput, binput,
                sequence_length, FORGET_BIAS, compute_dtype=compute_dtype,
                reset_mask=reset_mask)
        elif train:
            # the reference folds only where its TPU lanes allow it (an
            # input width of 128k); the same layers fold here, so that both
            # packages round dx to the store dtype at the same places
            fw_out, bw_out, (fw_state, bw_state) = \
                lstm_kernels.bilstm_dual_scan_train(
                    params["fwd"][i], params["bwd"][i], finput, binput,
                    sequence_length, FORGET_BIAS, compute_dtype=compute_dtype,
                    reset_mask=reset_mask, store_dtype=_store_dtype(config),
                    fold_dx=fold_dx and finput.shape[-1] % 128 == 0)
        else:
            fw_out, bw_out, (fw_state, bw_state) = \
                lstm_kernels.bilstm_dual_scan_fused(
                    params["fwd"][i], params["bwd"][i], finput, binput,
                    sequence_length, FORGET_BIAS,
                    compute_dtype=compute_dtype, reset_mask=reset_mask)
        if keep_prob < 1.0 and generator is not None:
            fw_out = dropout(generator, fw_out, keep_prob)
            bw_out = dropout(generator, bw_out, keep_prob)
        cat = torch.cat([fw_out, rev(bw_out)], dim=2)
        if i == 0 and dims["input_dim"] == dims["output_dim"]:
            finput = finput + cat
        else:
            finput = cat
        binput = rev(finput)

    encoder = torch.cat([fw_state[0], fw_state[1], bw_state[0], bw_state[1]],
                        dim=1)
    batch, time_steps, _ = finput.shape
    flat = finput.reshape(batch * time_steps, dims["output_dim"])
    if dims["num_experts"] > 0:
        y = apply_moe(params["moe"], flat, dims["num_experts"],
                      dims["moe_temp"], compute_dtype=compute_dtype,
                      keep_prob=keep_prob, generator=generator,
                      wgrad_mode=str(config.get("moe_wgrad_mode") or "xla"))
    else:
        y = flat @ params["head"]["w"] + params["head"]["b"]
    logits = y.reshape(batch, time_steps, dims["num_targets"])
    return logits, encoder, label_smoothing_reg(logits, config)
