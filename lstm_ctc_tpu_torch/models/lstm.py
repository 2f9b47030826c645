"""Unidirectional LSTM acoustic models (``lstm`` and ``cudnnlstm`` types).

Counterpart of ``lstm_ctc_tpu/models/lstm.py``:
  * ``lstm``: a stack of projected peephole LSTM cells, forget bias 1.0;
    layer 0 is plain when ``input_dim != num_projects``, every other layer
    residual (output = cell(x) + x); optional batch norm before layer 0 and
    after every layer (``use_bn``, momentum 0.99, eps 1e-3); output dropout
    with keep probability ``dropout_rate`` in training; dense or MoE head;
  * ``cudnnlstm``: a stack of standard cells (no peepholes, no projection,
    no residual, no dropout) and a dense head.

The stack runs through the stack kernels (``ops/lstm_stack_kernels``: K12,
and K13 under autograd) whenever it is uniform (``stack_eligible``):
inter-layer dropout is the kernels' hash mask, and eval-mode batch norm
rides in as per-layer chain affines.  Training with batch norm needs each
layer's batch statistics first, so it runs layer by layer, each BN affine
folded into the next layer's input weights (or the dense head), through
the bidirectional layer kernels (K1, K2) with the two half-batches as the
two directions; so does a stack that is not uniform, or that the stack
kernels refuse (``stack_eligible``: past 512 units, a backward with H or P
not divisible by 4, a shape for which K12 or K13 has no launch plan that
fits a block), and a layer the layer kernels refuse
(``lstm_kernels.layer_eligible``) runs the plain recurrence under
autograd, with one warning (streaming, with carried states, the plain
``cells.lstm_scan`` where K12 refuses the layer).  Batch statistics
are taken over every (b, t), padding included, as
``tf.layers.batch_normalization`` takes them; the running moments are
``state``, returned updated as ``new_state`` in training.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..ops import lstm_kernels
from ..ops.lstm_stack_kernels import (lstm_stack_fused, stack_eligible,
                                      stack_layer_eligible)
from .blstm import _compute_dtype, _store_dtype
from .cells import (dropout, dual_recurrence, init_lstm_cell, lstm_scan,
                    recurrent_weights, truncated_normal)
from .moe import apply_moe, init_moe

FORGET_BIAS = 1.0
BN_MOMENTUM = 0.99
BN_EPS = 1e-3  # tf.layers.batch_normalization's default


def _dims(config: Dict) -> Dict:
    dims = {
        "input_dim": config["input_dim"] * (
            1 + config.get("left_context", 0) + config.get("right_context", 0)),
        "num_layers": config["num_layers"],
        "num_neurons": config["num_neurons"],
        "num_projects": config.get("num_projects") or None,
        "num_targets": config["num_targets"],
        "use_bn": bool(config.get("use_bn", False)),
        "num_experts": config.get("num_experts") or 0,
        "moe_temp": float(config.get("moe_temp", 10.0)),
    }
    dims["output_dim"] = dims["num_projects"] or dims["num_neurons"]
    return dims


def _head(generator, in_dim: int, num_targets: int, device) -> Dict:
    return {"w": truncated_normal(generator, (in_dim, num_targets),
                                  1.0 / math.sqrt(float(in_dim)), device),
            "b": torch.zeros(num_targets, device=device)}


def init_lstm(generator: torch.Generator, config: Dict,
              device="cpu") -> Tuple[Dict, Dict]:
    """Returns (params, state); state holds the batch-norm running moments
    (``state/bn_in/{mean,var}`` and ``state/bn/<i>/{mean,var}`` in a
    checkpoint)."""
    dims = _dims(config)
    params: Dict = {"layers": []}
    state: Dict = {"bn": []}
    layer_input = dims["input_dim"]
    for _ in range(dims["num_layers"]):
        params["layers"].append(init_lstm_cell(
            generator, layer_input, dims["num_neurons"], dims["num_projects"],
            use_peepholes=True, device=device))
        layer_input = dims["output_dim"]
    if dims["use_bn"]:
        def bn(dim):
            return {"scale": torch.ones(dim, device=device),
                    "offset": torch.zeros(dim, device=device)}

        def moments(dim):
            return {"mean": torch.zeros(dim, device=device),
                    "var": torch.ones(dim, device=device)}

        params["bn_in"], state["bn_in"] = bn(dims["input_dim"]), \
            moments(dims["input_dim"])
        params["bn"] = [bn(dims["output_dim"])
                        for _ in range(dims["num_layers"])]
        state["bn"] = [moments(dims["output_dim"])
                       for _ in range(dims["num_layers"])]
    if dims["num_experts"] > 0:
        params["moe"] = init_moe(generator, dims["output_dim"],
                                 dims["num_targets"], dims["num_experts"],
                                 device)
    else:
        params["head"] = _head(generator, dims["output_dim"],
                               dims["num_targets"], device)
    return params, state


def init_cudnnlstm(generator: torch.Generator, config: Dict,
                   device="cpu") -> Dict:
    dims = _dims(config)
    params: Dict = {"layers": []}
    layer_input = dims["input_dim"]
    for _ in range(dims["num_layers"]):
        params["layers"].append(init_lstm_cell(
            generator, layer_input, dims["num_neurons"], None,
            use_peepholes=False, device=device))
        layer_input = dims["num_neurons"]
    params["head"] = _head(generator, dims["num_neurons"],
                           dims["num_targets"], device)
    return params


def bn_affine(bn_params: List[Dict], bn_state: List[Dict]):
    """Eval-mode batch norms as per-channel affines x·a + b:
    a = scale·rsqrt(var + eps), b = offset − mean·a."""
    out = []
    for p, s in zip(bn_params, bn_state):
        a = torch.rsqrt(s["var"] + BN_EPS) * p["scale"]
        out.append((a, p["offset"] - s["mean"] * a))
    return out


def apply_bn_eval(bn_params: Dict, bn_state: Dict, x: torch.Tensor):
    (a, b), = bn_affine([bn_params], [bn_state])
    return x * a + b


def _bn_train_affine(bn_params: Dict, bn_state: Dict, x: torch.Tensor):
    """Train-mode batch norm as a per-channel affine: ((a, b), the updated
    running moments).  The statistics are unmasked over every leading axis;
    the moments are detached (they are state, not a function of the
    parameters to differentiate)."""
    flat = x.reshape(-1, x.shape[-1])
    mean = flat.mean(0)
    var = flat.var(0, unbiased=False)
    new_state = {
        "mean": (BN_MOMENTUM * bn_state["mean"]
                 + (1 - BN_MOMENTUM) * mean).detach(),
        "var": (BN_MOMENTUM * bn_state["var"]
                + (1 - BN_MOMENTUM) * var).detach(),
    }
    a = torch.rsqrt(var + BN_EPS) * bn_params["scale"]
    return (a, bn_params["offset"] - mean * a), new_state


def _fold_affine_into_cell(cell: Dict, a, b) -> Dict:
    """x̂ = a·x + b folded into a cell's input kernel:
    x̂ @ wx + bias = x @ (a ⊙ wx) + (bias + b @ wx)."""
    cell = dict(cell)
    cell["bias"] = cell["bias"] + b @ cell["wx"]
    cell["wx"] = a[:, None] * cell["wx"]
    return cell


def layer_forward(cell: Dict, x, sequence_length, compute_dtype,
                  store_dtype=torch.bfloat16):
    """One unidirectional layer through the bidirectional layer kernel K1
    (and K2 under autograd), as ``lstm_pallas.lstm_scan_fused`` (:856)
    reuses the TPU's: the two half-batches go in as the two directions, the
    weights stacked twice, so dwh is the sum of the halves.  The kernel
    masks both halves with one length per row pair, the longer of the two;
    the outputs are masked by each row's own length after it (past its
    length a row's output and its cotangent are zero, so the longer
    recurrence of the shorter row changes nothing that is kept).  An odd
    batch gets a zero-length pad row.  Returns outputs ``[B, T, P]``."""
    batch, time_steps, _ = x.shape
    cdt = compute_dtype
    valid = (torch.arange(time_steps, device=x.device)[None, :]
             < sequence_length.to(x.device)[:, None]).float()
    seq = sequence_length.to(x.device)
    if batch % 2:
        x = F.pad(x, (0, 0, 0, 0, 0, 1))
        seq = torch.cat([seq, seq.new_zeros(1)])
    half = x.shape[0] // 2
    lengths = torch.maximum(seq[:half], seq[half:])
    gx = torch.matmul(x.to(cdt), cell["wx"].to(cdt)).float() + cell["bias"]
    gx = gx.transpose(0, 1).contiguous()                # [T, 2·half, 4H]
    wh, proj, peep = recurrent_weights(cell, cell, cdt)
    train = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (gx, wh, proj, peep))
    units = wh.shape[2] // 4
    if not lstm_kernels.layer_eligible(
            x.device, units, wh.shape[1], proj is not None, cdt, train,
            store_dtype, warn=x.device.type == "cuda"):
        out, _, _ = dual_recurrence(gx, lengths, None, wh, proj, peep,
                                    FORGET_BIAS)
    elif train:
        out, _, _ = lstm_kernels._LstmLayer.apply(
            gx, wh, proj, peep, lengths, None, FORGET_BIAS, store_dtype)
    else:
        out, _, _ = lstm_kernels.lstm_layer_forward(
            gx, lengths, None, wh, proj, peep, FORGET_BIAS)
    return out.transpose(0, 1)[:batch] * valid[:, :, None]


def stack_layers(layers: List[Dict], x, sequence_length, residual_flags,
                 compute_dtype, store_dtype=torch.bfloat16, keep_prob=1.0,
                 generator=None, affine=None, initial_states=None):
    """Every layer of a stack, with residual adds, dropout and the eval-BN
    affines.  A uniform stack runs through the stack kernels in one launch
    (its dropout seed, a one-element int32 tensor, drawn on the device from
    ``generator``); any other runs layer by layer: through K1 (and K2), or,
    with carried states, through the stack kernel one layer at a time,
    with the residual, dropout and affine outside.  Returns (outputs, final
    states or None)."""
    if not (keep_prob < 1.0 and generator is not None):
        keep_prob = 1.0
    train = torch.is_grad_enabled() and any(
        t.requires_grad for cell in layers for t in cell.values())
    if stack_eligible(layers, train, warn=x.device.type == "cuda",
                      device=x.device, dtype=compute_dtype,
                      store_dtype=store_dtype):
        seed = None
        if keep_prob < 1.0:
            seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,),
                                 generator=generator, device=x.device,
                                 dtype=torch.int32)
        return lstm_stack_fused(
            layers, x, sequence_length, FORGET_BIAS,
            residual_flags=residual_flags, compute_dtype=compute_dtype,
            store_dtype=store_dtype, initial_states=initial_states,
            keep_prob=keep_prob, seed=seed, affine=affine)
    states = [] if initial_states is not None else None
    for i, cell in enumerate(layers):
        if initial_states is not None and not stack_layer_eligible(
                cell, x.device, compute_dtype, warn=x.device.type == "cuda"):
            # past the stack kernel's units or plans (stack_eligible
            # warned): the plain scan carries the state
            out, state = lstm_scan(cell, x, sequence_length, FORGET_BIAS,
                                   initial_states[i], compute_dtype)
            states.append(state)
        elif initial_states is not None:
            out, (state,) = lstm_stack_fused(
                [cell], x, sequence_length, FORGET_BIAS,
                compute_dtype=compute_dtype, store_dtype=store_dtype,
                initial_states=[initial_states[i]])
            states.append(state)
        else:
            out = layer_forward(cell, x, sequence_length, compute_dtype,
                                store_dtype)
        if residual_flags[i]:
            out = out + x
        if keep_prob < 1.0:
            out = dropout(generator, out, keep_prob)
        if affine is not None:
            out = out * affine[i][0] + affine[i][1]
        x = out
    return x, states


def _residual_flags(dims: Dict) -> List[bool]:
    return [not (i == 0 and dims["input_dim"] != dims["output_dim"])
            for i in range(dims["num_layers"])]


def apply_lstm(params: Dict, state: Dict, nnet_input, sequence_length,
               config: Dict, train: bool = False, generator=None):
    """nnet_input ``[B, T, D·ctx]`` → (logits ``[B, T, V]``, None, [],
    new_state).  With ``train``, dropout at keep ``dropout_rate`` from
    ``generator`` (on the input's device), and batch norm with batch
    statistics, its running moments updated in ``new_state``."""
    dims = _dims(config)
    cdt = _compute_dtype(config, nnet_input.device)
    sdt = _store_dtype(config)
    keep_prob = float(config.get("dropout_rate", 1.0)) if train else 1.0
    if generator is None:
        keep_prob = 1.0
    res_flags = _residual_flags(dims)
    new_state = {"bn": list(state.get("bn", []))}
    x = nnet_input
    head_affine = None
    if dims["use_bn"] and train:
        # each BN's train-mode affine folds into the next layer's input
        # kernel (the input BN into layer 0's): nothing normalized is
        # materialized between layers
        pending, new_state["bn_in"] = _bn_train_affine(
            params["bn_in"], state["bn_in"], x)
        for i, layer in enumerate(params["layers"]):
            cell = _fold_affine_into_cell(layer, *pending)
            out = layer_forward(cell, x, sequence_length, cdt, sdt)
            if res_flags[i]:
                # the residual adds the layer's normalized input
                out = out + (pending[0] * x + pending[1])
            if keep_prob < 1.0:
                out = dropout(generator, out, keep_prob)
            pending, new_state["bn"][i] = _bn_train_affine(
                params["bn"][i], state["bn"][i], out)
            x = out
        head_affine = pending          # the last BN folds into the head
    else:
        affine = None
        if dims["use_bn"]:
            x = apply_bn_eval(params["bn_in"], state["bn_in"], x)
            new_state["bn_in"] = state["bn_in"]
            affine = bn_affine(params["bn"], state["bn"])
        x, _ = stack_layers(params["layers"], x, sequence_length, res_flags,
                            cdt, sdt, keep_prob, generator, affine)

    batch, time_steps, _ = x.shape
    flat = x.reshape(batch * time_steps, dims["output_dim"])
    if head_affine is not None and dims["num_experts"] > 0:
        # the MoE head has two products and in-kernel dropout: the last
        # affine is materialized instead of folded
        flat = head_affine[0] * flat + head_affine[1]
        head_affine = None
    if dims["num_experts"] > 0:
        y = apply_moe(params["moe"], flat, dims["num_experts"],
                      dims["moe_temp"], compute_dtype=cdt,
                      keep_prob=keep_prob, generator=generator,
                      wgrad_mode=str(config.get("moe_wgrad_mode") or "xla"))
    else:
        w, b = params["head"]["w"], params["head"]["b"]
        if head_affine is not None:
            a, shift = head_affine
            w, b = a[:, None] * w, b + shift @ w
        y = flat @ w + b
    logits = y.reshape(batch, time_steps, dims["num_targets"])
    return logits, None, [], new_state


def apply_cudnnlstm(params: Dict, nnet_input, sequence_length, config: Dict,
                    train: bool = False, generator=None):
    """→ (logits, None, []).  No dropout, in training or not."""
    dims = _dims(config)
    x, _ = stack_layers(params["layers"], nnet_input, sequence_length,
                        [False] * dims["num_layers"],
                        _compute_dtype(config, nnet_input.device),
                        _store_dtype(config))
    batch, time_steps, _ = x.shape
    flat = x.reshape(batch * time_steps, dims["num_neurons"])
    y = flat @ params["head"]["w"] + params["head"]["b"]
    return y.reshape(batch, time_steps, dims["num_targets"]), None, []
