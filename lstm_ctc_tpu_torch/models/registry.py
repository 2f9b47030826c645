"""Model registry: nnet_type → (init, apply) with a uniform signature.

Counterpart of ``lstm_ctc_tpu/models/registry.py``:

    params, state = init_model(generator, config, device)
    logits, encoder, reg_losses, new_state = apply_model(
        params, state, nnet_input, sequence_length, config, train=False)

The three ``nnet_type`` values of the reference: ``blstm``, ``lstm`` and
``cudnnlstm``, for evaluation and training.  ``generator`` (a
``torch.Generator`` on the input's device) stands in for the reference's
``dropout_rng`` (or ``cells.DropoutStreams``, its two streams).
``shard`` (a ``parallel.Shard``) says how the batch lies over a process
group: batch-norm statistics of a split batch are global.  ``state``
carries the batch-norm running moments of an ``lstm`` with ``use_bn``; it
is empty for the other models.  Packed rows
(``reset_mask``) are refused for the unidirectional families, as the
reference refuses them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import blstm as _blstm
from . import lstm as _lstm


def _init_blstm(generator, config, device):
    return _blstm.init_blstm(generator, config, device), {}


def _apply_blstm(params, state, nnet_input, sequence_length, config,
                 reset_mask=None, train=False, generator=None, shard=None):
    logits, encoder, reg = _blstm.apply_blstm(
        params, nnet_input, sequence_length, config, reset_mask=reset_mask,
        train=train, generator=generator)
    return logits, encoder, reg, state


def _refuse_packed(reset_mask):
    if reset_mask is not None:
        raise NotImplementedError(
            "pack_factor (packed rows) is only supported for nnet_type "
            "blstm")


def _init_lstm(generator, config, device):
    return _lstm.init_lstm(generator, config, device)


def _apply_lstm(params, state, nnet_input, sequence_length, config,
                reset_mask=None, train=False, generator=None, shard=None):
    _refuse_packed(reset_mask)
    return _lstm.apply_lstm(params, state, nnet_input, sequence_length,
                            config, train=train, generator=generator,
                            shard=shard)


def _init_cudnnlstm(generator, config, device):
    return _lstm.init_cudnnlstm(generator, config, device), {}


def _apply_cudnnlstm(params, state, nnet_input, sequence_length, config,
                     reset_mask=None, train=False, generator=None,
                     shard=None):
    _refuse_packed(reset_mask)
    logits, encoder, reg = _lstm.apply_cudnnlstm(
        params, nnet_input, sequence_length, config, train=train,
        generator=generator)
    return logits, encoder, reg, state


_REGISTRY = {
    "blstm": (_init_blstm, _apply_blstm),
    "lstm": (_init_lstm, _apply_lstm),
    "cudnnlstm": (_init_cudnnlstm, _apply_cudnnlstm),
}


def get_model(nnet_type: str):
    if nnet_type not in _REGISTRY:
        raise ValueError("unsupported nnet_type: %s (choose from %s)"
                         % (nnet_type, sorted(_REGISTRY)))
    return _REGISTRY[nnet_type]


def init_model(generator: torch.Generator, config: Dict,
               device="cpu") -> Tuple[Dict, Dict]:
    init_fn, _ = get_model(config["nnet_type"])
    return init_fn(generator, config, device)


def apply_model(params, state, nnet_input, sequence_length, config,
                train=False, generator=None, reset_mask=None, shard=None):
    _, apply_fn = get_model(config["nnet_type"])
    return apply_fn(params, state, nnet_input, sequence_length, config,
                    reset_mask=reset_mask, train=train, generator=generator,
                    shard=shard)
