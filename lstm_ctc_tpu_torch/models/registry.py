"""Model registry: nnet_type → (init, apply) with a uniform signature.

Counterpart of ``lstm_ctc_tpu/models/registry.py``:

    params, state = init_model(generator, config, device)
    logits, encoder, reg_losses, new_state = apply_model(
        params, state, nnet_input, sequence_length, config, train=False)

Only ``blstm`` is ported, with either head (dense or MoE), for evaluation
and training.  ``generator`` (a ``torch.Generator`` on the input's device)
stands in for the reference's ``dropout_rng``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import blstm as _blstm


def _init_blstm(generator, config, device):
    return _blstm.init_blstm(generator, config, device), {}


def _apply_blstm(params, state, nnet_input, sequence_length, config,
                 reset_mask=None, train=False, generator=None):
    logits, encoder, reg = _blstm.apply_blstm(
        params, nnet_input, sequence_length, config, reset_mask=reset_mask,
        train=train, generator=generator)
    return logits, encoder, reg, state


def _not_ported(nnet_type):
    def fail(*args, **kwargs):
        raise NotImplementedError(
            "nnet_type %s is not ported to PyTorch yet (ROADMAP queue 1, "
            "item 12: unidirectional families)" % nnet_type)
    return fail, fail


_REGISTRY = {
    "blstm": (_init_blstm, _apply_blstm),
    "lstm": _not_ported("lstm"),
    "cudnnlstm": _not_ported("cudnnlstm"),
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
                train=False, generator=None, reset_mask=None):
    _, apply_fn = get_model(config["nnet_type"])
    return apply_fn(params, state, nnet_input, sequence_length, config,
                    reset_mask=reset_mask, train=train, generator=generator)
