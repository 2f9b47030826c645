"""lstm_ctc_tpu_torch — the PyTorch/CUDA port of lstm_ctc_tpu.

The serving path (``nnet-forward``: BLSTM + MoE head, and the
unidirectional ``lstm`` / ``cudnnlstm`` families, offline or
``--streaming``) and the training path (``nnet-init`` / ``nnet-train`` /
``nnet-validate`` and the in-process loop ``nnet-train-loop``: CTC loss,
BLSTM, LSTM-stack and MoE-head backward, adam) run through kernels
written by hand for Hopper (``csrc/``).  The host modules (config, logging, records and batching,
Kaldi I/O, decoding, features, LM, token FST) are the port's own copies,
in ``host``.  Every ``bin/`` tool of the repository has an entry point in
``bin`` (the data tools start without torch), and ``recipe_python.py`` is a
``PYTHON`` for the shipped shell recipes that runs them on the port, with
the native WFST tools built by ``_native.py``.  This package imports
torch, never jax, and nothing of ``lstm_ctc_tpu``.
"""

__version__ = "0.1.0"

# the re-exports load on first use, so that the data tools
# (``lstm_ctc_tpu_torch.bin.copy_feats`` and the like) start without torch
_EXPORTS = {"format_config": "host.config", "parse_config": "host.config",
            "apply_model": "models", "init_model": "models",
            "load_checkpoint": "train.checkpoint",
            "save_checkpoint": "train.checkpoint"}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError("module %r has no attribute %r"
                             % (__name__, name))
    import importlib
    return getattr(importlib.import_module("." + _EXPORTS[name], __name__),
                   name)
