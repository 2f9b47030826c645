"""lstm_ctc_tpu_torch — the PyTorch/CUDA port of lstm_ctc_tpu.

The serving path (``nnet-forward``: BLSTM + MoE head, and the
unidirectional ``lstm`` / ``cudnnlstm`` families, offline or
``--streaming``) and the training path (``nnet-init`` / ``nnet-train`` /
``nnet-validate`` and the in-process loop ``nnet-train-loop``: CTC loss,
BLSTM, LSTM-stack and MoE-head backward, adam) run through kernels
written by hand for Hopper (``csrc/``).  The host modules (config, logging, records and batching,
Kaldi I/O, decoding) are the port's own copies, in ``host``.  This package
imports torch, never jax, and nothing of ``lstm_ctc_tpu``.
"""

__version__ = "0.1.0"

from .host.config import format_config, parse_config
from .models import apply_model, init_model
from .train.checkpoint import load_checkpoint, save_checkpoint
