"""lstm_ctc_tpu_torch — the PyTorch/CUDA port of lstm_ctc_tpu.

The serving path (``nnet-forward``: BLSTM + MoE head) runs through two
kernels written by hand for Hopper (``csrc/``).  Host modules that need no
JAX are shared with the reference package through ``host`` (see its
docstring).  This package imports torch and never jax.
"""

__version__ = "0.1.0"

from .host.config import format_config, parse_config
from .models import apply_model, init_model
from .train.checkpoint import load_checkpoint, save_checkpoint
