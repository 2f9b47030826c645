"""WFST helpers: the port's copy of ``lstm_ctc_tpu/wfst``."""

from .ctc_token_fst import ctc_token_fst_text
