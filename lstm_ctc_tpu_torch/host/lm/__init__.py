"""N-gram LM estimation: the port's copy of ``lstm_ctc_tpu/lm``."""

from .ngram import NgramLm, train_ngram_lm, write_arpa, perplexity

__all__ = ["NgramLm", "train_ngram_lm", "write_arpa", "perplexity"]
