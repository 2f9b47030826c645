"""Logging with the reference's machine-readable stderr contract.

The reference toolkit (mobvoi/lstm_ctc) logs through TF1's ``tf.logging``,
which prefixes every line with ``INFO:tensorflow:`` / ``FATAL:tensorflow:``.
The outer-loop shell scripts scrape these lines, e.g.
``grep "^INFO:tensorflow:tr_loss" | awk '{print $NF}'``
(reference scripts/train.sh:84-85, scripts/train_oplr.sh:145).

To stay drop-in compatible with those scripts we emit the *same* prefixes by
default, even though there is no TensorFlow anywhere in this framework.  The
prefix tag is configurable via the ``LSTM_CTC_TPU_LOG_TAG`` environment
variable (set it to e.g. ``lstm_ctc_tpu`` for self-branded logs).
"""

from __future__ import annotations

import os
import sys

_TAG = os.environ.get("LSTM_CTC_TPU_LOG_TAG", "tensorflow")
_QUIET = False


def quiet() -> None:
    """Drop the ``INFO:`` lines of this process from now on (the ranks of
    a process group other than 0); warnings and fatals still show."""
    global _QUIET
    _QUIET = True


def info(msg: str, *args) -> None:
    if _QUIET:
        return
    if args:
        msg = msg % args
    sys.stderr.write("INFO:%s:%s\n" % (_TAG, msg))
    sys.stderr.flush()


def warning(msg: str, *args) -> None:
    if args:
        msg = msg % args
    sys.stderr.write("WARNING:%s:%s\n" % (_TAG, msg))
    sys.stderr.flush()


def fatal(msg: str, *args) -> None:
    """Log at FATAL level.  Unlike the reference's pyKaldiIO LogError this
    does NOT exit; callers decide (the reference CLIs call sys.exit(1)
    themselves after tf.logging.fatal, bin/nnet-train.py:72-74)."""
    if args:
        msg = msg % args
    sys.stderr.write("FATAL:%s:%s\n" % (_TAG, msg))
    sys.stderr.flush()


def die(msg: str, *args) -> "None":
    """Log fatal and exit(1) — the pyKaldiIO ``LogError`` behavior
    (reference pyKaldiIO/io_funcs.py:40-58)."""
    fatal(msg, *args)
    sys.exit(1)
