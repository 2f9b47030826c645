"""Append delta (and delta-delta) features (Kaldi add-deltas equivalent).

Port of ``bin/add-deltas.py``:

    python -m lstm_ctc_tpu_torch.bin.add_deltas [--delta-order=2] \\
        [--delta-window=2] <rspec> <wspec>
"""

from __future__ import annotations

import sys

import numpy as np

from ..host import kaldi
from ..host import logging_util as log
from ..host.data.features import add_deltas
from ..host.featbin import parse_kaldi_flags

SPEC = {"delta_order": (int, 2), "delta_window": (int, 2)}


def main(argv=None) -> None:
    opts, args = parse_kaldi_flags(sys.argv[1:] if argv is None else argv,
                                   SPEC)
    if len(args) != 2:
        log.die("usage: add-deltas.py [opts] <rspec> <wspec>")
    done = 0
    with kaldi.TableWriter(args[1], "matrix") as writer:
        for key, mat in kaldi.SequentialTableReader(args[0], "matrix"):
            writer.Write(key, add_deltas(np.asarray(mat, np.float32),
                                         opts["delta_order"],
                                         opts["delta_window"]))
            done += 1
    log.info("added deltas to %d utterances" % done)


if __name__ == "__main__":
    main()
