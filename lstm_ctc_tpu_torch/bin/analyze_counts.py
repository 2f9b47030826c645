"""Count symbol occurrences in int-vector tables (Kaldi analyze-counts).

Port of ``bin/analyze-counts.py``; produces the label-count vector that
``nnet_forward --class-prior`` reads:

    python -m lstm_ctc_tpu_torch.bin.analyze_counts [--counts-dim=N] \\
        [--counts-offset=0] <in-rspecifier> <counts-wxfilename>
"""

from __future__ import annotations

import sys

import numpy as np

from ..host import kaldi
from ..host import logging_util as log
from ..host.featbin import parse_kaldi_flags

SPEC = {"counts_dim": (int, 0), "counts_offset": (int, 0),
        "binary": (bool, False)}


def main(argv=None) -> None:
    opts, args = parse_kaldi_flags(sys.argv[1:] if argv is None else argv,
                                   SPEC)
    if len(args) != 2:
        log.die("usage: analyze-counts.py [opts] <rspec> <out>")
    counts = np.zeros(max(opts["counts_dim"], 1), np.int64)
    for key, vec in kaldi.SequentialTableReader(args[0], "int32vec"):
        vec = np.asarray(vec) + opts["counts_offset"]
        if vec.size and vec.max() >= len(counts):
            counts = np.concatenate(
                [counts, np.zeros(int(vec.max()) + 1 - len(counts),
                                  np.int64)])
        np.add.at(counts, vec, 1)
    with kaldi.Output(args[1], binary=False, write_header=False) as out:
        out.stream().write(("[ " + " ".join(str(int(c)) for c in counts)
                            + " ]\n").encode("utf-8"))
    log.info("counted %d symbols, %d total occurrences"
             % (len(counts), int(counts.sum())))


if __name__ == "__main__":
    main()
