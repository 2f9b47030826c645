"""Keep one frame in every n (Kaldi subsample-feats equivalent).

Port of ``bin/subsample-feats.py``:

    python -m lstm_ctc_tpu_torch.bin.subsample_feats [--n=1] <rspec> <wspec>

Like Kaldi, the output has ceil(T/n) frames (frames 0, n, 2n, ...); the
in-pipeline training subsampler keeps floor(T/n).
"""

from __future__ import annotations

import sys

import numpy as np

from ..host import kaldi
from ..host import logging_util as log
from ..host.featbin import parse_kaldi_flags

SPEC = {"n": (int, 1)}


def main(argv=None) -> None:
    opts, args = parse_kaldi_flags(sys.argv[1:] if argv is None else argv,
                                   SPEC)
    if len(args) != 2:
        log.die("usage: subsample-feats.py [--n=N] <rspec> <wspec>")
    n = opts["n"]
    done = 0
    with kaldi.TableWriter(args[1], "matrix") as writer:
        for key, mat in kaldi.SequentialTableReader(args[0], "matrix"):
            writer.Write(key, np.asarray(mat, np.float32)[::n])
            done += 1
    log.info("subsampled %d utterances" % done)


if __name__ == "__main__":
    main()
