"""Splice frames with left/right context (Kaldi splice-feats equivalent).

Port of ``bin/splice-feats.py``:

    python -m lstm_ctc_tpu_torch.bin.splice_feats [--left-context=4] \\
        [--right-context=4] <rspec> <wspec>
"""

from __future__ import annotations

import sys

import numpy as np

from ..host import kaldi
from ..host import logging_util as log
from ..host.data.pipeline import splice_frames
from ..host.featbin import parse_kaldi_flags

SPEC = {"left_context": (int, 4), "right_context": (int, 4)}


def main(argv=None) -> None:
    opts, args = parse_kaldi_flags(sys.argv[1:] if argv is None else argv,
                                   SPEC)
    if len(args) != 2:
        log.die("usage: splice-feats.py [opts] <rspec> <wspec>")
    done = 0
    with kaldi.TableWriter(args[1], "matrix") as writer:
        for key, mat in kaldi.SequentialTableReader(args[0], "matrix"):
            writer.Write(key, splice_frames(np.asarray(mat, np.float32),
                                            opts["left_context"],
                                            opts["right_context"]))
            done += 1
    log.info("spliced %d utterances" % done)


if __name__ == "__main__":
    main()
