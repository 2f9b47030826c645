"""Copy feature matrices between tables (Kaldi copy-feats equivalent).

Port of ``bin/copy-feats.py``:

    python -m lstm_ctc_tpu_torch.bin.copy_feats [--compress=true] \\
        <in-rspecifier> <out-wspecifier>
"""

from __future__ import annotations

import sys

from ..host import kaldi
from ..host import logging_util as log
from ..host.featbin import parse_kaldi_flags

SPEC = {"compress": (bool, False)}


def main(argv=None) -> None:
    opts, args = parse_kaldi_flags(sys.argv[1:] if argv is None else argv,
                                   SPEC)
    if len(args) != 2:
        log.die("usage: copy-feats.py [--compress=bool] <rspec> <wspec>")
    holder = "matrix_compressed" if opts["compress"] else "matrix"
    done = 0
    with kaldi.TableWriter(args[1], holder) as writer:
        for key, mat in kaldi.SequentialTableReader(args[0], "matrix"):
            writer.Write(key, mat)
            done += 1
    log.info("copied %d feature matrices" % done)


if __name__ == "__main__":
    main()
