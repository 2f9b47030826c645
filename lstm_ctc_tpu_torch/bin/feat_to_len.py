"""Print per-utterance frame counts (Kaldi feat-to-len equivalent).

Port of ``bin/feat-to-len.py``:

    python -m lstm_ctc_tpu_torch.bin.feat_to_len <in-rspecifier> \\
        [<out-wxfilename>]
"""

from __future__ import annotations

import sys

from ..host import kaldi
from ..host import logging_util as log
from ..host.featbin import parse_kaldi_flags


def main(argv=None) -> None:
    _, args = parse_kaldi_flags(sys.argv[1:] if argv is None else argv, {})
    if len(args) not in (1, 2):
        log.die("usage: feat-to-len.py <rspec> [<out>]")
    out = open(args[1], "w") if len(args) == 2 and args[1] != "-" \
        else sys.stdout
    try:
        for key, mat in kaldi.SequentialTableReader(args[0], "matrix"):
            out.write("%s %d\n" % (key, mat.shape[0]))
    finally:
        if out is not sys.stdout:
            out.close()


if __name__ == "__main__":
    main()
