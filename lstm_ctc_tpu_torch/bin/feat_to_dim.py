"""Print the feature dimension (Kaldi feat-to-dim equivalent).

Port of ``bin/feat-to-dim.py``:

    python -m lstm_ctc_tpu_torch.bin.feat_to_dim <in-rspecifier> [-]
"""

from __future__ import annotations

import sys

from ..host import kaldi
from ..host import logging_util as log
from ..host.featbin import parse_kaldi_flags


def main(argv=None) -> None:
    _, args = parse_kaldi_flags(sys.argv[1:] if argv is None else argv, {})
    if not args:
        log.die("usage: feat-to-dim.py <rspec> [-]")
    for _, mat in kaldi.SequentialTableReader(args[0], "matrix"):
        print(mat.shape[1])
        return
    log.die("no features read from %s" % args[0])


if __name__ == "__main__":
    main()
