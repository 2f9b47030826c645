"""Select/permute feature columns (Kaldi select-feats equivalent).

Port of ``bin/select-feats.py``:

    python -m lstm_ctc_tpu_torch.bin.select_feats <ranges> <rspec> <wspec>

e.g. the blank rotation before the lattice decode
(``scripts/decode_ctc_lat.sh``): ``select_feats 71,0-70 ark:- ark:-``.
"""

from __future__ import annotations

import sys

import numpy as np

from ..host import kaldi
from ..host import logging_util as log
from ..host.featbin import parse_column_ranges, parse_kaldi_flags


def main(argv=None) -> None:
    _, args = parse_kaldi_flags(sys.argv[1:] if argv is None else argv, {})
    if len(args) != 3:
        log.die("usage: select-feats.py <ranges> <rspec> <wspec>")
    indices = parse_column_ranges(args[0])
    done = 0
    with kaldi.TableWriter(args[2], "matrix") as writer:
        for key, mat in kaldi.SequentialTableReader(args[1], "matrix"):
            writer.Write(key, np.ascontiguousarray(
                np.asarray(mat, np.float32)[:, indices]))
            done += 1
    log.info("selected columns for %d utterances" % done)


if __name__ == "__main__":
    main()
