"""Copy int32-vector tables (Kaldi copy-int-vector equivalent).

Port of ``bin/copy-int-vector.py``:

    python -m lstm_ctc_tpu_torch.bin.copy_int_vector <in-rspecifier> \\
        <out-wspecifier>
"""

from __future__ import annotations

import sys

from ..host import kaldi
from ..host import logging_util as log
from ..host.featbin import parse_kaldi_flags


def main(argv=None) -> None:
    _, args = parse_kaldi_flags(sys.argv[1:] if argv is None else argv,
                                {"binary": (bool, True)})
    if len(args) != 2:
        log.die("usage: copy-int-vector.py <rspec> <wspec>")
    done = 0
    with kaldi.TableWriter(args[1], "int32vec") as writer:
        for key, vec in kaldi.SequentialTableReader(args[0], "int32vec"):
            writer.Write(key, vec)
            done += 1
    log.info("copied %d vectors" % done)


if __name__ == "__main__":
    main()
