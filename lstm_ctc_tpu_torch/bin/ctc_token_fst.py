"""Emit the CTC token FST (T) in text format from a tokens.txt table.

Port of ``bin/ctc-token-fst.py``:

    python -m lstm_ctc_tpu_torch.bin.ctc_token_fst <tokens.txt> > T.fst.txt
"""

from __future__ import annotations

import sys

from ..host.wfst import ctc_token_fst_text


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else list(argv)
    if len(args) != 1:
        sys.stderr.write("usage: ctc-token-fst.py <tokens.txt>\n")
        sys.exit(1)
    with open(args[0]) as fh:
        sys.stdout.write(ctc_token_fst_text(fh))


if __name__ == "__main__":
    main()
